"""CreamFL (reference ``src/server/creamflserver.py`` +
``src/client/creamflclient.py``; port of
``fedcola_tpu/federation/creamfl.py``): cross-modal representation-level
federated learning over a public COCO subset.

A round (creamflserver.py:338-435):

1. ``pub_logit``: the img+txt global model embeds the public set into
   ``g_img`` / ``g_txt`` (``_generate_public_logit``);
2. ``train``: every group's task epochs, each followed by a public-set
   contrastive pass (creamflclient.py:131-237) that shares the group's
   optimizer state: uni-modal clients minimise an inter-modal CE against
   the other modality's global features plus a MOON-style term against
   the round-start model, img+txt clients intra + inter (skipped under
   ``--no_mm_contrastive``); temperature 0.5, gradient clip 2.  Uni-modal
   clients then extract their public features (creamflclient.py:38-68);
3. ``aggregate``: client features with contrastive weighting
   (creamflserver.py:355-404); the img+txt model by CreamFL's zero-init
   weighted sum (creamflserver.py:251-292), the uni-modal models by plain
   fedavg;
4. ``distill``: the img+txt model on the public set, a fresh AdamW every
   round (``--p_lr``, weight decay 0.01, clip 2), MSE of the token-summed
   sequence features against the aggregated client features times
   ``--kd_weight`` (creamflserver.py:293-336).

The public set is cut into padded batches of ``--pub_batch_size`` and
staged on the device once, under the resident plane's one budget
(``FEDCOLA_RESIDENT_BUDGET``; 500 images of 224x224x3 uint8 are 75 MB);
a set over what is left of it is copied to the device batch by batch on
every pass instead, with one log line.  The task data takes the FedAvg
path's plane (``_group_aug_plan``).  Every public pass is client-stacked
like a task step, so each kernel launch covers the group.

Under a mesh (``parallel/mesh.py``) the public steps and the feature
extraction take the group update's layout: a rank runs its block of the
group's clients, its rows of each public batch on a ``data`` axis (the
features gathered with their gradient before the loss, the gradients
summed over the data ranks) and its shards on a ``model`` axis, with its
block of the whole group's draws; padding clients never step.  The
extracted features are all-gathered, so every rank holds every client's.
The public logits (step 1), the aggregation and the distillation run
replicated on every rank from replicated inputs, as the JAX package's
unsharded public batches do, and the round ends by checking that the
ranks' global models are the same bits.  The JAX ``_padded_group_members``
has no counterpart: ``MeshPlan.gather_clients`` drops the padding clients
before anything aggregates.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from fedcola_tpu_torch.config import DATASET_2_MODALITY, DATASET_2_TASK
from fedcola_tpu_torch.data.datasets import fetch_coco_public, fetch_synthetic
from fedcola_tpu_torch.federation import aggregate as agg
from fedcola_tpu_torch.federation.server import FedAvgServer, GroupRun
from fedcola_tpu_torch.models.mat import (DTYPES, mat_apply_stacked,
                                          tree_map)
from fedcola_tpu_torch.ops.losses import cross_entropy
from fedcola_tpu_torch.parallel.client_update import (build_frozen_mask,
                                                      descend,
                                                      preprocess_images)
from fedcola_tpu_torch.parallel.optim import OptimizerSpec, init_opt_state
from fedcola_tpu_torch.utils.dispatch import pad_batch_indices
from fedcola_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

PUB_TEMPERATURE = 0.5   # hardcoded in the reference (creamflclient.py:166+)
PUB_CLIP = 2.0          # creamflclient.py:238, creamflserver.py:330


def _unsqueeze(params):
    return tree_map(lambda a: a.unsqueeze(0), params)


class CreamflServer(FedAvgServer):
    def __init__(self, cfg, data, writer=None, plan=None):
        super().__init__(cfg, data, writer, plan)
        try:
            self.mm_dataset = next(ds for ds in cfg.client_datasets
                                   if DATASET_2_MODALITY[ds] == "img+txt")
        except StopIteration:
            raise ValueError(
                "--algorithm creamfl requires an img+txt client dataset "
                "(the public set and the distillation train the multimodal "
                f"global model); got --datasets {list(cfg.client_datasets)}"
            ) from None
        self._pub_host = self._pub_batch_list()
        self._pub_batches_dev = None
        self._pub_pinned_bytes = 0
        self._pub_host_logged = False
        self.g_img = self.g_txt = None
        self._pub_feats: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------ pub data --

    def _pub_batch_list(self) -> List[Dict]:
        """The public set as padded host batches: ``img`` uint8 ``[B, H, W,
        C]``, ``txt`` ``[B, L]``, ``didx`` (row in the set), ``valid`` and
        ``n_valid``."""
        cfg = self.cfg
        try:
            if cfg.synthetic_data:
                raise FileNotFoundError("--synthetic_data")
            ds = fetch_coco_public(
                cfg.pub_data_dir, cfg.pub_anno_path,
                self.data.tokenizers.get(self.mm_dataset), cfg.seq_len,
                cfg.num_pub_samples, image_size=cfg.resize or 224)
            ds.materialize_images()
        except (FileNotFoundError, OSError, KeyError) as e:
            if not cfg.synthetic_data:
                # the main loader's banner: a mistyped --pub_anno_path must
                # not train every public phase on noise unnoticed
                logger.warning(
                    "=== SYNTHETIC DATA === CreamFL public set: could not "
                    "load real COCO public data (%s: %s); falling back to "
                    "a synthetic public set — results are NOT meaningful "
                    "for real runs (check --pub_data_dir/--pub_anno_path)",
                    type(e).__name__, e)
            mm_cfg = self.model_cfgs[self.mm_dataset]
            n = cfg.num_pub_samples - cfg.num_pub_samples % 5
            ds = fetch_synthetic("Coco", "img+txt", "rtv", max(n, 5), None,
                                 img_hw=mm_cfg.img_size, seq_len=cfg.seq_len,
                                 vocab_size=mm_cfg.vocab_size, seed=999)
        img = ds.load_images(np.arange(ds.n))
        txt = np.asarray(ds.texts)
        B = cfg.pub_batch_size
        batches = []
        for s in range(0, ds.n, B):
            e = min(s + B, ds.n)
            sel = pad_batch_indices(np.arange(s, e), B)
            valid = np.zeros(B, bool)
            valid[:e - s] = True
            batches.append({"img": img[sel], "txt": txt[sel], "didx": sel,
                            "valid": valid, "n_valid": e - s})
        logger.info("[CREAMFL] public set: %d samples in %d batches",
                    ds.n, len(batches))
        return batches

    def _pub_batches(self) -> Iterator[Dict]:
        """The public batches on the device.  Staged once and reused while
        they fit what is left of the resident budget (the set is the same
        every pass); otherwise copied batch by batch on every pass, so a
        large ``--num_pub_samples`` does not pin device memory for the
        whole run.  ``finalize`` releases the staging."""
        if self._pub_batches_dev is not None:
            yield from self._pub_batches_dev
            return
        to_dev = lambda b: {  # noqa: E731
            k: torch.from_numpy(v).to(self.device)
            if isinstance(v, np.ndarray) else v for k, v in b.items()}
        total = sum(b["img"].nbytes + b["txt"].nbytes for b in self._pub_host)
        if total <= self.resident_budget_left():
            self._pub_batches_dev = [to_dev(b) for b in self._pub_host]
            self._resident_bytes += total
            self._pub_pinned_bytes = total
            logger.info("[CREAMFL] public set staged on the device (%.1f "
                        "MB)", total / 1e6)
            yield from self._pub_batches_dev
            return
        if not self._pub_host_logged:
            self._pub_host_logged = True
            logger.info("[CREAMFL] public set stays host-fed per pass "
                        "(%.2f GB > %.2f GB remaining of the resident "
                        "budget)", total / 1e9,
                        self.resident_budget_left() / 1e9)
        for b in self._pub_host:
            yield to_dev(b)

    def _pub_inputs(self, ds: str, batch, modality: str, n: int,
                    rank_rows: bool = False):
        """Slot-aligned MAT inputs of a public batch for ``n`` stacked
        models of dataset ``ds`` (the batch is the same for each); with
        ``rank_rows``, this mesh rank's rows of it."""
        mcfg = self.model_cfgs[ds]
        spec = self._group_spec(ds)
        cut = self.plan.batch_block if rank_rows else (lambda t: t)
        ins = [None] * len(mcfg.modalities)
        if "img" in modality:
            x = preprocess_images(cut(batch["img"]), spec,
                                  DTYPES[mcfg.compute_dtype])
            ins[spec.img_slot] = x.unsqueeze(0).expand((n,) + x.shape)
        if "txt" in modality:
            t = cut(batch["txt"])
            ins[spec.txt_slot] = t.unsqueeze(0).expand((n,) + t.shape)
        return ins

    def _rank_forward(self, g: GroupRun, batch, train: bool):
        """The slot-aligned features ``[n_rank, B, D]`` of this rank's
        block of the group's clients on a public batch: on a ``data`` axis
        the rank runs its rows and the features are gathered over the data
        ranks (with their gradient), on a ``model`` axis its shards; a
        training forward takes its block of the whole group's draws."""
        n, B = len(g.ids), batch["valid"].shape[0]
        rows = self.plan.client_rows(n)
        outs = mat_apply_stacked(
            g.mcfg, g.stacked,
            self._pub_inputs(g.ds, batch, g.spec.modality,
                             rows.stop - rows.start, rank_rows=True),
            feat_out=True, train=train,
            gen=self.plan.draws(self.gen, n, B) if train else None, tp=g.tp)
        if self.plan.splits_batch(B):
            outs = [None if o is None else self.plan.gather_batch(o)
                    for o in outs]
        return outs

    # ------------------------------------------------- global pub features --

    @torch.no_grad()
    def _generate_public_logit(self):
        """creamflserver.py:128-162: the img+txt global model embeds the
        public set."""
        ds = self.mm_dataset
        spec = self._group_spec(ds)
        params = _unsqueeze(self.global_params[ds])
        gi, gt = [], []
        for b in self._pub_batches():
            outs = mat_apply_stacked(
                self.model_cfgs[ds], params,
                self._pub_inputs(ds, b, "img+txt", 1), feat_out=True)
            gi.append(outs[spec.img_slot][0, :b["n_valid"]])
            gt.append(outs[spec.txt_slot][0, :b["n_valid"]])
        self.g_img = torch.cat(gi)
        self.g_txt = torch.cat(gt)

    # --------------------------------------------------- client pub phases --

    def _pub_loss(self, g: GroupRun, batch) -> torch.Tensor:
        """Per-client public contrastive loss ``[n_rank]`` of one batch
        (creamflclient.py:131-237) for this rank's block of the group's
        clients, over the whole batch."""
        mcfg, spec = g.mcfg, g.spec
        t, w = PUB_TEMPERATURE, self.cfg.interintra_weight
        rows = self.plan.client_rows(len(g.ids))
        n = rows.stop - rows.start
        outs = self._rank_forward(g, batch, train=True)
        with torch.no_grad():
            # the round-start model, the same for every client: once, n=1
            old = mat_apply_stacked(
                mcfg, _unsqueeze(self.global_params[g.ds]),
                self._pub_inputs(g.ds, batch, spec.modality, 1),
                feat_out=True)
        didx = batch["didx"].expand(n, -1)
        valid = batch["valid"].expand(n, -1)
        zeros = torch.zeros_like(didx)
        if spec.modality == "img+txt":
            fi, ft = outs[spec.img_slot], outs[spec.txt_slot]
            oi, ot = old[spec.img_slot], old[spec.txt_slot]
            ti, tt = self.g_img[batch["didx"]], self.g_txt[batch["didx"]]
            dot = lambda a, b: (a * b).sum(-1, keepdim=True)  # noqa: E731
            logits = torch.cat([torch.cat([dot(fi, ti), dot(fi, oi)], -1),
                                torch.cat([dot(ft, tt), dot(ft, ot)], -1)],
                               -2) / t
            loss_intra = cross_entropy(logits, torch.cat([zeros, zeros], -1),
                                       torch.cat([valid, valid], -1))
            loss_inter = cross_entropy(fi @ self.g_txt.T / t, didx, valid) \
                + cross_entropy(ft @ self.g_img.T / t, didx, valid)
            return (loss_intra + loss_inter) * w
        if spec.modality == "img":
            f, f_old = outs[spec.img_slot], old[spec.img_slot]
            target, other = self.g_img[batch["didx"]], self.g_txt
        else:
            f, f_old = outs[spec.txt_slot], old[spec.txt_slot]
            target, other = self.g_txt[batch["didx"]], self.g_img
        loss_inter = cross_entropy(f @ other.T / t, didx, valid)
        pos = (f * target).sum(-1, keepdim=True)
        neg = (f * f_old).sum(-1, keepdim=True)
        loss_moon = cross_entropy(torch.cat([pos, neg], -1) / t, zeros, valid)
        return (loss_moon + loss_inter) * w

    def _public_epoch(self, g: GroupRun) -> None:
        """One pass over the public set, a step per batch, on the group's
        own optimizer state with the gradient clipped at 2."""
        pub_opt = dataclasses.replace(self.opt_spec, max_grad_norm=PUB_CLIP)
        # the public loss does not reach the cls heads: torch skips a
        # parameter whose grad is None (no move, no moment decay), so they
        # are frozen here, beside the task program's frozen leaves
        heads = {("head", str(i), leaf)
                 for i, task in enumerate(g.mcfg.tasks) if task == "cls"
                 for leaf in ("kernel", "bias")}
        token = tuple(sorted(set(self._frozen_token(g.ds) or ()) | heads))
        frozen = build_frozen_mask(g.mcfg, g.stacked, token or None)
        # the padding clients of this rank's block never step
        rows = self.plan.client_rows(len(g.ids))
        real = torch.arange(rows.start, rows.stop,
                            device=self.device) < len(g.ids)
        data_plan = self.plan if self.plan.splits_batch(
            self.cfg.pub_batch_size) else None
        for b in self._pub_batches():
            descend(pub_opt, g.stacked, g.opt_state, self._pub_loss(g, b),
                    self.curr_lr, frozen, real, data_plan, g.tp)

    @torch.no_grad()
    def _extract_pub_features(self, g: GroupRun) -> None:
        """Public features of a uni-modal group's trained clients
        (creamflserver.py:179-180): this rank's block, then every client's
        on every rank (the JAX ``to_host`` of the clients-sharded
        features)."""
        slot = g.spec.img_slot if g.spec.modality == "img" \
            else g.spec.txt_slot
        fs = [self._rank_forward(g, b, train=False)[slot][:, :b["n_valid"]]
              for b in self._pub_batches()]
        feats = self.plan.gather_clients(torch.cat(fs, 1), len(g.ids))
        for j, cid in enumerate(g.ids):
            self._pub_feats[cid] = feats[j]

    def _train_group(self, ds: str, ids: List[int]):
        """Task epochs, each followed by a public pass; then the public
        features of uni-modal clients (creamflclient.py:86-237)."""
        g = self._open_group(ds, ids)
        do_pub = self.cfg.interintra_weight > 0 and not (
            self.cfg.no_mm_contrastive and g.spec.modality == "img+txt")
        for _ in range(self.cfg.E):
            # the public pass follows every epoch, so epochs stream one at
            # a time
            self._train_chunks(g, g.feeder.round_index_chunks(1)
                               if g.data is not None
                               else g.feeder.epoch_chunks())
            if do_pub:
                self._public_epoch(g)
        if g.spec.modality != "img+txt":
            self._extract_pub_features(g)
        return self._close_group(g)

    # ------------------------------------------------ feature aggregation ---

    @staticmethod
    def _contrastive_weighted(vecs: torch.Tensor,
                              g_other: torch.Tensor) -> torch.Tensor:
        """Per public sample, a softmax over clients of the diagonal
        log-probabilities against the other modality's global features
        (creamflserver.py:369-397).  ``vecs [n_clients, N_pub, D]``."""
        logits = torch.einsum("cnd,md->cnm", vecs, g_other)
        diag = torch.diagonal(logits, dim1=1, dim2=2) \
            - torch.logsumexp(logits, dim=2)
        wts = torch.softmax(diag, dim=0)
        return (vecs * wts[..., None]).sum(0)

    # -------------------------------------------------------- distillation --

    def _distill(self, img_vec: torch.Tensor, txt_vec: torch.Tensor):
        """Server KD on the public set (creamflserver.py:293-336).  The
        distilled representation is the reference's ``code_sim`` input:
        the rtv head's per-token normalised sequence, summed over tokens."""
        cfg = self.cfg
        ds = self.mm_dataset
        mcfg = self.model_cfgs[ds]
        spec = self._group_spec(ds)
        # a fresh torch.optim.AdamW every round: its default weight decay
        # 0.01 applies (creamflserver.py:303)
        opt = OptimizerSpec(name="AdamW", max_grad_norm=PUB_CLIP,
                            weight_decay=0.01)
        params = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                          _unsqueeze(self.global_params[ds]))
        state = init_opt_state(opt, params, 1)
        # frozen aux weights must not decay either
        frozen = build_frozen_mask(mcfg, params)
        for b in self._pub_batches():
            outs = mat_apply_stacked(mcfg, params,
                                     self._pub_inputs(ds, b, "img+txt", 1),
                                     train=True, gen=self.gen,
                                     seq_feat_out=True)
            v = b["valid"].float()[:, None]
            nv = torch.clamp(b["valid"].sum(), min=1)
            loss = 0.0
            for slot, target in ((spec.img_slot, img_vec),
                                 (spec.txt_slot, txt_vec)):
                diff = outs[slot].sum(2) - target[b["didx"]]
                loss = loss + (diff.square() * v).sum((-2, -1)) \
                    / (nv * target.shape[-1])
            descend(opt, params, state, cfg.kd_weight * loss, cfg.p_lr,
                    frozen)
        self.global_params[ds] = tree_map(lambda a: a.detach()[0], params)

    # --------------------------------------------------------------- round --

    def _update(self):
        cfg = self.cfg
        t0 = time.time()
        with span("pub_logit"):
            self._generate_public_logit()
        self._pub_feats = {}
        sampled, groups, updated_sizes, uploads = self._sample_and_train()
        if not sampled:
            return []

        client_cfgs = {ds: self.model_cfgs[ds] for ds in groups}
        exp_modalities = cfg.modalities or [DATASET_2_MODALITY[d]
                                            for d in cfg.client_datasets]
        with span("aggregate"):
            vec = {}
            for mod, other in (("img", self.g_txt), ("txt", self.g_img)):
                ids = [i for i in sampled if self.clients[i].modality == mod]
                if ids:
                    vec[mod] = self._contrastive_weighted(
                        torch.stack([self._pub_feats[i] for i in ids]),
                        other)
            for ds in self.global_params:
                is_mm = DATASET_2_MODALITY[ds] == "img+txt"
                jobs, weights = agg.plan_aggregation(
                    ds, self.model_cfgs[ds], client_cfgs, self.clients,
                    sampled, updated_sizes, self.param_scope,
                    exp_modalities, dict(groups),
                    compensation=cfg.compensation and is_mm,
                    share_scope=cfg.share_scope, fedavg=not is_mm,
                    creamfl=is_mm, zero_init=is_mm,
                    model_modality=DATASET_2_MODALITY[ds],
                    model_task=DATASET_2_TASK[ds])
                self.global_params[ds] = agg.apply_aggregation(
                    jobs, weights, self.global_params[ds], uploads)

        if "img" in vec and "txt" in vec:
            with span("distill"):
                self._distill(vec["img"], vec["txt"])
        else:
            logger.warning("[CREAMFL] skipping distillation: no %s client "
                           "features", "img" if "img" not in vec else "txt")
        self.plan.check_replicated(self.global_params)
        self._assert_global_finite()

        if self.round % cfg.lr_decay_step == 0:
            self.curr_lr *= cfg.lr_decay
        self._record_round_time(t0, len(sampled), len(groups))
        return sampled

    def finalize(self):
        # the staged public set and its features are training-only state
        self._pub_batches_dev = None
        self._resident_bytes -= self._pub_pinned_bytes
        self._pub_pinned_bytes = 0
        self.g_img = self.g_txt = None
        self._pub_feats = {}
        super().finalize()
