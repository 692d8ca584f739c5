"""FedAvg server / round orchestrator (reference ``FedavgServer``,
src/server/fedavgserver.py:117-898); port of
``fedcola_tpu/federation/server.py`` on one device.

Per round (compare ``update()``, fedavgserver.py:784-856):

1. sample clients (equal_sampled / warmup filtering);
2. batched local updates: the sampled clients of each dataset train as one
   client-stacked group (``parallel/client_update.py``), on the resident
   data plane: each dataset is staged on the device once, within one
   budget for every consumer (``FEDCOLA_RESIDENT_BUDGET``, 6 GiB by
   default), and every step gathers its batch there from index maps.  A
   dataset over the budget, or a group with ``--randrot`` / ``--randjit``
   (host-side transforms), is fed from the host instead, with a
   ``[DATA]`` log line;
3. aux fold-in for uni-modal with_aux groups (fedavgclient.py:158-184);
4. per-dataset aggregation: host-planned coefficients, one weighted
   reduction on the device (``federation/aggregate.py``);
5. FedCola aux exchange (fedavgserver.py:821-845);
6. lr decay (``curr_lr *= lr_decay`` every ``lr_decay_step`` rounds).

``fedavg``, ``fedsgd``, ``fedprox`` (the proximal term in the client loss)
and ``fediot`` (a sharing rule on this machinery) run here, with
``--fedavg_eval``, ``.npz`` checkpoints, per-client local evaluation
(``--eval_type local|both``) and the reference-format ``.pt`` export of
``finalize``; ``create_server`` also builds the FedOpt family
(``federation/fedopt.py``) and CreamFL (``federation/creamfl.py``).

Under a mesh (``parallel/mesh.py``, one process per device) every rank runs
this same program: a rank trains its block of each group's clients (rows
of each batch on a ``data`` axis, its shard of the ruled leaves on a
``model`` axis), the uploads are all-gathered before the aggregation,
which every rank runs on the same stack, and evaluation splits its
batches over the ranks.  The global models stay whole and replicated on
every rank; the ``model`` axis cuts them when a group update starts and
puts them back at its upload.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from fedcola_tpu_torch.config import (DATASET_2_MODALITY, DATASET_2_TASK,
                                      ExperimentConfig, TASK_2_CRITERION)
from fedcola_tpu_torch.data.loaders import FederatedData
from fedcola_tpu_torch.data.pipeline import AugmentSpec, GroupFeeder, Prefetcher
from fedcola_tpu_torch.data.sampling import sample_clients
from fedcola_tpu_torch.eval import retrieval
from fedcola_tpu_torch.federation import aggregate as agg
from fedcola_tpu_torch.federation.aux import (exchange_aux_weights,
                                              fold_aux_into_upload)
from fedcola_tpu_torch.models import moe, naming
from fedcola_tpu_torch.models.mat import (MATConfig, check_kernel_support,
                                          stack_clients, tree_leaves,
                                          tree_map)
from fedcola_tpu_torch.models.registry import create_model
from fedcola_tpu_torch.models.torch_io import to_torch_state_dict
from fedcola_tpu_torch.ops.losses import clip_contrastive, cross_entropy
from fedcola_tpu_torch.parallel.mesh import MeshPlan, TensorParallel
from fedcola_tpu_torch.parallel.client_update import (GroupSpec,
                                                      build_frozen_mask,
                                                      eval_batch,
                                                      eval_forward,
                                                      local_eval, run_chunk)
from fedcola_tpu_torch.parallel.optim import init_opt_state, make_optimizer_spec
from fedcola_tpu_torch.utils.dispatch import DispatchWindow, pad_batch_indices
from fedcola_tpu_torch.utils.metrics import MetricManager
from fedcola_tpu_torch.utils.profiling import Timer, count, readback, span

logger = logging.getLogger(__name__)


@dataclass
class GroupRun:
    """One client group's local-update state within a round."""
    ds: str
    ids: List[int]          # the whole group; this rank trains its block
    mcfg: MATConfig
    spec: GroupSpec
    stacked: dict
    opt_state: dict
    frozen: Optional[dict]
    feeder: GroupFeeder
    acc: Dict[str, torch.Tensor]
    data: Optional[Dict[str, torch.Tensor]]   # staged arrays, or host-fed
    # the mesh's model axis (None without it) and the round's global model
    # as the group's FedProx term reads it (the rank's cut under the axis)
    tp: Optional[TensorParallel] = None
    global_params: Optional[dict] = None


def resolve_device(cfg: ExperimentConfig) -> torch.device:
    """The run's device: the card unless the caller asks for the CPU."""
    if cfg.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is available (pass --device "
                "cpu to run the plain PyTorch versions of the kernels)")
        return torch.device("cuda")
    if cfg.device == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {cfg.device!r}")


class FedAvgServer:
    def __init__(self, cfg: ExperimentConfig, data: FederatedData,
                 writer=None, plan: Optional[MeshPlan] = None):
        """``plan``: this rank's joined mesh (``parallel.mesh.Launch.join``);
        a configuration that asks for one starts through
        ``fedcola_tpu_torch.main``, which starts a process per device."""
        if plan is None and (
                (cfg.mesh_shape and int(np.prod(cfg.mesh_shape)) > 1)
                or cfg.dist_coordinator is not None):
            raise ValueError(
                "--mesh_shape / --dist_* run one process per mesh device: "
                "start the run through fedcola_tpu_torch.main")
        self.plan = plan or MeshPlan()
        self.cfg = cfg
        self.data = data
        self.writer = writer
        self.device = resolve_device(cfg)
        self.round = 0
        self.curr_lr = cfg.lr
        self.results: Dict = defaultdict(dict)
        self.opt_spec = make_optimizer_spec(cfg)
        self.sampler = int(cfg.seed)
        self.shuffle_rng = np.random.RandomState(cfg.seed + 1)
        # device randomness (DropPath draws); the JAX package's key stream
        # cannot be replayed, so this is its own stream from the same seed
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # the resident data plane: staged arrays by cache key (None: the
        # dataset stays host-fed) and the bytes all stagings pin
        self._resident_cache: Dict[str, Optional[Dict]] = {}
        self._resident_bytes = 0
        self._aug_host_logged: set = set()
        self._train_dataset_cache: Dict[str, object] = {}
        # per-rank figures of a mesh run, written into the results JSON
        self.mesh_stats: Optional[Dict] = None
        # the spans and counters of the round being run (``_round_timer``)
        self._timer: Optional[Timer] = None
        self._timer_round: Optional[int] = None

        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model_cfgs = {}
        self.global_params = {}
        # each model's share of the ``model`` axis (None without it)
        self.model_tps: Dict[str, Optional[TensorParallel]] = {}
        for ds in cfg.client_datasets:
            mcfg, params = create_model(cfg.model_name, cfg, ds, init_gen)
            if self.device.type == "cuda":
                check_kernel_support(mcfg)
            tp = self.model_tps[ds] = self.plan.tensor_parallel(mcfg)
            if tp is not None:
                logger.info("[MESH] model axis %d, %s: %s", tp.size, ds,
                            tp.describe(mcfg))
            self.model_cfgs[ds] = mcfg
            self.global_params[ds] = tree_map(lambda a: a.to(self.device),
                                              params)

        union: List[str] = []
        for mcfg in self.model_cfgs.values():
            for _, n in naming.param_names(mcfg):
                if n not in union:
                    union.append(n)
        self.param_scope = naming.build_param_scope(
            union, cfg.shared_param, cfg.share_scope)
        self.Cs = {ds: c for ds, c in zip(cfg.client_datasets, cfg.Cs)}
        self.clients = data.client_meta
        self.client_dataset_of = [data.client_meta[i].dataset
                                  for i in range(data.K)]
        self.client_modality_of = [data.client_meta[i].modality
                                   for i in range(data.K)]

    # ---------------------------------------------------------------- util --

    def _train_dataset(self, ds: str):
        """The one TaskDataset behind a dataset's client shards (the
        layout ``loaders.load_federated_data`` builds); the resident plane
        stages that object, so the invariant is asserted.  Cached: the
        serial local-eval path asks once per client."""
        if ds not in self._train_dataset_cache:
            shards = [self.data.client_shards[i] for i in range(self.data.K)
                      if self.client_dataset_of[i] == ds]
            if not shards:
                raise KeyError(ds)
            first = shards[0].dataset
            if not all(s.dataset is first for s in shards):
                raise ValueError(
                    f"clients of dataset {ds!r} hold distinct TaskDataset "
                    "objects; the resident data plane requires the "
                    "shared-dataset layout loaders.load_federated_data "
                    "builds")
            self._train_dataset_cache[ds] = first
        return self._train_dataset_cache[ds]

    def _group_spec(self, ds: str) -> GroupSpec:
        modality = DATASET_2_MODALITY[ds]
        criterion = TASK_2_CRITERION["img+txt"] if modality == "img+txt" \
            else self.cfg.criterion
        train_ds = self._train_dataset(ds)
        native = None
        if train_ds.images is not None:
            native = train_ds.images.shape[1]
        elif train_ds.image_size:
            native = train_ds.image_size
        img_size = self.model_cfgs[ds].img_size
        resize_to = img_size if (("img" in modality) and native
                                 and native != img_size) else None
        cc = self.cfg.crop if "img" in modality else None
        return GroupSpec(modality=modality, criterion=criterion,
                         resize_to=resize_to, imnorm=self.cfg.imnorm,
                         mu=self.cfg.mu, algorithm=self.cfg.algorithm,
                         aug_resize=self.cfg.resize if cc else None,
                         center_crop=cc)

    def _frozen_token(self, ds: str):
        """Freeze window (fedavgserver.py:422-429, 493-498)."""
        c = self.cfg
        if c.freeze_modality == "none":
            return None
        flag = next((m for i, m in enumerate(self.client_modality_of)
                     if self.client_dataset_of[i] == ds), None)
        if flag != c.freeze_modality:
            return None
        if not (c.warmup_rounds < self.round <= c.freeze_rounds
                + c.warmup_rounds):
            return None
        frozen = tuple(sorted({path for path, name in naming.param_names(
            self.model_cfgs[ds]) if self.param_scope.get(name) == "all"}))
        return frozen or None

    def _group_aug_plan(self, ds: str, spec: GroupSpec):
        """A group's data plane and augmentation routing, shared by the
        FedAvg and CreamFL train paths: returns ``(spec, aug, data)``.
        Crop and flips run on the device inside the resident gather
        (``spec.aug_*``) and keep the group resident; rotation and color
        jitter are host-side transforms (``aug``), so those flags feed the
        group from the host (logged once per dataset).  Reference
        transforms: data.py:86-134."""
        cfg = self.cfg
        aug = AugmentSpec(resize=cfg.resize, crop=cfg.crop,
                          randrot=cfg.randrot, randhf=cfg.randhf,
                          randvf=cfg.randvf, randjit=cfg.randjit)
        aug = aug if ("img" in spec.modality and aug.active) else None
        data = None
        if aug is None:
            data = self._resident_data(ds, spec)
        elif aug.device_supported:
            data = self._resident_data(ds, spec)
            if data is not None:
                spec = dataclasses.replace(
                    spec, aug_resize=aug.resize, aug_crop=aug.crop,
                    aug_randhf=aug.randhf, aug_randvf=aug.randvf)
                aug = None
        elif ds not in self._aug_host_logged:
            self._aug_host_logged.add(ds)
            logger.info("[DATA] %s: --randrot/--randjit are host-side "
                        "transforms; group runs host-fed (crop/flips alone "
                        "would keep the device-resident plane)", ds)
        return spec, aug, data

    # ------------------------------------------------------ resident plane --

    def _stage_resident(self, cache_key: str, dset, spec: GroupSpec):
        """Stage one dataset's arrays on the device once; returns the dict
        of device tensors, or None when the dataset stays host-fed (images
        decoded lazily, or over what is left of the budget).  Path-backed
        retrieval sets stage their deduplicated image store and the
        caption -> image row map (``datasets.py`` ``materialize_images``),
        so a step's gather is ``img_store[img_row[idx]]``."""
        if cache_key in self._resident_cache:
            return self._resident_cache[cache_key]
        arrays = {}
        if "img" in spec.modality:
            if dset.images is not None:
                arrays["img"] = dset.images
            elif dset._image_store is not None:
                arrays["img_store"] = dset._image_store
                arrays["img_row"] = np.asarray(dset._image_row, np.int32)
            else:
                self._resident_cache[cache_key] = None   # lazy decode
                return None
        if "txt" in spec.modality:
            arrays["txt"] = np.asarray(dset.texts, np.int32)
        if spec.modality != "img+txt":
            arrays["tgt"] = np.asarray(dset.targets, np.int32)
        total = sum(a.nbytes for a in arrays.values())
        if total > self.resident_budget_left():
            logger.info("[DATA] %s stays host-fed (%.2f GB > %.2f GB "
                        "remaining of the resident budget)", cache_key,
                        total / 1e9, self.resident_budget_left() / 1e9)
            self._resident_cache[cache_key] = None
            return None
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in arrays.items()}
        logger.info("[DATA] %s staged device-resident (%.1f MB); per-round "
                    "host traffic is now index maps only", cache_key,
                    total / 1e6)
        self._resident_cache[cache_key] = dev
        self._resident_bytes += total
        return dev

    def resident_budget_left(self) -> int:
        """What is left of the staging budget (``FEDCOLA_RESIDENT_BUDGET``
        bytes, 6 GiB by default): one ledger over every consumer (train
        and eval sets, CreamFL's public set)."""
        budget = int(os.environ.get("FEDCOLA_RESIDENT_BUDGET",
                                    6 * 1024 ** 3))
        return max(budget - self._resident_bytes, 0)

    def _resident_data(self, ds: str, spec: GroupSpec):
        """The staged train arrays of a dataset's client group."""
        return self._stage_resident(ds, self._train_dataset(ds), spec)

    def _resident_eval_data(self, ds: str, spec: GroupSpec):
        """The staged server test set of a dataset."""
        return self._stage_resident(f"eval:{ds}", self.data.server_eval[ds],
                                    spec)

    # ------------------------------------------------------------- training --

    def _train_group(self, ds: str, ids: List[int]):
        """One group's batched local update; returns the stacked upload
        tree (aux folded in) and per-client average training metrics."""
        g = self._open_group(ds, ids)
        self._train_chunks(g, g.feeder.round_index_chunks(self.cfg.E)
                           if g.data is not None
                           else g.feeder.round_chunks(self.cfg.E))
        return self._close_group(g)

    def _round_timer(self) -> Timer:
        """The current round's span recorder: its sections and counters are
        the round's ``round_sections`` and ``round_counters``, which its
        update and its evaluation both record into."""
        if self._timer is None or self._timer_round != self.round:
            res = self.results[self.round]
            self._timer = Timer(res.setdefault("round_sections", {}),
                                res.setdefault("round_counters", {}),
                                cuda=self.device.type == "cuda")
            self._timer_round = self.round
        return self._timer

    def _open_group(self, ds: str, ids: List[int]) -> GroupRun:
        """The round-start state of one group: the global model stacked for
        its ``n`` clients (under a mesh, this rank's block of them; on a
        ``model`` axis, its shard of that), fresh optimizer state, the
        freeze mask, the feeder of the whole group, the on-device metric
        sums and the group's data plane."""
        with span(".open"):
            cfg, mcfg = self.cfg, self.model_cfgs[ds]
            spec, aug, data = self._group_aug_plan(ds, self._group_spec(ds))
            rows = self.plan.client_rows(len(ids))
            n = rows.stop - rows.start
            stacked = stack_clients(self.global_params[ds], n)
            global_params = self.global_params[ds]
            tp = self.model_tps[ds]
            if tp is not None:
                stacked = tp.cut(stacked)
                global_params = tp.cut(global_params, lead=0)
            stacked = tree_map(lambda a: a.requires_grad_(True), stacked)
            feeder = GroupFeeder([self.data.client_shards[i] for i in ids],
                                 cfg.B, spec.modality,
                                 chunk_steps=cfg.train_chunk_steps,
                                 shuffle=not cfg.no_shuffle,
                                 rng=self.shuffle_rng,
                                 debug_two_batches=cfg.debug, aug=aug)
            return GroupRun(
                ds=ds, ids=ids, mcfg=mcfg, spec=spec, stacked=stacked,
                opt_state=init_opt_state(self.opt_spec, stacked, n),
                frozen=build_frozen_mask(mcfg, stacked,
                                         self._frozen_token(ds)),
                feeder=feeder,
                acc={k: torch.zeros(n, dtype=torch.float64, device=self.device)
                     for k in ("l", "c", "n")},
                data=data, tp=tp, global_params=global_params)

    def _train_chunks(self, g: GroupRun, chunks) -> None:
        """Local steps over a group's chunks; the metric sums stay on the
        device until the group closes."""
        chunks = Prefetcher(chunks)
        while True:
            # the main thread's wait for the feeder thread's next chunk
            with span(".data"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            ls, cs, ns = run_chunk(g.mcfg, g.spec, self.opt_spec, g.stacked,
                                   g.opt_state, chunk, self.curr_lr,
                                   self.gen, g.frozen, g.global_params,
                                   data=g.data, plan=self.plan, tp=g.tp)
            nsf = ns.double()
            g.acc["l"] += (ls.double() * nsf).sum(1)
            g.acc["c"] += cs.double().sum(1)
            g.acc["n"] += nsf.sum(1)

    def _close_group(self, g: GroupRun):
        """The group's upload (aux folded in) and metrics; under a mesh
        both are the whole group's, gathered from every rank's block (on a
        ``model`` axis, once the model ranks' copies of the replicated
        leaves are checked equal and the shards all-gathered)."""
        with span(".close"):
            n = len(g.ids)
            with torch.no_grad():
                trained = tree_map(lambda a: a.detach(), g.stacked)
                if g.tp is not None:
                    self.plan.check_replicated(
                        {f"{g.ds} client block": g.tp.replicated(trained)},
                        g.tp.group)
                    trained = g.tp.join(trained)
                upload = self.plan.gather_clients(
                    fold_aux_into_upload(g.mcfg, trained), n)
            acc = {k: self.plan.gather_clients(v, n) for k, v in g.acc.items()}
            return upload, self._readback_group_metrics(
                acc, g.ds, g.ids, moe.take_routed_rows(self.device))

    def _readback_group_metrics(self, acc, ds: str, ids: List[int],
                                routed: Optional[torch.Tensor]):
        """The group's metric sums on the host; ``routed`` (a device
        count of an MoE model's token-expert pairs) rides the same
        readback into the round's ``routed_rows``."""
        with readback():
            loss_sums, cor, cnt = (acc[k].cpu().numpy()
                                   for k in ("l", "c", "n"))
            if routed is not None:
                count("routed_rows", int(routed.cpu()))
        bad = ~np.isfinite(loss_sums)
        if bad.any():
            msg = (f"non-finite training loss in round {self.round} for "
                   f"dataset {ds!r}, clients "
                   f"{[ids[j] for j in np.nonzero(bad)[0]]} "
                   f"(lr={self.curr_lr:.3g})")
            if self.cfg.detect_anomaly:
                raise FloatingPointError(msg)
            logger.warning("%s — continuing; aggregation will abort if the "
                           "global params go non-finite", msg)
        return {cid: {"loss": float(loss_sums[j] / max(cnt[j], 1)),
                      "acc1": float(cor[j] / max(cnt[j], 1))}
                for j, cid in enumerate(ids)}

    def _record_update_summary(self, sampled, round_metrics, updated_sizes):
        self.results[self.round]["clients_updated"] = round_metrics
        tr_losses = [round_metrics[i]["loss"] for i in sampled]
        tr_sizes = [updated_sizes[i] for i in sampled]
        summary = self.summarize_losses(tr_losses, tr_sizes)
        self.results[self.round]["clients_updated_summary"] = \
            {"loss": summary}
        logger.info("[%s] [Round %04d] [UPDATE] [SUMMARY] (%d clients) "
                    "loss avg %.4f std %.4f | top10%% %.4f | bottom10%% "
                    "%.4f", self.cfg.algorithm.upper(), self.round,
                    len(sampled), summary["avg"], summary["std"],
                    summary["top10p_avg"], summary["bottom10p_avg"])
        if self.writer:
            self.writer.log({"Local Training Loss/Avg.": summary["avg"],
                             "Local Training Loss/Std.": summary["std"]},
                            self.round)

    def _assert_global_finite(self):
        """Abort when aggregation produced a non-finite global parameter
        (it would poison every later round)."""
        for ds, params in self.global_params.items():
            with readback():
                ok = all(bool(torch.isfinite(l).all())
                         for l in tree_leaves(params))
            if not ok:
                bad = [name for p, name
                       in naming.param_names(self.model_cfgs[ds])
                       if not bool(torch.isfinite(
                           naming.get_by_path(params, p)).all())]
                raise FloatingPointError(
                    f"aggregation produced non-finite global params in "
                    f"round {self.round} for dataset {ds!r}: {bad[:8]} "
                    f"(lr={self.curr_lr:.3g})")

    # --------------------------------------------------------------- round ---

    def _sample_and_train(self):
        """Sample the round's clients and run every group's local update
        (the ``train`` section).  Returns ``(sampled, groups,
        updated_sizes, uploads)``; ``sampled`` is empty when the warmup
        filter leaves no client."""
        cfg = self.cfg
        sampled = sample_clients(
            self.sampler, self.client_dataset_of, self.client_modality_of,
            cfg.client_datasets, self.Cs, cfg.C, cfg.equal_sampled,
            self.round, cfg.warmup_modality, cfg.warmup_rounds)
        if not sampled:
            logger.warning("round %d: no clients sampled (warmup filter)",
                           self.round)
            return [], {}, {}, {}
        groups: Dict[str, List[int]] = defaultdict(list)
        for i in sampled:
            groups[self.clients[i].dataset].append(i)
        updated_sizes = {i: self.clients[i].n_train for i in sampled}
        uploads, round_metrics = {}, {}
        with span("train"):
            for ds, ids in groups.items():
                uploads[ds], m = self._train_group(ds, ids)
                round_metrics.update(m)
        self._record_update_summary(sampled, round_metrics, updated_sizes)
        return sampled, groups, updated_sizes, uploads

    def update(self) -> List[int]:
        with self._round_timer().recording():
            return self._update()

    def _update(self) -> List[int]:
        cfg = self.cfg
        t0 = time.time()
        sampled, groups, updated_sizes, uploads = self._sample_and_train()
        if not sampled:
            return []

        client_cfgs = {ds: self.model_cfgs[ds] for ds in groups}

        def aggregate_all(fedavg: bool):
            new = {}
            for i, ds in enumerate(self.global_params.keys()):
                with span(".plan"):
                    jobs, weights = agg.plan_aggregation(
                        ds, self.model_cfgs[ds], client_cfgs, self.clients,
                        sampled, updated_sizes, self.param_scope,
                        cfg.modalities or [DATASET_2_MODALITY[d]
                                           for d in cfg.client_datasets],
                        dict(groups),
                        out_modality_scale=cfg.out_modality_scales[i]
                        if i < len(cfg.out_modality_scales) else 1.0,
                        compensation=cfg.compensation,
                        share_scope=cfg.share_scope, fedavg=fedavg,
                        model_modality=DATASET_2_MODALITY[ds],
                        model_task=DATASET_2_TASK[ds])
                with span(".apply"):
                    new[ds] = agg.apply_aggregation(
                        jobs, weights, self.global_params[ds], uploads)
            return new

        if cfg.fedavg_eval:
            # evaluate a plain-fedavg aggregate, then restore
            # (fedavgserver.py:794-806)
            old = self.global_params
            with span("fedavg_eval"):
                self.global_params = aggregate_all(fedavg=True)
                self._central_evaluate(fedavg=True)
            self.global_params = old

        with span("aggregate"):
            self.global_params = aggregate_all(fedavg=False)
            if cfg.with_aux:
                with span(".aux"):
                    self.global_params = exchange_aux_weights(
                        self.global_params, self.model_cfgs,
                        {ds: DATASET_2_MODALITY[ds]
                         for ds in self.global_params})
            with span(".check"):
                self.plan.check_replicated(self.global_params)
                # reads every leaf back: the section holds its device work
                self._assert_global_finite()

        if self.round % cfg.lr_decay_step == 0:
            self.curr_lr *= cfg.lr_decay
        self._record_round_time(t0, len(sampled), len(groups))
        return sampled

    def _record_round_time(self, t0: float, n_sampled: int,
                           n_groups: int) -> None:
        """``round_seconds`` (host clock after a synchronize) and the log
        line of the round's sections and counters so far."""
        if self.device.type == "cuda":
            with readback():
                torch.cuda.synchronize()
        dt = time.time() - t0
        self.results[self.round]["round_seconds"] = dt
        timer = self._round_timer()
        logger.info("[%s] [Round %04d] %d clients in %d groups, %.2fs (%s) "
                    "[%s]", self.cfg.algorithm.upper(), self.round,
                    n_sampled, n_groups, dt, timer.summary(),
                    " ".join(f"{k}={v}" for k, v in timer.refresh().items()))

    # ---------------------------------------------------------------- eval ---

    @torch.no_grad()
    def _central_evaluate(self, fedavg: bool = False):
        """Evaluate the global models on the server's test sets; with
        ``fedavg`` the results go under ``server_evaluated_{ds}_fedavg``.
        Its spans lie in the section it runs in: ``eval`` (``evaluate``),
        or ``fedavg_eval``."""
        cfg = self.cfg
        t0 = time.time()
        for ds, test in self.data.server_eval.items():
            mcfg = self.model_cfgs[ds]
            spec = self._group_spec(ds)
            params = self.global_params[ds]
            B = cfg.eval_batch_size or cfg.B
            if DATASET_2_MODALITY[ds] == "img+txt":
                res = retrieval.evaluate(
                    mcfg, spec, params, test, batch_size=B,
                    rng=np.random.RandomState(self.cfg.seed + self.round),
                    resident=self._resident_eval_data(ds, spec),
                    plan=self.plan)
                r1sum = 0.0
                payload = {}
                for split_key, prefix in (("n_fold", "1k"), (None, "5k")):
                    block = res["n_fold"] if split_key else res
                    for d in ("i2t", "t2i"):
                        for m, v in block[d].items():
                            payload[f"{ds} {prefix}_{d}_{m}"] = v
                    r1 = block["i2t"]["recall_1"] + block["t2i"]["recall_1"]
                    payload[f"{ds} {prefix}_r@1sum"] = r1
                    r1sum += r1
                payload[f"{ds} r@1sum"] = r1sum
                tag = f"{ds}_fedavg" if fedavg else ds
                self.results[self.round][f"server_evaluated_{tag}"] = payload
                logger.info("[EVAL] [%s] r@1sum=%.4f 5k_i2t_r@1=%.4f "
                            "5k_t2i_r@1=%.4f", ds, r1sum,
                            res["i2t"]["recall_1"], res["t2i"]["recall_1"])
                if self.writer:
                    self.writer.log(payload, self.round)
                continue
            mm = MetricManager(cfg.eval_metrics)
            resident = self._resident_eval_data(ds, spec)

            def drain_one(logits, idx):
                with span(".drain"):
                    with readback():
                        logits = logits.float().cpu()
                    y = torch.from_numpy(test.targets[idx].astype(np.int64))
                    mm.track(float(cross_entropy(logits, y)),
                             logits.numpy(), y.numpy())

            def fwd(i):
                return eval_forward(mcfg, spec, params, eval_batch(
                    spec, i, self.device, test, resident))

            window = DispatchWindow(drain_one)
            for start in range(0, test.n, B):
                idx = np.arange(start, min(start + B, test.n))
                with span(".forward"):
                    out = self.plan.eval_rows(fwd, idx)
                window.push(out, idx)
            window.flush()
            mm.aggregate(test.n)
            result = mm.results
            tag = f"{ds}_fedavg" if fedavg else ds
            self.results[self.round][f"server_evaluated_{tag}"] = result
            logger.info("[EVAL] [%s] loss=%.4f %s", ds, result["loss"],
                        " ".join(f"{k}={v:.4f}"
                                 for k, v in result["metrics"].items()))
            if self.writer:
                self.writer.log(
                    {f"Loss/Server {ds} Loss": result["loss"],
                     **{f"Test/Server {ds} {k.title()}": v
                        for k, v in result["metrics"].items()}},
                    self.round)
        if not fedavg:
            self.results[self.round]["eval_seconds"] = time.time() - t0

    @staticmethod
    def summarize_losses(losses, num_samples):
        """Weighted avg/std + top/bottom-10% cohort stats of per-client
        losses (fedavgserver.py:362-379)."""
        la = np.asarray(losses, float)
        ns = np.asarray(num_samples, float)
        weighted = la.dot(ns) / ns.sum()
        std = la.std()
        k = int(0.1 * len(la))
        if len(la) > 1 and k >= 1:
            top_i = np.argpartition(la, -k)[-k:]
            bot_i = np.argpartition(la, max(1, k - 1))[:max(1, k)]
        else:
            top_i = bot_i = np.arange(len(la))
        top = la[top_i]; bot = la[bot_i]
        return {
            "avg": float(weighted), "std": float(std),
            "top10p_avg": float(top.dot(ns[top_i]) / ns[top_i].sum()),
            "top10p_std": float(top.std()),
            "bottom10p_avg": float(bot.dot(ns[bot_i]) / ns[bot_i].sum()),
            "bottom10p_std": float(bot.std()),
        }

    @torch.no_grad()
    def _local_evaluate(self, ids, participated: bool):
        """Per-client evaluation of the global models on the clients' local
        holdout sets (``--test_size`` > 0).  The reference's client eval is
        broken for MAT (``self.model(inputs, task=...)``,
        fedavgclient.py:140); this is its intended semantics: each client
        evaluates the downloaded global model on its holdout, with acc1 for
        classification clients and f1 otherwise (fedavgserver.py:252).

        A dataset whose train arrays are resident and whose clients are
        classification or img+txt evaluates as one batched pass over all
        its clients (``client_update.local_eval``); the others run client
        by client."""
        t0 = time.time()
        losses, sizes = [], []
        # per-task-metric cohort values as (value, n_samples) pairs
        metric_vals: Dict[str, List] = defaultdict(list)
        groups: Dict[str, List[int]] = defaultdict(list)
        for i in ids:
            shard = self.data.client_shards[i]
            if shard.test_indices is None or len(shard.test_indices) == 0:
                continue
            groups[self.clients[i].dataset].append(i)

        B = self.cfg.B
        serial: List[int] = []
        for ds, gids in groups.items():
            spec = self._group_spec(ds)
            # client holdouts index the train set, so its staging serves
            resident = self._resident_data(ds, spec)
            if resident is None or not (self.clients[gids[0]].task == "cls"
                                        or spec.modality == "img+txt"):
                serial.extend(gids)
                continue
            tidxs = [self.data.client_shards[i].test_indices for i in gids]
            S = max(-(-len(t) // B) for t in tidxs)
            idx = np.zeros((len(gids), S, B), np.int32)
            val = np.zeros((len(gids), S, B), bool)
            for c, t in enumerate(tidxs):
                for s in range(-(-len(t) // B)):
                    sel = t[s * B:(s + 1) * B]
                    idx[c, s] = pad_batch_indices(sel, B)
                    val[c, s, :len(sel)] = True
            sums = local_eval(self.model_cfgs[ds], spec,
                              self.global_params[ds], idx, val, resident,
                              self.plan)
            with readback():
                ls, cs, ns = (a.cpu().numpy() for a in sums)
            for j in range(len(gids)):
                losses.append(float(ls[j] / max(ns[j], 1.0)))
                sizes.append(len(tidxs[j]))
                if spec.modality != "img+txt":
                    metric_vals["acc1"].append(
                        (float(cs[j] / max(ns[j], 1.0)), len(tidxs[j])))

        for i in serial:
            loss, metrics, n = self._local_evaluate_one(i, B)
            losses.append(loss)
            sizes.append(n)
            for m, v in metrics.items():
                metric_vals[m].append((float(v), n))
        if not losses:
            return
        summary = {"loss": self.summarize_losses(losses, sizes)}
        for m, pairs in metric_vals.items():
            summary[m] = self.summarize_losses([p[0] for p in pairs],
                                               [p[1] for p in pairs])
        key = f'clients_evaluated_{"in" if participated else "out"}'
        self.results[self.round][key] = summary
        self.results[self.round]["local_eval_seconds"] = time.time() - t0
        logger.info("[EVAL] [LOCAL] %d clients | loss avg %.4f std %.4f "
                    "top10%% %.4f bot10%% %.4f", len(losses),
                    summary["loss"]["avg"], summary["loss"]["std"],
                    summary["loss"]["top10p_avg"],
                    summary["loss"]["bottom10p_avg"])
        if self.writer:
            tag = "In" if participated else "Out"
            self.writer.log({f"Local Test Loss ({tag})/Avg.":
                             summary["loss"]["avg"],
                             f"Local Test Loss ({tag})/Std.":
                             summary["loss"]["std"]}, self.round)

    def _local_evaluate_one(self, i: int, B: int):
        """One client's holdout evaluation, batch by batch (the fallback
        of :meth:`_local_evaluate`): ``(loss, metrics, n_samples)``."""
        shard = self.data.client_shards[i]
        ds = self.clients[i].dataset
        mcfg, params = self.model_cfgs[ds], self.global_params[ds]
        spec = self._group_spec(ds)
        resident = self._resident_data(ds, spec)
        metrics = ["acc1"] if self.clients[i].task == "cls" else ["f1"]
        mm = MetricManager(metrics if spec.modality != "img+txt" else [])
        d = shard.dataset

        def drain_one(out, sel):
            if spec.modality == "img+txt":
                fi, ft = out
                with readback():
                    loss = float(clip_contrastive(fi[:len(sel)],
                                                  ft[:len(sel)]))
                mm.track(loss, count=len(sel))
            else:
                with readback():
                    logits = out[:len(sel)].float().cpu()
                y = torch.from_numpy(d.targets[sel].astype(np.int64))
                mm.track(float(cross_entropy(logits, y)), logits.numpy(),
                         y.numpy())

        def fwd(i):
            return eval_forward(mcfg, spec, params, eval_batch(
                spec, i, self.device, d, resident))

        window = DispatchWindow(drain_one)
        tidx = shard.test_indices
        for s in range(0, len(tidx), B):
            sel = tidx[s:s + B]
            window.push(self.plan.eval_rows(fwd, pad_batch_indices(sel, B)),
                        sel)
        window.flush()
        mm.aggregate(len(tidx))
        return (mm.results["loss"], mm.results.get("metrics", {}),
                len(tidx))

    def evaluate(self, excluded_ids=()):
        """``--eval_type`` local / both: the clients' holdout evaluation of
        an eval cohort sampled among the clients not in ``excluded_ids``
        (the reference's ``clients_evaluated_out``, fedavgserver.py:866);
        global / both: the central evaluation, in the ``eval`` section of
        the round's spans."""
        cfg = self.cfg
        with self._round_timer().recording():
            if cfg.eval_type != "global":
                ids = sample_clients(
                    self.sampler, self.client_dataset_of,
                    self.client_modality_of, cfg.client_datasets, self.Cs,
                    cfg.C, cfg.equal_sampled, self.round,
                    exclude=list(excluded_ids),
                    eval_fraction=cfg.eval_fraction, eval_mode=True)
                self._local_evaluate(ids, participated=False)
            if cfg.eval_type != "local":
                with span("eval"):
                    self._central_evaluate()

    # ------------------------------------------------------------- finalize --

    def save_checkpoint(self, path: str):
        """Per-dataset ``.npz`` of the global weights under the reference
        parameter names, with the round and the learning rate, and
        ``__rng__.npz``: the feeder's shuffle stream and the state of the
        torch generator that draws DropPath."""
        os.makedirs(path, exist_ok=True)
        for ds, params in self.global_params.items():
            flat = {}
            for p, name in naming.param_names(self.model_cfgs[ds]):
                flat[name] = naming.get_by_path(params, p).detach() \
                    .float().cpu().numpy()
            np.savez(os.path.join(path, f"{ds}.npz"),
                     __round__=self.round, __lr__=self.curr_lr, **flat)
        # client sampling is stateless (keyed by seed + round); the shuffle
        # stream and the generator are consumed per round, so a resumed run
        # needs them to reproduce an uninterrupted one exactly
        st = self.shuffle_rng.get_state()
        np.savez(os.path.join(path, "__rng__.npz"),
                 mt_keys=st[1], mt_pos=st[2], mt_has_gauss=st[3],
                 mt_cached=st[4], torch_gen=self.gen.get_state().numpy(),
                 torch_gen_device=self.device.type)

    def load_checkpoint(self, path: str):
        for ds in self.global_params:
            f = os.path.join(path, f"{ds}.npz")
            if not os.path.exists(f):
                continue
            params = self.global_params[ds]
            with np.load(f) as z:
                for p, name in naming.param_names(self.model_cfgs[ds]):
                    if name in z:
                        old = naming.get_by_path(params, p)
                        naming.set_by_path(params, p, torch.from_numpy(
                            z[name]).to(device=old.device, dtype=old.dtype))
                self.round = int(z["__round__"])
                self.curr_lr = float(z["__lr__"])
        rngf = os.path.join(path, "__rng__.npz")
        if not os.path.exists(rngf):
            return
        with np.load(rngf) as z:
            self.shuffle_rng.set_state(
                ("MT19937", z["mt_keys"], int(z["mt_pos"]),
                 int(z["mt_has_gauss"]), float(z["mt_cached"])))
            if str(z["torch_gen_device"]) != self.device.type:
                raise ValueError(
                    f"checkpoint {path} was written by a run on "
                    f"{z['torch_gen_device']}; its generator state cannot "
                    f"continue on {self.device.type}")
            self.gen.set_state(torch.from_numpy(z["torch_gen"]))

    def finalize(self):
        cfg = self.cfg
        os.makedirs(cfg.result_path, exist_ok=True)
        from fedcola_tpu_torch.utils.logging import json_sanitize
        out = {str(k): v for k, v in self.results.items()}
        if self.mesh_stats is not None:
            out["mesh"] = self.mesh_stats
        with open(os.path.join(cfg.result_path, f"{cfg.exp_name}.json"),
                  "w", encoding="utf8") as f:
            json.dump(json_sanitize(out), f, indent=4, default=float)
        ckpt_dir = os.path.join(cfg.result_path, cfg.exp_name)
        self.save_checkpoint(ckpt_dir)
        # reference-format final checkpoints: a state dict per dataset under
        # the reference's parameter names and layouts (fedavgserver.py:
        # 884-898), which its ModalityAgnosticTransformer loads strictly
        for ds, params in self.global_params.items():
            torch.save(to_torch_state_dict(self.model_cfgs[ds], params),
                       os.path.join(ckpt_dir, f"{ds}.pt"))
        if self.writer:
            self.writer.finish()
        logger.info("[%s] finished federated learning (%d rounds)",
                    cfg.algorithm.upper(), self.round)


class FedProxServer(FedAvgServer):
    """The proximal term lives in the client loss (``GroupSpec.mu``;
    reference fedproxserver.py:10-12)."""


class FedIoTServer(FedAvgServer):
    """A sharing rule on the fedavg machinery: ``--shared_param blocks
    --share_scope modality_exact`` (reference README.md:70; its fediot
    modules are missing), which ``config.check_args`` applies when neither
    flag is given."""


# fedsgd is fedavg with one local epoch (config.check_args sets E = 1)
SERVER_REGISTRY = {
    "fedavg": FedAvgServer,
    "fedprox": FedProxServer,
    "fediot": FedIoTServer,
    "fedsgd": FedAvgServer,
}


def create_server(cfg: ExperimentConfig, data: FederatedData, writer=None,
                  plan: Optional[MeshPlan] = None):
    if cfg.algorithm in SERVER_REGISTRY:
        return SERVER_REGISTRY[cfg.algorithm](cfg, data, writer, plan)
    if cfg.algorithm == "creamfl":
        from fedcola_tpu_torch.federation.creamfl import CreamflServer
        return CreamflServer(cfg, data, writer, plan)
    if cfg.algorithm in ("fedavgm", "fedadam", "fedyogi", "fedadagrad"):
        from fedcola_tpu_torch.federation.fedopt import FedOptServer
        return FedOptServer(cfg, data, writer, plan)
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
