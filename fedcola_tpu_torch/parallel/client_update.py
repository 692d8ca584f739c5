"""Batched client local updates over client-stacked trees (port of
``fedcola_tpu/parallel/client_update.py``).

A round's sampled clients are grouped by dataset; their parameters,
optimizer state and batches are stacked on a leading client axis ``[n,
...]``, and every step runs one forward and one backward over all ``n``
clients together, so each kernel launch covers the whole group.  Per-step
``step_valid`` masks make padded steps exact no-ops (heterogeneous
per-client step counts), per-sample ``valid`` masks the partial final batch.

Two data planes feed the steps.  On the resident plane (the default) the
server stages each dataset on the device once and a chunk carries only
index maps; every step gathers its batch there (``resident_gather``) and
crop / flips run on the device (``device_augment``).  On the host-fed
plane a chunk carries the gathered pixels and tokens, copied per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedcola_tpu_torch.models.mat import (DTYPES, MATConfig, mat_apply,
                                          mat_apply_stacked, tree_leaves)
from fedcola_tpu_torch.ops import losses
from fedcola_tpu_torch.parallel.mesh import MeshPlan, RankDraws
from fedcola_tpu_torch.parallel.optim import OptimizerSpec, opt_update
from fedcola_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class GroupSpec:
    """Static description of one client group's local training program."""
    modality: str                  # img | txt | img+txt
    criterion: str                 # CrossEntropyLoss | ContrastiveLoss | ...
    img_slot: int = 0
    txt_slot: int = 1
    resize_to: Optional[int] = None      # on-device resize (e.g. 32->224)
    imnorm: bool = False                 # (x/255 - .5)/.5 (data.py:107-109)
    mu: float = 0.0                      # fedprox proximal coefficient
    algorithm: str = "fedavg"
    # train augmentation on the device, inside the resident gather
    # (reference transforms data.py:86-134; rotation / jitter stay on the
    # host)
    aug_resize: Optional[int] = None     # Resize((r, r)) BEFORE the crop
    aug_crop: Optional[int] = None       # RandomCrop(c, padding=4,
    #                                      pad_if_needed=True)
    aug_randhf: Optional[float] = None   # RandomHorizontalFlip(p)
    aug_randvf: Optional[float] = None   # RandomVerticalFlip(p)
    center_crop: Optional[int] = None    # eval-side CenterCrop after Resize

    @property
    def device_aug(self) -> bool:
        return (self.aug_crop is not None or self.aug_randhf is not None
                or self.aug_randvf is not None)


def _resize(x: torch.Tensor, size: int,
            antialias: bool = False) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` float images, half-pixel
    centres (``jax.image.resize(..., "bilinear")`` when upsampling; with
    ``antialias`` in every direction)."""
    lead = x.shape[:-3]
    y = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1).reshape(lead + (size, size, x.shape[-1]))


def preprocess_images(x: torch.Tensor, spec: GroupSpec,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 ``[..., H, W, C]`` pixels -> normalised float, on device."""
    x = x.float() / 255.0
    if spec.imnorm:
        x = (x - 0.5) / 0.5
    hw = tuple(x.shape[-3:-1])
    if spec.center_crop is not None and hw != (spec.center_crop,) * 2:
        if spec.aug_resize is not None and hw != (spec.aug_resize,) * 2:
            x = _resize(x, spec.aug_resize)
        c = spec.center_crop
        if x.shape[-3] > c and x.shape[-2] > c:
            y0 = (x.shape[-3] - c) // 2
            x0 = (x.shape[-2] - c) // 2
            x = x[..., y0:y0 + c, x0:x0 + c, :]
    if (spec.resize_to is not None
            and tuple(x.shape[-3:-1]) != (spec.resize_to,) * 2):
        x = _resize(x, spec.resize_to)
    return x.to(dtype)


# --------------------------------------------------- device augmentation ----

@dataclass
class AugDraws:
    """The random part of one :func:`device_augment` call, per sample:
    crop offsets ``ys`` / ``xs`` into the padded image and the flip masks
    (None where the transform is off)."""
    ys: Optional[torch.Tensor] = None
    xs: Optional[torch.Tensor] = None
    hflip: Optional[torch.Tensor] = None
    vflip: Optional[torch.Tensor] = None


def _crop_canvas(hw: Tuple[int, int], crop: int,
                 resize: Optional[int]) -> Tuple[int, int, int, int]:
    """``(H, W, dh, dw)``: the padded image a crop is taken from (the 4-pixel
    padding plus ``pad_if_needed``'s deficit on both sides) and that
    deficit."""
    h, w = (resize, resize) if resize is not None else hw
    h, w = h + 8, w + 8
    dh, dw = max(crop - h, 0), max(crop - w, 0)
    return h + 2 * dh, w + 2 * dw, dh, dw


def draw_augment(B: int, hw: Tuple[int, int], crop: Optional[int],
                 randhf: Optional[float], randvf: Optional[float],
                 resize: Optional[int], gen: torch.Generator) -> AugDraws:
    """Draw the per-sample crop offsets and flips for a batch of ``B``
    images of size ``hw`` from ``gen``, on the generator's device."""
    dev = gen.device
    d = AugDraws()
    if crop is not None:
        H, W, _, _ = _crop_canvas(hw, crop, resize)
        d.ys = torch.randint(0, H - crop + 1, (B,), generator=gen, device=dev)
        d.xs = torch.randint(0, W - crop + 1, (B,), generator=gen, device=dev)
    if randhf is not None:
        d.hflip = torch.rand(B, generator=gen, device=dev) < randhf
    if randvf is not None:
        d.vflip = torch.rand(B, generator=gen, device=dev) < randvf
    return d


def apply_augment(x: torch.Tensor, draws: AugDraws, crop: Optional[int],
                  resize: Optional[int] = None) -> torch.Tensor:
    """Train augmentation of uint8 ``[B, H, W, C]`` images with the given
    draws, in the reference's transform order (data.py:93-103):
    Resize((r, r)) -> RandomCrop(c, padding=4, pad_if_needed=True) ->
    RandomHorizontalFlip -> RandomVerticalFlip.  The crop is one gather
    over the batch."""
    if crop is not None:
        if resize is not None and tuple(x.shape[1:3]) != (resize, resize):
            # pixel-scale bilinear, rounded back to uint8 (the reference
            # resizes the uint8 PIL image before cropping)
            x = _resize(x.float(), resize, antialias=True)
            x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
        _, _, dh, dw = _crop_canvas(tuple(x.shape[1:3]), crop, None)
        x = F.pad(x, (0, 0, 4 + dw, 4 + dw, 4 + dh, 4 + dh))
        ar = torch.arange(crop, device=x.device)
        rows = (draws.ys[:, None] + ar)[:, :, None]
        cols = (draws.xs[:, None] + ar)[:, None, :]
        b = torch.arange(x.shape[0], device=x.device)[:, None, None]
        x = x[b, rows, cols]
    if draws.hflip is not None:
        x = torch.where(draws.hflip[:, None, None, None], x.flip(2), x)
    if draws.vflip is not None:
        x = torch.where(draws.vflip[:, None, None, None], x.flip(1), x)
    return x


def device_augment(x: torch.Tensor, gen: torch.Generator,
                   crop: Optional[int], randhf: Optional[float],
                   randvf: Optional[float],
                   resize: Optional[int] = None) -> torch.Tensor:
    """Per-sample train augmentation on the device (the host ``_augment``
    semantics of ``data/pipeline.py``), drawn from ``gen``."""
    draws = draw_augment(x.shape[0], tuple(x.shape[1:3]), crop, randhf,
                         randvf, resize, gen)
    return apply_augment(x, draws, crop, resize)


# ------------------------------------------------------ resident gather ----

def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` at ``idx`` (any shape): ``[*idx.shape, ...]``."""
    return t.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(t.shape[1:]))


def _take_images(data: Dict[str, torch.Tensor],
                 idx: torch.Tensor) -> torch.Tensor:
    """Row gather from staged image storage: ``img [N, H, W, C]`` for
    array-backed datasets, or a deduplicated ``img_store`` plus the
    caption -> image map ``img_row`` for path-backed retrieval sets, where
    the gather adds one indirection."""
    if "img_store" in data:
        return _take(data["img_store"], _take(data["img_row"], idx))
    return _take(data["img"], idx)


def resident_gather(spec: GroupSpec, data: Dict[str, torch.Tensor],
                    idx: torch.Tensor,
                    valid: Optional[torch.Tensor] = None):
    """A batch assembled on the device from the staged dataset arrays."""
    batch = {} if valid is None else {"valid": valid}
    if spec.modality == "img":
        batch["x"] = _take_images(data, idx)
        batch["y"] = _take(data["tgt"], idx)
    elif spec.modality == "txt":
        batch["x"] = _take(data["txt"], idx)
        batch["y"] = _take(data["tgt"], idx)
    else:  # img+txt: token ids ride the target slot
        batch["x"] = _take_images(data, idx)
        batch["y"] = _take(data["txt"], idx)
    return batch


def eval_batch(spec: GroupSpec, idx: np.ndarray, device, dset=None,
               data: Optional[Dict[str, torch.Tensor]] = None):
    """The eval batch of rows ``idx``: gathered on the device from the
    staged arrays ``data`` when there are any, else read from the
    TaskDataset ``dset`` on the host and copied."""
    if data is not None:
        return resident_gather(spec, data, torch.from_numpy(
            np.asarray(idx)).to(device))
    x = dset.texts[idx] if spec.modality == "txt" else dset.load_images(idx)
    y = dset.texts[idx] if spec.modality == "img+txt" \
        else dset.targets[idx].astype(np.int32)
    return to_device_batch({"x": x, "y": y}, device)


def _route_inputs(cfg: MATConfig, spec: GroupSpec, batch, dtype):
    """Modality-routed MAT input slots: ``(ins, out_slot)``, where out_slot
    is the logits slot for uni-modal groups and None for img+txt."""
    ins = [None] * len(cfg.modalities)
    if spec.modality == "img":
        ins[spec.img_slot] = preprocess_images(batch["x"], spec, dtype)
        return ins, spec.img_slot
    if spec.modality == "txt":
        ins[spec.txt_slot] = batch["x"]
        return ins, spec.txt_slot
    ins[spec.img_slot] = preprocess_images(batch["x"], spec, dtype)
    ins[spec.txt_slot] = batch["y"]          # token ids ride the target slot
    return ins, None


def _per_client(fn):
    """Apply a loss defined on one client's ``[B, ...]`` batch to each
    client of a stacked group: ``[n]`` losses."""
    def stacked(logits, y, valid):
        return torch.stack([fn(logits[c], y[c], valid[c])
                            for c in range(logits.shape[0])])
    return stacked


def _cls_criterion(name: str):
    """Criterion lookup by torch.nn name (reference fedavgclient.py:23, with
    the monkey-patched losses of src/utils.py:286-315).  ``seq2seq_ce`` is
    absent: it needs ``[B, L, V]`` logits, which no MAT head emits
    (``config.check_args`` refuses Seq2SeqLoss)."""
    return {
        "CrossEntropyLoss": losses.cross_entropy,
        "PainlessBCEWithLogitsLoss": losses.painless_bce,
        "BCEWithLogitsLoss": losses.painless_bce,
        "SegLoss": _per_client(losses.seg_loss),
    }[name]


def _mm_criterion(name: str):
    """Multimodal criterion (TASK_2_CRITERION, fedavgserver.py:76-80)."""
    return {
        "ContrastiveLoss": losses.clip_contrastive,
        "MCSoftContrastiveLoss": losses.mc_soft_contrastive,
    }[name]


def _local_loss(cfg: MATConfig, spec: GroupSpec, params, batch, gen,
                global_params=None, data_plan=None, tp=None):
    """Per-client losses ``[n]`` and (correct, n_valid) counts for one step
    of a client-stacked group (reference fedavgclient.py:81-95); FedProx
    adds the proximal term against the round's global model
    (fedproxclient.py:64-67).

    ``data_plan``: the mesh plan when the batch is split over its data
    ranks.  The outputs, targets and mask are then gathered over them with
    the outputs' gradient, so the loss and counts are the whole batch's on
    every data rank, and the sum of the ranks' gradients is the whole
    batch's gradient.  ``tp`` (``parallel.mesh.TensorParallel``):
    ``params`` and ``global_params`` are the model rank's cut, and the
    forward and the FedProx term run on its shards."""
    dtype = DTYPES[cfg.compute_dtype]
    valid = batch["valid"]
    ins, out_slot = _route_inputs(cfg, spec, batch, dtype)
    if out_slot is not None:
        logits = mat_apply_stacked(cfg, params, ins, train=True,
                                   gen=gen, tp=tp)[out_slot]
        y = batch["y"]
        if data_plan is not None:
            logits, y, valid = map(data_plan.gather_batch, (logits, y, valid))
        loss = _cls_criterion(spec.criterion)(logits, y, valid)
        correct = ((logits.argmax(-1) == y) & valid).sum(-1)
    else:
        feats = mat_apply_stacked(cfg, params, ins, feat_out=True,
                                  train=True, gen=gen, tp=tp)
        fi, ft = feats[spec.img_slot], feats[spec.txt_slot]
        if data_plan is not None:
            fi, ft, valid = map(data_plan.gather_batch, (fi, ft, valid))
        loss = _mm_criterion(spec.criterion)(fi, ft, valid)
        correct = torch.zeros_like(loss, dtype=torch.int64)
    if spec.algorithm == "fedprox" and spec.mu > 0:
        prox = losses.fedprox_term(params, global_params, spec.mu, tp)
        if data_plan is not None:
            # every data rank adds the term and their gradients are summed:
            # each carries 1/d of its gradient, at the full value
            s = 1.0 / data_plan.data_axis
            prox = prox * s + (prox * (1.0 - s)).detach()
        loss = loss + prox
    return loss, (correct, valid.sum(-1))


def build_frozen_mask(cfg: MATConfig, params,
                      frozen_token: Optional[Tuple[Tuple[str, ...], ...]]
                      = None):
    """Static ``requires_grad=False`` mask tree for ``params`` (python
    bools), or None when nothing is frozen.  aux_trained=False freezes the
    aux weights (reference mome.py:47-53)."""
    frozen_set = set(frozen_token or ())
    if cfg.has_aux and not cfg.aux_trained:
        for kind in cfg.aux_layer_kinds:
            frozen_set.add(("aux", f"{kind}_aux"))
    if not frozen_set:
        return None

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return path in frozen_set

    return walk(params, ())


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}


def run_chunk(cfg: MATConfig, spec: GroupSpec, opt: OptimizerSpec, params,
              opt_state, chunk: Dict[str, np.ndarray], lr: float, gen,
              frozen=None, global_params=None,
              data: Optional[Dict[str, torch.Tensor]] = None, plan=None,
              tp=None):
    """Run one chunk of local steps for a client-stacked group, updating
    ``params`` and ``opt_state`` in place.  Host-fed, the chunk holds the
    gathered ``[n, S, B, ...]`` batches; on the resident plane (``data``:
    the staged dataset arrays) it holds ``idx`` / ``valid [n, S, B]``, and
    each step gathers and augments its batch on the device.  Both carry
    ``step_valid [n, S]``.  ``global_params``: the round's global model,
    which the FedProx term reads.  Returns per-step device tensors (loss,
    correct, n_valid), each ``[n, S]``; steps no client runs are
    skipped.

    ``plan`` (``parallel.mesh.MeshPlan``): the chunk is the whole group's,
    ``params`` / ``opt_state`` this rank's block of clients (on a ``model``
    axis, ``tp``'s ``TensorParallel.cut`` of them, and of
    ``global_params`` too);
    the rank runs its clients and batch rows of every step some client of
    the group runs, draws from ``gen`` as one process would, and returns
    its clients' rows."""
    device = tree_leaves(params)[0].device
    sv_all = chunk["step_valid"]
    plan = plan or MeshPlan()
    n, B = chunk["valid"].shape[0], chunk["valid"].shape[2]
    gen = plan.draws(gen, n, B)
    data_plan = plan if plan.splits_batch(B) else None
    chunk = plan.local_chunk(chunk)
    if data is not None:
        # the whole chunk's index maps in one copy
        with span(".data"):
            on_dev = to_device_batch(chunk, device)
    ls, cs, ns = [], [], []
    for s in range(sv_all.shape[1]):
        if not sv_all[:, s].any():
            continue
        count("steps")
        with span(".data"):
            if data is None:
                batch = to_device_batch({k: v[:, s] for k, v in chunk.items()
                                         if k != "step_valid"}, device)
                sv = torch.from_numpy(
                    chunk["step_valid"][:, s].copy()).to(device)
            else:
                batch = resident_gather(spec, data, on_dev["idx"][:, s],
                                        on_dev["valid"][:, s])
                sv = on_dev["step_valid"][:, s]
                if spec.device_aug:
                    batch["x"] = _augment_stacked(spec, batch["x"], gen)
        with span(".forward"):
            loss, (correct, n_valid) = _local_loss(
                cfg, spec, params, batch, gen, global_params, data_plan, tp)
        descend(opt, params, opt_state, loss, lr, frozen, sv, data_plan, tp)
        ls.append(loss.detach())
        cs.append(correct)
        ns.append(n_valid)
    if not ls:
        z = torch.zeros((chunk["step_valid"].shape[0], 0), device=device)
        return z, z, z
    return (torch.stack(ls, 1), torch.stack(cs, 1), torch.stack(ns, 1))


def _augment_stacked(spec: GroupSpec, x: torch.Tensor,
                     draws: RankDraws) -> torch.Tensor:
    """Device augmentation of a stacked ``[n, B, H, W, C]`` batch: the
    per-sample draws are made for the whole group's flattened batch, of
    which this rank's block is applied."""
    lead = tuple(x.shape[:2])
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    full = draw_augment(draws.n * draws.B, tuple(flat.shape[1:3]),
                        spec.aug_crop, spec.aug_randhf, spec.aug_randvf,
                        spec.aug_resize, draws.gen)
    mine = AugDraws(*(None if t is None else
                      draws.block(t.reshape(draws.n, draws.B)).reshape(-1)
                      for t in (full.ys, full.xs, full.hflip, full.vflip)))
    out = apply_augment(flat, mine, spec.aug_crop, spec.aug_resize)
    return out.reshape(lead + tuple(out.shape[1:]))


def descend(opt: OptimizerSpec, params, opt_state, loss: torch.Tensor,
            lr: float, frozen=None, step_valid=None, data_plan=None,
            tp=None) -> None:
    """One optimizer step, in place, on the gradient of ``loss.sum()`` (the
    clients' losses are independent).  A leaf the loss does not reach gets
    a zero gradient, which still decays its moments: freeze it in
    ``frozen`` to skip it as torch skips a parameter whose grad is None.
    ``data_plan``: the gradients are summed over the mesh's data ranks
    first (before clipping and the update).  ``tp``: ``params`` is a model
    rank's cut; the replicated leaves' partial gradients are summed over
    the model ranks, and clipping counts the shards' square sums."""
    leaves = tree_leaves(params)
    with span(".backward"):
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if data_plan is not None:
            grads = data_plan.sum_over_data(grads)
        if tp is not None:
            grads = tp.sum_partial_grads(params, grads)
    with span(".opt"):
        opt_update(opt, params, _unflatten_like(params, grads), opt_state,
                   lr, frozen=frozen, step_valid=step_valid, tp=tp)


def _unflatten_like(tree, flat):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


# ----------------------------------------------------------------- eval ----

@torch.no_grad()
def eval_forward(cfg: MATConfig, spec: GroupSpec, params,
                 batch: Dict[str, torch.Tensor]):
    """Inference forward of one (unstacked) model: logits for uni-modal
    groups, (image features, text features) for img+txt."""
    dtype = DTYPES[cfg.compute_dtype]
    ins, slot = _route_inputs(cfg, spec, batch, dtype)
    if slot is not None:
        return mat_apply(cfg, params, ins)[slot]
    outs = mat_apply(cfg, params, ins, feat_out=True)
    return outs[spec.img_slot], outs[spec.txt_slot]


@torch.no_grad()
def local_eval(cfg: MATConfig, spec: GroupSpec, params,
               idx: np.ndarray, valid: np.ndarray,
               data: Dict[str, torch.Tensor], plan=None):
    """Per-client holdout evaluation of one global model on the resident
    plane: ``idx`` / ``valid [n, S, B]`` index the staged train arrays.
    Every step is one eval forward over all ``n`` clients' rows (the
    weights are shared, so the flattened ``[n·B]`` batch is exact), reduced
    per client under ``valid``: CE for classification clients (whatever
    the training criterion), the group's contrastive criterion on each
    client's slice for img+txt.  Returns float64 device tensors ``[n]``:
    the loss·count sums, correct counts and valid counts (the
    ``MetricManager.track`` weighting, src/utils.py:339,347).  ``plan``: a
    mesh splits each step's rows over its ranks (``MeshPlan.eval_rows``)."""
    device = tree_leaves(params)[0].device
    n = idx.shape[0]
    on_dev = to_device_batch({"idx": idx, "valid": valid}, device)
    ls, cs, ns = (torch.zeros(n, dtype=torch.float64, device=device)
                  for _ in range(3))

    def rows_forward(rows):
        return eval_forward(cfg, spec, params, resident_gather(
            spec, data, torch.as_tensor(rows, device=device)))

    for s in range(idx.shape[1]):
        if not valid[:, s].any():
            continue
        i, v = on_dev["idx"][:, s], on_dev["valid"][:, s]
        if plan is None:
            out = rows_forward(i.reshape(-1))
        else:
            out = plan.eval_rows(rows_forward, idx[:, s].reshape(-1))
        if spec.modality == "img+txt":
            fi, ft = (f.reshape(i.shape + f.shape[1:]) for f in out)
            loss = _mm_criterion(spec.criterion)(fi, ft, v)
        else:
            logits = out.reshape(i.shape + out.shape[1:])
            y = _take(data["tgt"], i)
            loss = losses.cross_entropy(logits, y, v)
            cs += ((logits.argmax(-1) == y) & v).sum(-1)
        nv = v.sum(-1).double()
        ls += loss.double() * nv
        ns += nv
    return ls, cs, ns
