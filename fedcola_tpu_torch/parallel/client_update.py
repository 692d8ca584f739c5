"""Batched client local updates over client-stacked trees (port of
``fedcola_tpu/parallel/client_update.py``, host-fed data plane).

A round's sampled clients are grouped by dataset; their parameters,
optimizer state and batches are stacked on a leading client axis ``[n,
...]``, and every step runs one forward and one backward over all ``n``
clients together, so each kernel launch covers the whole group.  Per-step
``step_valid`` masks make padded steps exact no-ops (heterogeneous
per-client step counts), per-sample ``valid`` masks the partial final batch.
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
from fedcola_tpu_torch.parallel.optim import OptimizerSpec, opt_update


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
    aug_resize: Optional[int] = None
    center_crop: Optional[int] = None    # eval-side CenterCrop after Resize


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` float images, half-pixel
    centres, no antialias (``jax.image.resize(..., "bilinear")`` when
    upsampling)."""
    lead = x.shape[:-3]
    y = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
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
                global_params=None):
    """Per-client losses ``[n]`` and (correct, n_valid) counts for one step
    of a client-stacked group (reference fedavgclient.py:81-95); FedProx
    adds the proximal term against the round's global model
    (fedproxclient.py:64-67)."""
    dtype = DTYPES[cfg.compute_dtype]
    valid = batch["valid"]
    ins, out_slot = _route_inputs(cfg, spec, batch, dtype)
    if out_slot is not None:
        logits = mat_apply_stacked(cfg, params, ins, train=True,
                                   gen=gen)[out_slot]
        loss = _cls_criterion(spec.criterion)(logits, batch["y"], valid)
        correct = ((logits.argmax(-1) == batch["y"]) & valid).sum(-1)
    else:
        feats = mat_apply_stacked(cfg, params, ins, feat_out=True,
                                  train=True, gen=gen)
        loss = _mm_criterion(spec.criterion)(feats[spec.img_slot],
                                             feats[spec.txt_slot], valid)
        correct = torch.zeros_like(loss, dtype=torch.int64)
    if spec.algorithm == "fedprox" and spec.mu > 0:
        loss = loss + losses.fedprox_term(params, global_params, spec.mu)
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
              frozen=None, global_params=None):
    """Run one host chunk (``[n, S, ...]`` arrays + ``step_valid [n, S]``)
    of local steps for a client-stacked group, updating ``params`` and
    ``opt_state`` in place.  ``global_params``: the round's global model,
    which the FedProx term reads.  Returns per-step device tensors (loss,
    correct, n_valid), each ``[n, S]``; steps no client runs are skipped."""
    device = tree_leaves(params)[0].device
    sv_all = chunk["step_valid"]
    ls, cs, ns = [], [], []
    for s in range(sv_all.shape[1]):
        if not sv_all[:, s].any():
            continue
        batch = to_device_batch({k: v[:, s] for k, v in chunk.items()
                                 if k != "step_valid"}, device)
        sv = torch.from_numpy(sv_all[:, s].copy()).to(device)
        loss, (correct, n_valid) = _local_loss(cfg, spec, params, batch, gen,
                                               global_params)
        descend(opt, params, opt_state, loss, lr, frozen, sv)
        ls.append(loss.detach())
        cs.append(correct)
        ns.append(n_valid)
    if not ls:
        z = torch.zeros((sv_all.shape[0], 0), device=device)
        return z, z, z
    return (torch.stack(ls, 1), torch.stack(cs, 1), torch.stack(ns, 1))


def descend(opt: OptimizerSpec, params, opt_state, loss: torch.Tensor,
            lr: float, frozen=None, step_valid=None) -> None:
    """One optimizer step, in place, on the gradient of ``loss.sum()`` (the
    clients' losses are independent).  A leaf the loss does not reach gets
    a zero gradient, which still decays its moments: freeze it in
    ``frozen`` to skip it as torch skips a parameter whose grad is None."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grad_tree = _unflatten_like(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    opt_update(opt, params, grad_tree, opt_state, lr, frozen=frozen,
               step_valid=step_valid)


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
