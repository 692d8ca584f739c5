"""Local optimizers with torch.optim-parity update rules over client-stacked
parameter trees (port of ``fedcola_tpu/parallel/optim.py``).

Every leaf carries a leading client axis ``[n, ...]``; step counters are
per leaf and per client (``[n]`` int32), as torch keeps ``state['step']``
per parameter.  A static ``frozen`` mask (a tree of python bools) skips a
leaf entirely, weight decay included, like a torch parameter whose grad is
None.  ``step_valid`` (``[n]`` bool) makes a padded step a full no-op for
that client: parameters, moments and counters untouched.  Updates run in
place under ``torch.no_grad`` (the trees are owned by the group update).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fedcola_tpu_torch.models.mat import tree_map
from fedcola_tpu_torch.parallel.mesh import all_reduce_sum


@dataclass(frozen=True)
class OptimizerSpec:
    name: str = "AdamW"          # SGD | Adam | AdamW (torch names)
    weight_decay: float = 0.0
    momentum: float = 0.0
    nesterov: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 0.0   # 0 = no clipping (main.py:270)
    moment_dtype: str = "float32"


def make_optimizer_spec(cfg) -> OptimizerSpec:
    """From an ExperimentConfig, mirroring ``_refine_optim_args``
    (fedavgclient.py:34-42)."""
    return OptimizerSpec(
        name=cfg.optimizer,
        weight_decay=cfg.weight_decay,
        momentum=cfg.momentum,
        nesterov=cfg.nesterov,
        max_grad_norm=cfg.max_grad_norm,
        moment_dtype=getattr(cfg, "moment_dtype", "float32"),
    )


def init_opt_state(spec: OptimizerSpec, params, n_clients: int):
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        spec.moment_dtype]
    t = tree_map(lambda p: torch.zeros(n_clients, dtype=torch.int32,
                                       device=p.device), params)
    zeros = lambda dtype: tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=dtype), params)
    if spec.name in ("Adam", "AdamW"):
        return {"m": zeros(mdt), "v": zeros(mdt), "t": t}
    if spec.name == "SGD":
        return {"b": zeros(torch.float32), "t": t}
    raise ValueError(spec.name)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def clip_global_norm(grads, max_norm: float, frozen=None, tp=None):
    """``clip_grad_norm_`` per client: each client's grads scale by
    max_norm / (its total L2 norm + 1e-6) when that is below 1.  ``tp``
    (``parallel.mesh.TensorParallel``): the grads are a model rank's cut;
    the sharded leaves' square sums are summed over the model ranks, the
    replicated leaves counted once."""
    leaves = [(p, g) for p, g in _flat(grads)
              if frozen is None or not _get(frozen, p)]
    n = leaves[0][1].shape[0]

    def sq(g):
        return g.float().reshape(n, -1).square().sum(1)

    sharded = [tp is not None and tp.dim(p[-1]) is not None
               for p, _ in leaves]
    total = sum(sq(g) for (_, g), s in zip(leaves, sharded) if not s)
    if any(sharded):
        total = total + all_reduce_sum(
            [sum(sq(g) for (_, g), s in zip(leaves, sharded) if s)],
            tp.group)[0]
    coef = torch.clamp(max_norm / (total.sqrt() + 1e-6), max=1.0)
    return tree_map(lambda g: g * _bcast(coef, g).to(g.dtype), grads)


@torch.no_grad()
def opt_update(spec: OptimizerSpec, params, grads, state, lr: float,
               frozen=None, step_valid: Optional[torch.Tensor] = None,
               tp=None):
    """One optimizer step, in place; returns (params, state).  ``tp``: the
    trees are a model rank's cut (see :func:`clip_global_norm`)."""
    if spec.max_grad_norm > 0:
        grads = clip_global_norm(grads, spec.max_grad_norm, frozen, tp)
    for path, p in _flat(params):
        if frozen is not None and _get(frozen, path):
            continue
        g = _get(grads, path).float()
        t_ref = _get(state["t"], path)
        ok = (torch.ones_like(t_ref, dtype=torch.bool) if step_valid is None
              else step_valid)
        t = t_ref + 1
        tf = _bcast(t.float(), p)
        p32 = p.float()
        if spec.name in ("Adam", "AdamW"):
            m_ref, v_ref = _get(state["m"], path), _get(state["v"], path)
            if spec.name == "Adam":
                g = g + spec.weight_decay * p32
            m = spec.beta1 * m_ref.float() + (1 - spec.beta1) * g
            v = spec.beta2 * v_ref.float() + (1 - spec.beta2) * g * g
            mh = m / (1 - spec.beta1 ** tf)
            vh = v / (1 - spec.beta2 ** tf)
            if spec.name == "AdamW":
                p32 = p32 * (1 - lr * spec.weight_decay)
            p32 = p32 - lr * mh / (torch.sqrt(vh) + spec.eps)
            okb = _bcast(ok, p)
            m_ref.copy_(torch.where(okb, m.to(m_ref.dtype), m_ref))
            v_ref.copy_(torch.where(okb, v.to(v_ref.dtype), v_ref))
        elif spec.name == "SGD":
            b_ref = _get(state["b"], path)
            g = g + spec.weight_decay * p32
            if spec.momentum > 0:
                first = _bcast(t == 1, p)
                b = torch.where(first, g, spec.momentum * b_ref + g)
                d = g + spec.momentum * b if spec.nesterov else b
            else:
                b, d = b_ref, g
            p32 = p32 - lr * d
            b_ref.copy_(torch.where(_bcast(ok, p), b, b_ref))
        else:
            raise ValueError(spec.name)
        p.copy_(torch.where(_bcast(ok, p), p32.to(p.dtype), p))
        t_ref.copy_(torch.where(ok, t, t_ref))
    return params, state
