"""Local optimizers with torch.optim-parity update rules over client-stacked
parameter trees (port of ``fedcola_tpu/parallel/optim.py``).

Every leaf carries a leading client axis ``[n, ...]``; step counters are
per leaf and per client (``[n]`` int32), as torch keeps ``state['step']``
per parameter.  A static ``frozen`` mask (a tree of python bools) skips a
leaf entirely, weight decay included, like a torch parameter whose grad is
None.  ``step_valid`` (``[n]`` bool) makes a padded step a full no-op for
that client: parameters, moments and counters untouched.  Updates run in
place under ``torch.no_grad`` (the trees are owned by the group update).

On CUDA tensors a step is one launch of ``csrc/opt_update.cu`` over every
non-frozen leaf (:func:`opt_launches` packs its work table); on the CPU it
is :func:`opt_update_plain`, the eager loop the kernel is held to.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedcola_tpu_torch.models.mat import tree_map
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.parallel.mesh import all_reduce_sum
from fedcola_tpu_torch.utils.profiling import count


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
    trees are a model rank's cut (see :func:`clip_global_norm`).  CUDA
    leaves take the fused kernel (counted in the round's ``opt_fused``),
    CPU leaves :func:`opt_update_plain`."""
    if spec.max_grad_norm > 0:
        grads = clip_global_norm(grads, spec.max_grad_norm, frozen, tp)
    if not _on_cuda(params):
        return opt_update_plain(spec, params, grads, state, lr, frozen,
                                step_valid)
    # ``grads`` holds the gradients the launches read until they are issued
    launches, grads = opt_launches(spec, params, grads, state, lr, frozen,
                                   step_valid)
    for args in launches:
        kernels.launch("opt_update", *args)
    count("opt_fused")
    return params, state


def _on_cuda(tree) -> bool:
    while isinstance(tree, dict):
        tree = tree[min(tree)]
    return tree.is_cuda


@torch.no_grad()
def opt_update_plain(spec: OptimizerSpec, params, grads, state, lr: float,
                     frozen=None, step_valid: Optional[torch.Tensor] = None):
    """The plain version of the step (after any clipping): one eager chain
    of PyTorch ops per leaf, in place; returns (params, state)."""
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


# ------------------------------------------------ the fused kernel's table --

# csrc/opt_update.cu: a block owns OPT_TILE elements of one (leaf, client)
# segment; a launch's table holds at most OPT_MAX_LEAVES leaves.
OPT_TILE, OPT_MAX_LEAVES = 4096, 48
_RULES = {"AdamW": 0, "Adam": 1, "SGD": 2}
_MOMENTS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a launch's table: a row per leaf of (p, g, m, v, t, per-client size,
# tiles, first block, vec); the gradients' column changes every step
_G = 1


def plan_opt_segments(numels: Sequence[int], n: int,
                      frozen: Optional[Sequence[bool]] = None
                      ) -> List[List[Tuple[int, int, int, bool]]]:
    """The fused update's launches for leaves of ``numels`` elements a
    client, stacked over ``n`` clients; ``frozen`` (a bool a leaf) leaves
    some out, as do empty leaves.  Each launch is a list of rows ``(leaf,
    tiles, first, vec)``: client c of leaf ``leaf`` owns blocks ``first +
    c * tiles`` to ``first + (c + 1) * tiles - 1``, and tile k of them its
    elements ``[k * OPT_TILE, min((k + 1) * OPT_TILE, numel))``; a block
    finds its row by binary search over ``first``.  ``vec``: the segments
    may move in 16-byte vectors (the per-client size a multiple of 4; the
    kernel checks the addresses too); a segment without it takes the
    scalar path."""
    launches, rows, first = [], [], 0
    for i, e in enumerate(numels):
        if (frozen is not None and frozen[i]) or e == 0:
            continue
        if len(rows) == OPT_MAX_LEAVES:
            launches.append(rows)
            rows, first = [], 0
        tiles = -(-e // OPT_TILE)
        rows.append((i, tiles, first, e % 4 == 0))
        first += n * tiles
    if rows:
        launches.append(rows)
    return launches


# the launches' tables by the leaves they point to (see _tables)
_TABLES: Dict[tuple, tuple] = {}


def _tables(spec: OptimizerSpec, paths, ps, ms, vs, ts):
    """The group's launch tables, checked and packed once: keyed by the
    identities of the tensors they point to (held as weak references, so a
    new tensor under a reused id misses), which this program never
    re-points, re-types or reshapes in place."""
    leaves = [t for t in (*ps, *ms, *vs, *ts) if t is not None]
    key = (spec.name, spec.moment_dtype, tuple(map(id, leaves)))
    hit = _TABLES.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], leaves)):
        return hit[1]
    dev, n = ps[0].device, ps[0].shape[0]
    mdt = torch.float32 if spec.name == "SGD" else _MOMENTS[spec.moment_dtype]
    for path, p, m, v, t in zip(paths, ps, ms, vs, ts):
        name = "/".join(path)
        kernels.check(p, f"parameter {name}", (n,) + tuple(p.shape[1:]),
                      torch.float32, dev)
        kernels.check(m, f"moment of {name}", p.shape, mdt, dev)
        if v is not None:
            kernels.check(v, f"second moment of {name}", p.shape, mdt, dev)
        kernels.check(t, f"step counter of {name}", (n,), torch.int32, dev)
    numels = [p.numel() // n for p in ps]
    out = []
    for rows in plan_opt_segments(numels, n):
        table = np.zeros((len(rows), 9), np.int64)
        for r, (i, tiles, first, vec) in enumerate(rows):
            table[r] = (ps[i].data_ptr(), 0, ms[i].data_ptr(),
                        0 if vs[i] is None else vs[i].data_ptr(),
                        ts[i].data_ptr(), numels[i], tiles, first, vec)
        out.append((table, [i for i, *_ in rows]))
    if len(_TABLES) >= 64:
        _TABLES.clear()
    _TABLES[key] = ([weakref.ref(t) for t in leaves], out)
    return out


def opt_launches(spec: OptimizerSpec, params, grads, state, lr: float,
                 frozen=None, step_valid: Optional[torch.Tensor] = None):
    """``(launches, grads)``: the arguments of each ``fc_opt_update`` call
    of one step (one call up to OPT_MAX_LEAVES leaves), and the gradients
    they point to.  Parameters must be contiguous float32, moments
    contiguous in the spec's moment dtype (SGD's buffer float32), counters
    int32 ``[n]``, all on one device; a gradient is cast to float32 and
    made contiguous (no-ops for autograd's own)."""
    if spec.name not in _RULES:
        raise ValueError(spec.name)
    sgd = spec.name == "SGD"
    paths, ps = [], []
    for path, p in _flat(params):
        if frozen is None or not _get(frozen, path):
            paths.append(path)
            ps.append(p)
    ms = [_get(state["b" if sgd else "m"], path) for path in paths]
    vs = [None if sgd else _get(state["v"], path) for path in paths]
    ts = [_get(state["t"], path) for path in paths]
    tables = _tables(spec, paths, ps, ms, vs, ts) if ps else []
    gs = []
    for path, p in zip(paths, ps):
        g = _get(grads, path).float().contiguous()
        if g.shape != p.shape or g.device != p.device:
            raise ValueError(f"gradient of {'/'.join(path)}: "
                             f"{tuple(g.shape)} on {g.device}, expected "
                             f"{tuple(p.shape)} on {p.device}")
        gs.append(g)
    n = ps[0].shape[0] if ps else 0
    sv, sv_stride = None, 0
    if step_valid is not None and ps:
        if step_valid.dtype != torch.bool or tuple(step_valid.shape) != (n,) \
                or step_valid.device != ps[0].device:
            raise ValueError(f"step_valid must be bool ({n},) on "
                             f"{ps[0].device}, not {step_valid.dtype} "
                             f"{tuple(step_valid.shape)} on "
                             f"{step_valid.device}")
        sv, sv_stride = step_valid.data_ptr(), step_valid.stride(0)
    scalars = [lr, spec.beta1, 1 - spec.beta1, spec.beta2, 1 - spec.beta2,
               spec.eps, spec.weight_decay, 1 - lr * spec.weight_decay,
               spec.momentum]
    out = []
    for table, leaves in tables:
        table[:, _G] = [gs[i].data_ptr() for i in leaves]
        out.append([_RULES[spec.name],
                    int(not sgd and spec.moment_dtype == "bfloat16"),
                    len(leaves), n, table.ctypes.data, sv, sv_stride,
                    *scalars, int(spec.nesterov)])
    return out, gs
