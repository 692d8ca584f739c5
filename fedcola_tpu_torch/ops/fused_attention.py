"""Fused attention sublayer: ``[x + s*] proj(MHA(LN1(x)))`` over stacked
clients.

Counterpart of ``fedcola_tpu/ops/fused_attention.py``.  Three wrappers,
one per TPU kernel, each with its plain PyTorch version:

* :func:`attn_fwd` — kernel ``csrc/attn_fwd.cu`` (replaces
  ``_make_fwd_save_kernel``; ``save=False, s=None`` is the eval and remat
  variant that replaces ``_make_fwd_kernel``);
* :func:`attn_bwd` — kernel ``csrc/attn_bwd.cu`` (replaces
  ``_make_bwd_save_kernel``);
* :func:`attn_bwd_recompute` — entry ``fc_attn_bwd_recompute`` of
  ``csrc/attn_bwd.cu`` (replaces ``_make_bwd_kernel`` / ``_bwd_one``, the
  backward under the remat policies: no saves, no residual).

Shapes (leading client axis ``n``): x ``[n, B, N, D]``; s ``[n, B]`` f32
(per-sample DropPath scale, None = no residual); lns/lnb ``[n, D]`` f32;
wqkv ``[n, D, 3D]``, bqkv ``[n, 3D]``, wproj ``[n, D, D]``, bproj
``[n, D]`` in x's dtype (float32 or bfloat16).

The wrappers assemble their launches in :func:`fwd_launch` and
:func:`bwd_launch`; in bfloat16 with head_dim 16, 32 or 64
(:func:`uses_sm90`) the entry points run every D-wide product on the TMA +
wgmma mainloop and the per-head forward and backward in one tensor-core
kernel each (``csrc/attn_fwd_core.cuh``, ``csrc/attn_bwd_core.cuh``).
The kernels take every sequence length: past N = 256
(``kernels.streams_keys``) the per-head kernels stream the keys in chunks,
and the Hopper backward then takes a row-statistics scratch and one
column-sum row per 128-query block.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  The plain versions round to x's dtype
at the same points as the kernels (LN output, qkv, P, the head concat, the
branch gradient, dS, dqkv) and accumulate in float32.  The recompute
backward keeps P in float32 for delta and dS and rounds it only for dV, as
``_bwd_one`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fedcola_tpu_torch.ops import kernels

Tensor = torch.Tensor


def _ln(x: Tensor, g: Tensor, b: Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mu) * inv
    return xhat * g[:, None, None, :] + b[:, None, None, :], xhat, inv


def _mm(a: Tensor, w: Tensor) -> Tensor:
    """Per-client product of [n, B, N, K] rows and [n, K, C] weights with
    float32 operands and accumulation."""
    n, B, N, K = a.shape
    return torch.bmm(a.float().reshape(n, B * N, K),
                     w.float()).reshape(n, B, N, -1)


def _rows_t_mm(a: Tensor, b: Tensor) -> Tensor:
    """Per-client sum over all rows: a^T . b for [n, B, N, I], [n, B, N, J]."""
    n = a.shape[0]
    return torch.bmm(a.float().reshape(n, -1, a.shape[-1]).transpose(1, 2),
                     b.float().reshape(n, -1, b.shape[-1]))


def _ln_bwd(dh: Tensor, xhat: Tensor, inv: Tensor, g: Tensor) -> Tensor:
    dg = dh * g[:, None, None, :]
    m1 = dg.mean(-1, keepdim=True)
    m2 = (dg * xhat).mean(-1, keepdim=True)
    return inv * (dg - m1 - xhat * m2)


def _heads(t: Tensor, H: int) -> Tensor:
    """[n, B, N, D] -> [n, B, H, N, hd]."""
    n, B, N, D = t.shape
    return t.reshape(n, B, N, H, D // H).transpose(2, 3)


def _merge(t: Tensor) -> Tensor:
    """[n, B, H, N, hd] -> [n, B, N, H*hd]."""
    n, B, H, N, hd = t.shape
    return t.transpose(2, 3).reshape(n, B, N, H * hd)


def _qkv(x, lns, lnb, wqkv, bqkv):
    dt = x.dtype
    hn, xhat, inv = _ln(x, lns, lnb)
    h = hn.to(dt)
    qkv = (_mm(h, wqkv) + bqkv.float()[:, None, None, :]).to(dt)
    return h, xhat, inv, qkv


# ------------------------------------------------------------ plain --------

def _probs(qkv: Tensor, num_heads: int) -> Tensor:
    """float32 softmax of the scaled float32 scores, ``[n, B, H, N, N]``."""
    D = qkv.shape[-1] // 3
    q, k, _ = (_heads(t, num_heads).float() for t in qkv.split(D, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (D // num_heads) ** -0.5
    return torch.softmax(scores, dim=-1)


def _cat(p: Tensor, qkv: Tensor) -> Tensor:
    """Head concat ``T(P.V)`` from P in x's dtype."""
    D = qkv.shape[-1] // 3
    v = _heads(qkv[..., 2 * D:], p.shape[2]).float()
    return _merge(torch.matmul(p.float(), v)).to(qkv.dtype)


def attn_fwd_plain(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads: int,
                   save: bool = True):
    """Plain version of :func:`attn_fwd`: returns (out, P, cat)."""
    dt = x.dtype
    _, _, _, qkv = _qkv(x, lns, lnb, wqkv, bqkv)
    p = _probs(qkv, num_heads).to(dt)
    cat = _cat(p, qkv)
    a = _mm(cat, wproj) + bproj.float()[:, None, None, :]
    if s is not None:
        a = x.float() + s[:, :, None, None] * a
    return a.to(dt), (p if save else None), cat


def attn_bwd_plain(x, s, lns, lnb, wqkv, bqkv, wproj, P, cat, da,
                   num_heads: int):
    """Plain version of :func:`attn_bwd`: returns (dx, dlns, dlnb, dwqkv,
    dbqkv, dwproj, dbproj); dx in x's dtype, the rest float32."""
    pf = P.float()
    return _attn_bwd(x, s, lns, wqkv, _qkv(x, lns, lnb, wqkv, bqkv), wproj,
                     pf, pf, cat, da, num_heads)


def attn_bwd_recompute_plain(x, lns, lnb, wqkv, bqkv, wproj, da,
                             num_heads: int):
    """Plain version of :func:`attn_bwd_recompute` (``_bwd_one``): P, the
    head concat and everything before them recomputed from x; P stays
    float32 for delta and dS and is rounded to x's dtype for dV and cat."""
    fwd = _qkv(x, lns, lnb, wqkv, bqkv)
    p32 = _probs(fwd[3], num_heads)
    pt = p32.to(x.dtype)
    return _attn_bwd(x, None, lns, wqkv, fwd, wproj, pt.float(), p32,
                     _cat(pt, fwd[3]), da, num_heads)


def _attn_bwd(x, s, lns, wqkv, fwd, wproj, p_dv, p_ds, cat, da,
              num_heads: int):
    """The sublayer backward given P for dV (``p_dv``) and for the softmax
    gradient (``p_ds``), both float32."""
    dt = x.dtype
    D = x.shape[-1]
    H = num_heads
    scale = (D // H) ** -0.5
    h, xhat, inv, qkv = fwd
    das = da.float() * s[:, :, None, None] if s is not None else da.float()
    dac = das.to(dt)
    dwproj = _rows_t_mm(cat, dac)
    dbproj = das.sum(dim=(1, 2))
    do = _heads(_mm(dac, wproj.transpose(1, 2)).to(dt), H).float()
    q, k, v = (_heads(t, H).float() for t in qkv.split(D, dim=-1))
    dv = torch.matmul(p_dv.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (dp * p_ds).sum(-1, keepdim=True)
    ds = (p_ds * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    dqkvc = dqkv.to(dt)
    dbqkv = dqkv.sum(dim=(1, 2))
    dwqkv = _rows_t_mm(h, dqkvc)
    dh = _mm(dqkvc, wqkv.transpose(1, 2))
    dx = _ln_bwd(dh, xhat, inv, lns)
    if s is not None:
        dx = dx + da.float()
    dlns = (dh * xhat).sum(dim=(1, 2))
    dlnb = dh.sum(dim=(1, 2))
    return dx.to(dt), dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj


# ---------------------------------------------------------- wrappers -------

def _check_fwd_args(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads):
    n, B, N, D = x.shape
    if D % num_heads or D // num_heads > 64 or D > 1024:
        raise NotImplementedError(
            f"fused attention kernel takes head_dim <= 64 and D <= 1024 "
            f"(got D={D}, H={num_heads}, N={N})")
    dt, dev = x.dtype, x.device
    kernels.check(x, "x", (n, B, N, D), dt, dev)
    if s is not None:
        kernels.check(s, "s", (n, B), torch.float32, dev)
    kernels.check(lns, "lns", (n, D), torch.float32, dev)
    kernels.check(lnb, "lnb", (n, D), torch.float32, dev)
    kernels.check(wqkv, "wqkv", (n, D, 3 * D), dt, dev)
    kernels.check(bqkv, "bqkv", (n, 3 * D), dt, dev)
    kernels.check(wproj, "wproj", (n, D, D), dt, dev)
    if bproj is not None:
        kernels.check(bproj, "bproj", (n, D), dt, dev)


def fwd_launch(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads: int,
               save: bool = True):
    """``(entry point, arguments, outputs)`` of one forward launch, the
    stream aside.  The outputs are (out, P, cat), P ``[n, B, H, N, N]``
    only when ``save`` (else None: a null pointer).  Both paths of
    ``fc_attn_fwd`` (see :func:`uses_sm90`) take the same scratch: h, mean,
    rstd and qkv ``[n, B, N, 3D]``.  Allocates on x's device, so it also
    runs on CPU tensors."""
    n, B, N, D = x.shape
    H = num_heads
    dt, dev = x.dtype, x.device
    out = torch.empty_like(x)
    P = torch.empty((n, B, H, N, N), dtype=dt, device=dev) if save else None
    cat = torch.empty_like(x)
    mean = torch.empty((n * B * N,), dtype=torch.float32, device=dev)
    scratch = [torch.empty_like(x), mean, torch.empty_like(mean),
               torch.empty((n, B, N, 3 * D), dtype=dt, device=dev)]
    ptrs = [x, s, lns, lnb, wqkv, bqkv, wproj, bproj, out, P, cat] + scratch
    args = [kernels.dtype_code(dt), n, B, N, D, H] \
        + [kernels.ptr(t) for t in ptrs] + [int(save)]
    return "attn_fwd", args, (out, P, cat)


def attn_fwd(x: Tensor, s: Optional[Tensor], lns, lnb, wqkv, bqkv, wproj,
             bproj, num_heads: int, save: bool = True
             ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Kernel 1: ``out = [x + s*] attn(x)``, with the softmax probabilities
    P ``[n, B, H, N, N]`` (when ``save``) and the head concat ``cat``."""
    if not x.is_cuda:
        return attn_fwd_plain(x, s, lns, lnb, wqkv, bqkv, wproj, bproj,
                              num_heads, save)
    _check_fwd_args(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads)
    name, args, outs = fwd_launch(x, s, lns, lnb, wqkv, bqkv, wproj, bproj,
                                  num_heads, save)
    kernels.launch(name, *args)
    return outs


def uses_sm90(dtype, D: int, num_heads: int, N: int) -> bool:
    """The choice ``fc_attn_fwd``, ``fc_attn_bwd`` and
    ``fc_attn_bwd_recompute`` make (``csrc/attn_sm90.cuh``): bf16 with
    head_dim 16, 32 or 64 (the tensor-core head kernels' sizes; D is then on
    TMA's 8-element grid), at every N, runs the Hopper path; float32, or any
    other head_dim, runs ``gemm_kernel`` and the CUDA-core attention core
    and row and column passes.  Either streams the keys past N = 256
    (``kernels.streams_keys``)."""
    return (dtype == torch.bfloat16 and D % 8 == 0
            and D // num_heads in (16, 32, 64))


def _bwd_buffers(x, num_heads: int, recompute: bool):
    """``((rps_proj, rps_qkv), outputs, scratch)`` of one backward launch.
    Outputs, f32 but dx: dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj.
    Scratch in entry-point order, None where the path taken (see
    :func:`uses_sm90`) needs none:

        h, mean, rstd, qkv, [P, cat,] dac, dO, dS, dqkv, dqkvc, dh,
        partial, stats, hpart, wpart

    (P and cat only when ``recompute``: the other entry point reads them.)
    The Hopper path keeps P and dS on chip and writes dq | dk | dv straight
    as the bf16 dqkvc: it takes hpart ``[n*B*R, 3D]`` (dbqkv's column sums
    per item, R = ``kernels.attn_part_rows(N)``: one, or one per 128-query
    block when the keys stream), wpart (the split weight-gradient partials
    of the larger of dWproj ``[S, n, D, D]`` and dWqkv ``[S, n, D, 3D]``,
    when an S > 1) and, past N = 256, stats ``[n*B, H, N, 3]`` (the streamed
    head kernels' row max, 1 / sum and delta).
    The ``gemm_kernel`` path takes dS (and, recomputing, P) ``[n, B, H, N,
    N]`` in x's dtype and dqkv ``[n, B, N, 3D]`` in f32."""
    n, B, N, D = x.shape
    H = num_heads
    dt, dev = x.dtype, x.device
    f32 = dict(dtype=torch.float32, device=dev)
    plans = (kernels.plan_row_splits(B * N, D, D),
             kernels.plan_row_splits(B * N, D, 3 * D))
    outs = [torch.empty_like(x), torch.empty((n, D), **f32),
            torch.empty((n, D), **f32), torch.empty((n, D, 3 * D), **f32),
            torch.empty((n, 3 * D), **f32), torch.empty((n, D, D), **f32),
            torch.empty((n, D), **f32)]
    mean = torch.empty((n * B * N,), **f32)
    qkv = torch.empty((n, B, N, 3 * D), dtype=dt, device=dev)
    stats = None
    if uses_sm90(dt, D, H, N):
        P = dS = dqkv = wpart = None
        hpart = torch.empty((n * B * kernels.attn_part_rows(N), 3 * D), **f32)
        if kernels.streams_keys(N):
            stats = torch.empty((n * B, H, N, 3), **f32)
        part = max(S * cols if S > 1 else 0
                   for (S, _), cols in zip(plans, (D, 3 * D)))
        if part:
            wpart = torch.empty((part * n * D,), **f32)
    else:
        P = torch.empty((n, B, H, N, N), dtype=dt, device=dev)
        dS = torch.empty_like(P)
        dqkv = torch.empty((n, B, N, 3 * D), **f32)
        hpart = wpart = None
    saves = [P, torch.empty_like(x)] if recompute else []
    scratch = ([torch.empty_like(x), mean, torch.empty_like(mean), qkv]
               + saves + [torch.empty_like(x), torch.empty_like(x), dS, dqkv,
                          torch.empty_like(qkv), torch.empty(x.shape, **f32),
                          torch.empty((n, 32, 3 * D), **f32), stats, hpart,
                          wpart])
    return (plans[0][1], plans[1][1]), outs, scratch


def bwd_launch(x, s, lns, lnb, wqkv, bqkv, wproj, P, cat, da,
               num_heads: int):
    """``(entry point, arguments, outputs)`` of one backward launch, the
    stream aside: ``attn_bwd`` from the saved P and cat, or
    ``attn_bwd_recompute`` when P is None (s and cat are then not passed).
    The outputs are (dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj).
    Allocates on x's device, so it also runs on CPU tensors."""
    recompute = P is None
    n, B, N, D = x.shape
    rps, outs, scratch = _bwd_buffers(x, num_heads, recompute)
    head = [kernels.dtype_code(x.dtype), n, B, N, D, num_heads, *rps]
    if recompute:
        name = "attn_bwd_recompute"
        ptrs = [x, lns, lnb, wqkv, bqkv, wproj, da]
    else:
        name = "attn_bwd"
        ptrs = [x, s, lns, lnb, wqkv, bqkv, wproj, P, cat, da]
    args = head + [kernels.ptr(t) for t in ptrs + outs + scratch]
    return name, args, tuple(outs)


def attn_bwd(x, s, lns, lnb, wqkv, bqkv, wproj, P, cat, da, num_heads: int):
    """Kernel 2: gradients of ``[x + s*] attn(x)`` from the saved P and
    cat; returns (dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj)."""
    if not x.is_cuda:
        return attn_bwd_plain(x, s, lns, lnb, wqkv, bqkv, wproj, P, cat, da,
                              num_heads)
    _check_fwd_args(x, s, lns, lnb, wqkv, bqkv, wproj, None, num_heads)
    n, B, N, D = x.shape
    kernels.check(P, "P", (n, B, num_heads, N, N), x.dtype, x.device)
    kernels.check(cat, "cat", (n, B, N, D), x.dtype, x.device)
    kernels.check(da, "da", (n, B, N, D), x.dtype, x.device)
    name, args, outs = bwd_launch(x, s, lns, lnb, wqkv, bqkv, wproj, P, cat,
                                  da, num_heads)
    kernels.launch(name, *args)
    return outs


def attn_bwd_recompute(x, lns, lnb, wqkv, bqkv, wproj, da, num_heads: int):
    """Kernel 5: gradients of ``attn(x)`` (no residual) recomputing the
    forward from x; returns (dx, dlns, dlnb, dwqkv, dbqkv, dwproj,
    dbproj)."""
    if not x.is_cuda:
        return attn_bwd_recompute_plain(x, lns, lnb, wqkv, bqkv, wproj, da,
                                        num_heads)
    _check_fwd_args(x, None, lns, lnb, wqkv, bqkv, wproj, None, num_heads)
    kernels.check(da, "da", x.shape, x.dtype, x.device)
    name, args, outs = bwd_launch(x, None, lns, lnb, wqkv, bqkv, wproj, None,
                                  None, da, num_heads)
    kernels.launch(name, *args)
    return outs


# ---------------------------------------------------------- autograd -------

class FusedAttentionResidual(torch.autograd.Function):
    """``x + s * attn(x)``: forward is kernel 1 with saves, backward is
    kernel 2.  s (a DropPath draw) gets a zero gradient; dW/db come back
    float32 from the kernel and are cast to the parameter dtype."""

    @staticmethod
    def forward(ctx, x, s, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads):
        out, P, cat = attn_fwd(x, s, lns, lnb, wqkv, bqkv, wproj, bproj,
                               num_heads, save=True)
        ctx.save_for_backward(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, P,
                              cat)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        x, s, lns, lnb, wqkv, bqkv, wproj, bproj, P, cat = ctx.saved_tensors
        dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj = attn_bwd(
            x, s, lns, lnb, wqkv, bqkv, wproj, P, cat,
            dout.contiguous(), ctx.num_heads)
        return (dx, torch.zeros_like(s), dlns.to(lns.dtype),
                dlnb.to(lnb.dtype), dwqkv.to(wqkv.dtype),
                dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
                dbproj.to(bproj.dtype), None)


def fused_attention_residual(x, s, lns, lnb, wqkv, bqkv, wproj, bproj,
                             num_heads: int) -> Tensor:
    """Training sublayer: differentiable ``x + s * attn(x)``."""
    return FusedAttentionResidual.apply(x, s, lns, lnb, wqkv, bqkv, wproj,
                                        bproj, num_heads)


class FusedAttention(torch.autograd.Function):
    """``attn(x)`` without residual: forward is kernel 1 without saves, the
    backward kernel 5 recomputes everything from x, so only the inputs are
    saved (``make_fused_attention_sublayer(save_residuals=False)``)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, wqkv, bqkv, wproj, bproj, num_heads):
        ctx.save_for_backward(x, lns, lnb, wqkv, bqkv, wproj, bproj)
        ctx.num_heads = num_heads
        return attn_fwd(x, None, lns, lnb, wqkv, bqkv, wproj, bproj,
                        num_heads, save=False)[0]

    @staticmethod
    def backward(ctx, da):
        x, lns, lnb, wqkv, bqkv, wproj, bproj = ctx.saved_tensors
        dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj = attn_bwd_recompute(
            x, lns, lnb, wqkv, bqkv, wproj, da.contiguous(), ctx.num_heads)
        return (dx, dlns.to(lns.dtype), dlnb.to(lnb.dtype),
                dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
                dwproj.to(wproj.dtype), dbproj.to(bproj.dtype), None)


def fused_attention(x, lns, lnb, wqkv, bqkv, wproj, bproj,
                    num_heads: int) -> Tensor:
    """Sublayer ``attn(x)`` (eval, and training under the remat policies):
    kernel 1 without saves or residual; differentiable through kernel 5."""
    return FusedAttention.apply(x, lns, lnb, wqkv, bqkv, wproj, bproj,
                                num_heads)
