"""Fused MLP: ``fc2(GELU(fc1(h)))`` with exact-erf GELU, over stacked
clients.  Counterpart of both kernel families of
``fedcola_tpu/ops/fused_mlp.py``; every wrapper has its plain PyTorch
version beside it.

Item mode (the training and eval path of ``models/mat.py``), the sublayer
``[x + s*] mlp(LN2(x))`` over x ``[n, B, N, D]``:

* :func:`mlp_fwd` — kernel ``csrc/mlp_fwd.cu`` ``fc_mlp_fwd`` (replaces
  ``_make_ln_item_fwd_kernel``; ``s=None`` is its residual=False eval
  variant); in bfloat16 with D and F multiples of 8 (:func:`uses_sm90`)
  fc1 and fc2 run on the TMA + wgmma mainloop, the GELU and the residual
  join in their epilogues;
* :func:`mlp_bwd` — kernel ``csrc/mlp_bwd.cu`` (replaces
  ``_make_ln_item_bwd_kernel``: ``fc_mlp_bwd`` with residual=True;
  ``s=None`` launches ``fc_mlp_bwd_nores``, its residual=False variant,
  the backward of ``fused_mlp_sublayer_items`` under the remat policies);
* the autograd functions :func:`fused_mlp_residual_sublayer_items` and
  :func:`fused_mlp_sublayer_items`, named as in the JAX package.

Rows mode (only the public functions :func:`fused_mlp` and
:func:`fused_mlp_sublayer` reach it; ``models/mat.py`` does not, as in the
JAX package), over flattened rows x ``[n, rows, D]``:

* :func:`mlp_fwd_rows` / :func:`mlp_bwd_rows` — ``fc_mlp_fwd_rows`` /
  ``fc_mlp_bwd_rows``, ``fc2(GELU(fc1 x))`` without LN (replace
  ``_fwd_kernel`` / ``_bwd_kernel``);
* :func:`mlp_ln_fwd_rows` / :func:`mlp_ln_bwd_rows` —
  ``fc_mlp_ln_fwd_rows`` / ``fc_mlp_ln_bwd_rows``, the item sublayer's
  function on one item of ``rows`` tokens per client (replace
  ``_ln_fwd_kernel`` / ``_ln_bwd_kernel``).  Unlike the Pallas calls they
  take any number of rows without padding.

Shapes: s ``[n, B]`` f32 or None; lns/lnb ``[n, D]`` f32; w1 ``[n, D, F]``,
b1 ``[n, F]``, w2 ``[n, F, D]``, b2 ``[n, D]`` in x's dtype.  CUDA tensors
launch the kernel or raise; CPU tensors run the plain version, which
rounds at the kernel's points (LN output, the GELU activation, the branch
gradient, dpre) and accumulates in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.ops.fused_attention import _ln, _ln_bwd, _mm, _rows_t_mm
# the split planner of the weight-gradient products, shared with the
# attention backward; its names stay importable from here
from fedcola_tpu_torch.ops.kernels import (H100_SMS, SM90_BM,  # noqa: F401
                                           plan_row_splits)

Tensor = torch.Tensor

_INV_SQRT2 = 0.7071067811865475
_INV_SQRT2PI = 0.3989422804014327


def gelu_exact(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


# ------------------------------------------------------------ plain --------

def _mlp(h, w1, b1, w2, b2) -> Tensor:
    """``fc2(T(GELU(fc1 h)))`` in float32 for h ``[n, B, N, D]`` in T."""
    hid = gelu_exact(_mm(h, w1) + b1.float()[:, None, None, :]).to(h.dtype)
    return _mm(hid, w2) + b2.float()[:, None, None, :]


def _mlp_bwd(h, w1, b1, w2, dos):
    """Gradients of :func:`_mlp` given the branch gradient ``dos`` (in T),
    fc1 recomputed; returns (dh in f32, dw1, db1, dw2, db2)."""
    dt = h.dtype
    pre = _mm(h, w1) + b1.float()[:, None, None, :]
    dhid = _mm(dos, w2.transpose(1, 2))
    cdf = 0.5 * (1.0 + torch.erf(pre * _INV_SQRT2))
    pdf = torch.exp(-0.5 * pre * pre) * _INV_SQRT2PI
    dpre = dhid * (cdf + pre * pdf)
    dprec = dpre.to(dt)
    dw1 = _rows_t_mm(h, dprec)
    db1 = dpre.sum(dim=(1, 2))
    dw2 = _rows_t_mm(gelu_exact(pre).to(dt), dos)
    db2 = dos.float().sum(dim=(1, 2))
    return _mm(dprec, w1.transpose(1, 2)), dw1, db1, dw2, db2


def mlp_fwd_plain(x, s, lns, lnb, w1, b1, w2, b2) -> Tensor:
    dt = x.dtype
    o = _mlp(_ln(x, lns, lnb)[0].to(dt), w1, b1, w2, b2)
    if s is not None:
        o = x.float() + s[:, :, None, None] * o
    return o.to(dt)


def mlp_bwd_plain(x, s, lns, lnb, w1, b1, w2, do):
    """Returns (dx, dlns, dlnb, dw1, db1, dw2, db2); dx in x's dtype."""
    dt = x.dtype
    hn, xhat, inv = _ln(x, lns, lnb)
    dos = (do.float() * s[:, :, None, None] if s is not None
           else do.float()).to(dt)
    dhn, dw1, db1, dw2, db2 = _mlp_bwd(hn.to(dt), w1, b1, w2, dos)
    dx = _ln_bwd(dhn, xhat, inv, lns)
    if s is not None:
        dx = dx + do.float()
    dlns = (dhn * xhat).sum(dim=(1, 2))
    dlnb = dhn.sum(dim=(1, 2))
    return dx.to(dt), dlns, dlnb, dw1, db1, dw2, db2


def mlp_fwd_rows_plain(x, w1, b1, w2, b2) -> Tensor:
    """Rows mode without LN (``_fwd_math``), x ``[n, rows, D]``."""
    return _mlp(x[:, None], w1, b1, w2, b2)[:, 0].to(x.dtype)


def mlp_bwd_rows_plain(x, w1, b1, w2, do):
    """``_bwd_math``: returns (dx, dw1, db1, dw2, db2); dx is
    ``dpre_c . W1^T`` accumulated in f32 and rounded to x's dtype once."""
    dx, dw1, db1, dw2, db2 = _mlp_bwd(x[:, None], w1, b1, w2,
                                      do[:, None].to(x.dtype))
    return dx[:, 0].to(x.dtype), dw1, db1, dw2, db2


def mlp_ln_fwd_rows_plain(x, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """Rows mode with LN: the item sublayer on a ``[n, 1, rows, D]`` view."""
    return mlp_fwd_plain(x[:, None], None, lns, lnb, w1, b1, w2, b2)[:, 0]


def mlp_ln_bwd_rows_plain(x, lns, lnb, w1, b1, w2, do):
    dx, *grads = mlp_bwd_plain(x[:, None], None, lns, lnb, w1, b1, w2,
                               do[:, None])
    return (dx[:, 0], *grads)


# ---------------------------------------------------------- wrappers -------

def _check_args(x, s, lns, lnb, w1, b1, w2, b2):
    """x ``[n, B, N, D]`` (the rows entry points pass ``[n, 1, rows, D]``);
    ``lns is None`` for the rows mode without LN."""
    n, B, N, D = x.shape
    F = w1.shape[-1]
    if lns is not None and D > 1024:
        raise NotImplementedError(f"fused MLP kernel takes D <= 1024, got {D}")
    dt, dev = x.dtype, x.device
    kernels.check(x, "x", (n, B, N, D), dt, dev)
    if s is not None:
        kernels.check(s, "s", (n, B), torch.float32, dev)
    if lns is not None:
        kernels.check(lns, "lns", (n, D), torch.float32, dev)
        kernels.check(lnb, "lnb", (n, D), torch.float32, dev)
    kernels.check(w1, "w1", (n, D, F), dt, dev)
    kernels.check(b1, "b1", (n, F), dt, dev)
    kernels.check(w2, "w2", (n, F, D), dt, dev)
    if b2 is not None:
        kernels.check(b2, "b2", (n, D), dt, dev)
    return n, B, N, D, F


def _fwd_scratch(x, F, ln):
    """Forward scratch in entry-point order: [h, mean, rstd,] hid."""
    hid = torch.empty(x.shape[:-1] + (F,), dtype=x.dtype, device=x.device)
    if not ln:
        return [hid]
    mean = torch.empty((x.numel() // x.shape[-1],), dtype=torch.float32,
                       device=x.device)
    return [torch.empty_like(x), mean, torch.empty_like(mean), hid]


def uses_sm90(dtype, D: int, F: int) -> bool:
    """The choice every forward and backward entry point makes
    (``csrc/mlp_fwd.cu``, ``csrc/mlp_bwd.cu``): bf16 with D and F multiples
    of 8 (TMA's 16-byte row strides) runs the Hopper mainloop; float32, or
    D or F off that grid, runs ``gemm_kernel``."""
    return dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0


def _bwd_buffers(x, F, ln):
    """``(rows_per_split, buffers)``: the backward's outputs and scratch
    in entry-point order, None where the path ``fc_mlp_bwd`` takes (see
    :func:`uses_sm90`) needs none:

        dx, [dlns, dlnb,] dw1, db1, dw2, db2, [h, mean, rstd,] dos,
        pre, dhid, hg, dprec, [dhn,] partial, db1part, wpart

    Parameter gradients are f32.  hg and dprec ([..., F], x's dtype) hold
    T(GELU(pre)) and T(dpre).  The Hopper path keeps pre and dh on chip:
    it takes db1part ``[ceil(M/128), n, F]`` (db1's per-row-tile column
    sums), wpart ``[S, n, D, F]`` (the split weight-gradient partials, when
    S > 1) and partial ``[n, 32, D]`` (the D-wide column sums).  The
    ``gemm_kernel`` path takes pre and dhid ``[..., F]`` in f32 and partial
    ``[n, 32, max(F, D)]``.  M is the rows per client."""
    n, D = x.shape[0], x.shape[-1]
    M = x.numel() // (n * D)
    S, rps = plan_row_splits(M, D, F)
    f32 = dict(dtype=torch.float32, device=x.device)
    hidden = x.shape[:-1] + (F,)
    if uses_sm90(x.dtype, D, F):
        pre = dhid = wpart = None
        db1part = torch.empty((-(-M // SM90_BM), n, F), **f32)
        if S > 1:
            wpart = torch.empty((S, n, D, F), **f32)
        partial = torch.empty((n, 32, D), **f32)
    else:
        pre, dhid = torch.empty(hidden, **f32), torch.empty(hidden, **f32)
        db1part = wpart = None
        partial = torch.empty((n, 32, max(F, D)), **f32)
    hg = torch.empty(hidden, dtype=x.dtype, device=x.device)
    core = [torch.empty_like(x), pre, dhid, hg, torch.empty_like(hg)]
    grads = [torch.empty((n, D, F), **f32), torch.empty((n, F), **f32),
             torch.empty((n, F, D), **f32), torch.empty((n, D), **f32)]
    tail = [partial, db1part, wpart]
    if not ln:
        return rps, [torch.empty_like(x)] + grads + core + tail
    mean = torch.empty((n * M,), **f32)
    return rps, ([torch.empty_like(x), torch.empty((n, D), **f32),
                  torch.empty((n, D), **f32)] + grads
                 + [torch.empty_like(x), mean, torch.empty_like(mean)] + core
                 + [torch.empty(x.shape, **f32)] + tail)


def bwd_launch(x, s, lns, lnb, w1, b1, w2, do):
    """``(entry point, arguments, outputs)`` of one backward launch, the
    stream aside: item mode for x ``[n, B, N, D]`` (``mlp_bwd``, or
    ``mlp_bwd_nores`` when s is None), rows mode for x ``[n, rows, D]``
    (``mlp_ln_bwd_rows``, or ``mlp_bwd_rows`` when lns is None).  The
    outputs are (dx, [dlns, dlnb,] dw1, db1, dw2, db2).  Allocates on x's
    device, so it also runs on CPU tensors."""
    ln = lns is not None
    n, D, F = x.shape[0], x.shape[-1], w1.shape[-1]
    rps, bufs = _bwd_buffers(x, F, ln)
    P_ = kernels.ptr
    code = kernels.dtype_code(x.dtype)
    if x.dim() == 3:
        name = "mlp_ln_bwd_rows" if ln else "mlp_bwd_rows"
        head = [code, n, x.shape[1], D, F, rps, P_(x)]
    else:
        name = "mlp_bwd" if s is not None else "mlp_bwd_nores"
        head = [code, n, x.shape[1], x.shape[2], D, F, rps, P_(x)]
        if s is not None:
            head.append(P_(s))
    ptrs = ([lns, lnb] if ln else []) + [w1, b1, w2, do] + bufs
    return name, head + [P_(t) for t in ptrs], tuple(bufs[:7 if ln else 5])


def fwd_launch(x, s, lns, lnb, w1, b1, w2, b2):
    """``(entry point, arguments, output)`` of one forward launch, the
    stream aside: item mode for x ``[n, B, N, D]`` (``mlp_fwd``; s may be
    None), rows mode for x ``[n, rows, D]`` (``mlp_ln_fwd_rows``, or
    ``mlp_fwd_rows`` when lns is None).  Both paths of the entry points
    (see :func:`uses_sm90`) take the same scratch: [h, mean, rstd,] and the
    hidden activation ``[..., F]`` in x's dtype.  Allocates on x's device,
    so it also runs on CPU tensors."""
    ln = lns is not None
    n, D, F = x.shape[0], x.shape[-1], w1.shape[-1]
    P_ = kernels.ptr
    head = [kernels.dtype_code(x.dtype), n, *x.shape[1:-1], D, F, P_(x)]
    if x.dim() == 3:
        name = "mlp_ln_fwd_rows" if ln else "mlp_fwd_rows"
    else:
        if not ln:
            raise ValueError("the item sublayer takes LN parameters")
        name = "mlp_fwd"
        head.append(P_(s))
    out = torch.empty_like(x)
    ptrs = ([lns, lnb] if ln else []) + [w1, b1, w2, b2, out] \
        + _fwd_scratch(x, F, ln)
    return name, head + [P_(t) for t in ptrs], out


def mlp_fwd(x: Tensor, s: Optional[Tensor], lns, lnb, w1, b1, w2,
            b2) -> Tensor:
    """Kernel 3: ``[x + s*] mlp(LN2(x))``."""
    if not x.is_cuda:
        return mlp_fwd_plain(x, s, lns, lnb, w1, b1, w2, b2)
    _check_args(x, s, lns, lnb, w1, b1, w2, b2)
    name, args, out = fwd_launch(x, s, lns, lnb, w1, b1, w2, b2)
    kernels.launch(name, *args)
    return out


def mlp_bwd(x, s, lns, lnb, w1, b1, w2, do):
    """Kernel 4 (kernel 6 when ``s`` is None): gradients of ``[x + s*]
    mlp(LN2(x))``; returns (dx, dlns, dlnb, dw1, db1, dw2, db2)."""
    if not x.is_cuda:
        return mlp_bwd_plain(x, s, lns, lnb, w1, b1, w2, do)
    n, B, N, D, F = _check_args(x, s, lns, lnb, w1, b1, w2, None)
    kernels.check(do, "do", (n, B, N, D), x.dtype, x.device)
    name, args, outs = bwd_launch(x, s, lns, lnb, w1, b1, w2, do)
    kernels.launch(name, *args)
    return outs


def mlp_fwd_rows(x: Tensor, w1, b1, w2, b2) -> Tensor:
    """Row 7: ``fc2(GELU(fc1 x))`` over x ``[n, rows, D]``."""
    if not x.is_cuda:
        return mlp_fwd_rows_plain(x, w1, b1, w2, b2)
    _check_args(x[:, None], None, None, None, w1, b1, w2, b2)
    name, args, out = fwd_launch(x, None, None, None, w1, b1, w2, b2)
    kernels.launch(name, *args)
    return out


def mlp_bwd_rows(x, w1, b1, w2, do):
    """Row 8: gradients of row 7; returns (dx, dw1, db1, dw2, db2)."""
    if not x.is_cuda:
        return mlp_bwd_rows_plain(x, w1, b1, w2, do)
    n, _, R, D, F = _check_args(x[:, None], None, None, None, w1, b1, w2,
                                None)
    kernels.check(do, "do", (n, R, D), x.dtype, x.device)
    name, args, outs = bwd_launch(x, None, None, None, w1, b1, w2, do)
    kernels.launch(name, *args)
    return outs


def mlp_ln_fwd_rows(x: Tensor, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """Row 9: ``fc2(GELU(fc1(LN x)))`` over x ``[n, rows, D]``."""
    if not x.is_cuda:
        return mlp_ln_fwd_rows_plain(x, lns, lnb, w1, b1, w2, b2)
    _check_args(x[:, None], None, lns, lnb, w1, b1, w2, b2)
    name, args, out = fwd_launch(x, None, lns, lnb, w1, b1, w2, b2)
    kernels.launch(name, *args)
    return out


def mlp_ln_bwd_rows(x, lns, lnb, w1, b1, w2, do):
    """Row 10: gradients of row 9; returns (dx, dlns, dlnb, dw1, db1, dw2,
    db2)."""
    if not x.is_cuda:
        return mlp_ln_bwd_rows_plain(x, lns, lnb, w1, b1, w2, do)
    n, _, R, D, F = _check_args(x[:, None], None, lns, lnb, w1, b1, w2, None)
    kernels.check(do, "do", (n, R, D), x.dtype, x.device)
    name, args, outs = bwd_launch(x, None, lns, lnb, w1, b1, w2, do)
    kernels.launch(name, *args)
    return outs


# ---------------------------------------------------------- autograd -------

class FusedMLPResidualItems(torch.autograd.Function):
    """``x + s * mlp(x)``: forward kernel 3, backward kernel 4 (which
    recomputes LN2, fc1 and GELU from x, so only the inputs are saved)."""

    @staticmethod
    def forward(ctx, x, s, lns, lnb, w1, b1, w2, b2):
        ctx.save_for_backward(x, s, lns, lnb, w1, b1, w2, b2)
        return mlp_fwd(x, s, lns, lnb, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x, s, lns, lnb, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dlns, dlnb, dw1, db1, dw2, db2 = mlp_bwd(
            x, s, lns, lnb, w1, b1, w2, dout.contiguous())
        return (dx, torch.zeros_like(s), dlns.to(lns.dtype),
                dlnb.to(lnb.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype))


def fused_mlp_residual_sublayer_items(x, s, lns, lnb, w1, b1, w2,
                                      b2) -> Tensor:
    """Training sublayer: differentiable ``x + s * mlp(x)``."""
    return FusedMLPResidualItems.apply(x, s, lns, lnb, w1, b1, w2, b2)


class FusedMLPItems(torch.autograd.Function):
    """``mlp(x)`` without residual: forward kernel 3 with ``s=None``,
    backward kernel 6."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2):
        ctx.save_for_backward(x, lns, lnb, w1, b1, w2, b2)
        return mlp_fwd(x, None, lns, lnb, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        x, lns, lnb, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dlns, dlnb, dw1, db1, dw2, db2 = mlp_bwd(
            x, None, lns, lnb, w1, b1, w2, dout.contiguous())
        return (dx, dlns.to(lns.dtype), dlnb.to(lnb.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def fused_mlp_sublayer_items(x, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """Sublayer ``mlp(x)`` (eval, and training under the remat policies):
    kernel 3 without the residual; differentiable through kernel 6."""
    return FusedMLPItems.apply(x, lns, lnb, w1, b1, w2, b2)


def _as_kernel_args(x, ln, w):
    """Cast as the Pallas kernels do: weights to x's dtype, LN parameters
    to float32; all contiguous."""
    return ([x.contiguous()] + [p.float().contiguous() for p in ln]
            + [p.to(x.dtype).contiguous() for p in w])


class FusedMLPRows(torch.autograd.Function):
    """Rows 7 and 8: forward ``mlp_fwd_rows``, backward ``mlp_bwd_rows``
    (which recomputes fc1, so only the inputs are saved).  Gradients come
    back in each parameter's dtype, as the JAX ``_vjp_bwd`` returns them."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return mlp_fwd_rows(*_as_kernel_args(x, (), (w1, b1, w2, b2)))

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        args = _as_kernel_args(x, (), (w1, b1, w2, dout))
        dx, dw1, db1, dw2, db2 = mlp_bwd_rows(*args)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype))


class FusedMLPSublayerRows(torch.autograd.Function):
    """Rows 9 and 10: forward ``mlp_ln_fwd_rows``, backward
    ``mlp_ln_bwd_rows`` (LN and fc1 recomputed)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2):
        ctx.save_for_backward(x, lns, lnb, w1, b1, w2, b2)
        return mlp_ln_fwd_rows(*_as_kernel_args(x, (lns, lnb),
                                                (w1, b1, w2, b2)))

    @staticmethod
    def backward(ctx, dout):
        x, lns, lnb, w1, b1, w2, b2 = ctx.saved_tensors
        args = _as_kernel_args(x, (lns, lnb), (w1, b1, w2, dout))
        dx, dlns, dlnb, dw1, db1, dw2, db2 = mlp_ln_bwd_rows(*args)
        return (dx, dlns.to(lns.dtype), dlnb.to(lnb.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def _rows_apply(fn, x, *params):
    """The JAX signature (x ``[rows, D]``, unstacked parameters) or the
    client-stacked form that ``jax.vmap`` over it gives (x ``[n, rows, D]``,
    every parameter with a leading ``n``)."""
    if x.dim() == 2:
        return fn.apply(x[None], *(p[None] for p in params))[0]
    return fn.apply(x, *params)


def fused_mlp(x, w1, b1, w2, b2) -> Tensor:
    """``fc2(GELU(fc1 x))`` over rows, differentiable (rows 7 and 8)."""
    return _rows_apply(FusedMLPRows, x, w1, b1, w2, b2)


def fused_mlp_sublayer(x, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """``fc2(GELU(fc1(LN x)))`` over rows, LN eps 1e-5, differentiable
    (rows 9 and 10)."""
    return _rows_apply(FusedMLPSublayerRows, x, lns, lnb, w1, b1, w2, b2)
