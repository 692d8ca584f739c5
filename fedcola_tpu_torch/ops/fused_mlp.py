"""Fused MLP sublayer: ``[x + s*] (GELU(LN2(x) W1 + b1) W2 + b2)`` over
stacked clients, exact-erf GELU.

Counterpart of the item-mode kernels of ``fedcola_tpu/ops/fused_mlp.py``.
Two wrappers, one per TPU kernel of the training path, each with its plain
PyTorch version:

* :func:`mlp_fwd` — kernel ``csrc/mlp_fwd.cu`` (replaces
  ``_make_ln_item_fwd_kernel``; ``s=None`` is its residual=False eval
  variant);
* :func:`mlp_bwd` — kernel ``csrc/mlp_bwd.cu`` (replaces
  ``_make_ln_item_bwd_kernel``: ``fc_mlp_bwd`` with residual=True;
  ``s=None`` launches ``fc_mlp_bwd_nores``, its residual=False variant,
  the backward of ``fused_mlp_sublayer_items`` under the remat policies).

Shapes: x ``[n, B, N, D]``; s ``[n, B]`` f32 or None; lns/lnb ``[n, D]``
f32; w1 ``[n, D, F]``, b1 ``[n, F]``, w2 ``[n, F, D]``, b2 ``[n, D]`` in
x's dtype.  CUDA tensors launch the kernel or raise; CPU tensors run the
plain version, which rounds at the kernel's points (LN output, the GELU
activation, the branch gradient, dpre) and accumulates in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.ops.fused_attention import _ln, _ln_bwd, _mm, _rows_t_mm

Tensor = torch.Tensor

_INV_SQRT2 = 0.7071067811865475
_INV_SQRT2PI = 0.3989422804014327


def gelu_exact(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


# ------------------------------------------------------------ plain --------

def mlp_fwd_plain(x, s, lns, lnb, w1, b1, w2, b2) -> Tensor:
    dt = x.dtype
    h = _ln(x, lns, lnb)[0].to(dt)
    hid = gelu_exact(_mm(h, w1) + b1.float()[:, None, None, :]).to(dt)
    o = _mm(hid, w2) + b2.float()[:, None, None, :]
    if s is not None:
        o = x.float() + s[:, :, None, None] * o
    return o.to(dt)


def mlp_bwd_plain(x, s, lns, lnb, w1, b1, w2, do):
    """Returns (dx, dlns, dlnb, dw1, db1, dw2, db2); dx in x's dtype."""
    dt = x.dtype
    hn, xhat, inv = _ln(x, lns, lnb)
    h = hn.to(dt)
    dos = (do.float() * s[:, :, None, None] if s is not None
           else do.float()).to(dt)
    pre = _mm(h, w1) + b1.float()[:, None, None, :]
    dh = _mm(dos, w2.transpose(1, 2))
    cdf = 0.5 * (1.0 + torch.erf(pre * _INV_SQRT2))
    pdf = torch.exp(-0.5 * pre * pre) * _INV_SQRT2PI
    dpre = dh * (cdf + pre * pdf)
    dprec = dpre.to(dt)
    dw1 = _rows_t_mm(h, dprec)
    db1 = dpre.sum(dim=(1, 2))
    dw2 = _rows_t_mm(gelu_exact(pre).to(dt), dos)
    db2 = dos.float().sum(dim=(1, 2))
    dhn = _mm(dprec, w1.transpose(1, 2))
    dx = _ln_bwd(dhn, xhat, inv, lns)
    if s is not None:
        dx = dx + do.float()
    dlns = (dhn * xhat).sum(dim=(1, 2))
    dlnb = dhn.sum(dim=(1, 2))
    return dx.to(dt), dlns, dlnb, dw1, db1, dw2, db2


# ---------------------------------------------------------- wrappers -------

def _check_args(x, s, lns, lnb, w1, b1, w2, b2):
    n, B, N, D = x.shape
    F = w1.shape[-1]
    if D > 1024:
        raise NotImplementedError(f"fused MLP kernel takes D <= 1024, got {D}")
    dt, dev = x.dtype, x.device
    kernels.check(x, "x", (n, B, N, D), dt, dev)
    if s is not None:
        kernels.check(s, "s", (n, B), torch.float32, dev)
    kernels.check(lns, "lns", (n, D), torch.float32, dev)
    kernels.check(lnb, "lnb", (n, D), torch.float32, dev)
    kernels.check(w1, "w1", (n, D, F), dt, dev)
    kernels.check(b1, "b1", (n, F), dt, dev)
    kernels.check(w2, "w2", (n, F, D), dt, dev)
    if b2 is not None:
        kernels.check(b2, "b2", (n, D), dt, dev)
    return n, B, N, D, F


def mlp_fwd(x: Tensor, s: Optional[Tensor], lns, lnb, w1, b1, w2,
            b2) -> Tensor:
    """Kernel 3: ``[x + s*] mlp(LN2(x))``."""
    if not x.is_cuda:
        return mlp_fwd_plain(x, s, lns, lnb, w1, b1, w2, b2)
    n, B, N, D, F = _check_args(x, s, lns, lnb, w1, b1, w2, b2)
    dev = x.device
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    mean = torch.empty((n * B * N,), dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    hid = torch.empty((n, B, N, F), dtype=x.dtype, device=dev)
    P_ = kernels.ptr
    kernels.launch("mlp_fwd", kernels.dtype_code(x.dtype), n, B, N, D, F,
                   P_(x), P_(s), P_(lns), P_(lnb), P_(w1), P_(b1), P_(w2),
                   P_(b2), P_(out), P_(h), P_(mean), P_(rstd), P_(hid))
    return out


def mlp_bwd(x, s, lns, lnb, w1, b1, w2, do):
    """Kernel 4 (kernel 6 when ``s`` is None): gradients of ``[x + s*]
    mlp(LN2(x))``; returns (dx, dlns, dlnb, dw1, db1, dw2, db2)."""
    if not x.is_cuda:
        return mlp_bwd_plain(x, s, lns, lnb, w1, b1, w2, do)
    n, B, N, D, F = _check_args(x, s, lns, lnb, w1, b1, w2, None)
    dt, dev = x.dtype, x.device
    kernels.check(do, "do", (n, B, N, D), dt, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dlns = torch.empty((n, D), **f32)
    dlnb = torch.empty((n, D), **f32)
    dw1 = torch.empty((n, D, F), **f32)
    db1 = torch.empty((n, F), **f32)
    dw2 = torch.empty((n, F, D), **f32)
    db2 = torch.empty((n, D), **f32)
    h = torch.empty_like(x)
    mean = torch.empty((n * B * N,), **f32)
    rstd = torch.empty_like(mean)
    dos = torch.empty_like(x)
    pre = torch.empty((n, B, N, F), **f32)
    dhid = torch.empty_like(pre)
    hg = torch.empty((n, B, N, F), dtype=dt, device=dev)
    dprec = torch.empty_like(hg)
    dhn = torch.empty((n, B, N, D), **f32)
    partial = torch.empty((n, 32, max(F, D)), **f32)
    P_ = kernels.ptr
    head = (("mlp_bwd", kernels.dtype_code(dt), n, B, N, D, F, P_(x), P_(s))
            if s is not None else
            ("mlp_bwd_nores", kernels.dtype_code(dt), n, B, N, D, F, P_(x)))
    kernels.launch(*head, P_(lns), P_(lnb), P_(w1), P_(b1), P_(w2),
                   P_(do), P_(dx), P_(dlns), P_(dlnb), P_(dw1), P_(db1),
                   P_(dw2), P_(db2), P_(h), P_(mean), P_(rstd), P_(dos),
                   P_(pre), P_(dhid), P_(hg), P_(dprec), P_(dhn),
                   P_(partial))
    return dx, dlns, dlnb, dw1, db1, dw2, db2


# ---------------------------------------------------------- autograd -------

class FusedMLPResidual(torch.autograd.Function):
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


def fused_mlp_residual(x, s, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """Training sublayer: differentiable ``x + s * mlp(x)``."""
    return FusedMLPResidual.apply(x, s, lns, lnb, w1, b1, w2, b2)


class FusedMLP(torch.autograd.Function):
    """``mlp(x)`` without residual (``fused_mlp_sublayer_items``): forward
    kernel 3 with ``s=None``, backward kernel 6."""

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


def fused_mlp(x, lns, lnb, w1, b1, w2, b2) -> Tensor:
    """Sublayer ``mlp(x)`` (eval, and training under the remat policies):
    kernel 3 without the residual; differentiable through kernel 6."""
    return FusedMLP.apply(x, lns, lnb, w1, b1, w2, b2)
