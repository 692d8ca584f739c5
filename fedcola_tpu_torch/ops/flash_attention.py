"""Flash attention: ``softmax(q k^T * scale) v`` per (batch, head) pair with
f32 scores and softmax, and its backward, which recomputes P.

Counterpart of ``fedcola_tpu/ops/flash_attention.py``.  Two wrappers, one
per TPU kernel, each with its plain PyTorch version:

* :func:`flash_fwd` — kernel ``csrc/flash_fwd.cu`` (replaces ``_fwd_kernel``
  via ``_fa_fwd``);
* :func:`flash_bwd` — kernel ``csrc/flash_bwd.cu`` (replaces
  ``_bwd_kernel`` via ``_fa_bwd``).

q, k, v are ``[..., N, hd]``; every leading axis is merged into one pair
axis, so one launch covers a client-stacked group (``[n, B, H, N, hd]``)
as the JAX package's vmap does.  Rounding points, as ``_fa_fwd`` /
``_fa_bwd`` place them: ``qm = q * scale`` in q's dtype (scale cast to that
dtype first); scores of the upcast operands and softmax in f32; forward P
rounded to v's dtype, P.v accumulated in f32 and stored in q's dtype;
backward P, o, delta and dS in f32, each gradient cast to its input's dtype
and dq then multiplied by scale in q's dtype.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  The kernels take head_dim <= 64 and
every N: up to N = 256 each keeps a pair's keys in shared memory, past it
each streams them in chunks (``kernels.streams_keys``).

The routing rule of the JAX package's ``_fa_fwd`` / ``_fa_bwd`` is kept:
:func:`flash_attention` sends a sequence longer than ``MAX_FUSED_SEQ`` =
1024 to the plain attention ``attention_xla`` (``ops/attention.py``),
forward and backward, decided by N alone before any launch.  The JAX
package also falls back where one pair exceeds its VMEM budget
(``_pick_group`` returning 0); that is a fact about TPU memory, not about
the function, and has no counterpart here: the streamed kernels' shared
memory does not grow with N.

Each entry point chooses in C between two paths
(:func:`uses_tensor_cores` mirrors the choice): bfloat16 at head_dim 16, 32
or 64 runs per-head ``mma.sync`` kernels (``csrc/attn_fwd_core.cuh``,
``csrc/attn_bwd_core.cuh``); float32 and any other head_dim run the
CUDA-core kernels.  The tensor-core forward keeps every rounding point
above; the tensor-core backward hands P and dS on as bfloat16 operands of
the dv, dq and dk products (scores, softmax, delta and the accumulators
stay f32) and needs no scratch up to N = 256.  The plain versions keep
the JAX arithmetic on both paths.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fedcola_tpu_torch.ops import kernels

Tensor = torch.Tensor

MAX_HEAD_DIM = 64
TENSOR_CORE_HEAD_DIMS = (16, 32, 64)
# above this sequence length the flash route runs the plain attention, as
# fedcola_tpu/ops/flash_attention.py's _fa_fwd / _fa_bwd do
MAX_FUSED_SEQ = 1024


def uses_tensor_cores(dtype: torch.dtype, N: int, hd: int) -> bool:
    """Whether ``fc_flash_fwd`` / ``fc_flash_bwd`` take their tensor-core
    path for this dtype and shape (the choice is made in C,
    ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``); either path streams
    the keys past N = 256."""
    return (dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS
            and N >= 1)


def routes_to_plain(N: int) -> bool:
    """Whether :func:`flash_attention` runs ``attention_xla`` instead of
    the kernels: N > ``MAX_FUSED_SEQ`` (``_fa_fwd`` / ``_fa_bwd``)."""
    return N > MAX_FUSED_SEQ


def scale_as(dtype: torch.dtype, value: float) -> float:
    """``value`` rounded to ``dtype`` (JAX's ``jnp.asarray(value, dtype)``),
    as a Python float: multiplying a tensor of that dtype by it rounds the
    exact product once, as the JAX product of two such values does, and
    needs no device copy."""
    return float(torch.tensor(value, dtype=dtype))


# ------------------------------------------------------------ plain --------

def flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    qm = q * scale_as(q.dtype, scale)
    p = torch.softmax(torch.matmul(qm.float(), k.float().transpose(-1, -2)),
                      dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_bwd_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
                    scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    sc = scale_as(q.dtype, scale)
    qm = (q * sc).float()
    kf, vf, dof = k.float(), v.float(), do.float()
    p = torch.softmax(torch.matmul(qm, kf.transpose(-1, -2)), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    o = torch.matmul(p, vf)
    delta = (dof * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qm)
    return dq.to(q.dtype) * sc, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------- wrappers -------

def _check(q: Tensor, *others: Tuple[str, Tensor]) -> Tuple[int, int, int]:
    N, hd = q.shape[-2:]
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash attention kernel takes head_dim <= {MAX_HEAD_DIM} "
            f"(got N={N}, head_dim={hd})")
    for name, t in (("q", q),) + others:
        kernels.check(t, name, q.shape, q.dtype, q.device)
    return q.numel() // (N * hd), N, hd


def fwd_launch(q: Tensor, k: Tensor, v: Tensor, scale: float):
    """``(entry point, arguments, o)`` of the forward launch; works on CPU
    tensors too, so the argument list can be tested without a card."""
    pairs, N, hd = _check(q, ("k", k), ("v", v))
    o = torch.empty_like(q)
    P_ = kernels.ptr
    return "flash_fwd", [kernels.dtype_code(q.dtype), pairs, N, hd,
                         scale_as(q.dtype, scale), P_(q), P_(k), P_(v),
                         P_(o)], o


def bwd_launch(q: Tensor, k: Tensor, v: Tensor, do: Tensor, scale: float):
    """``(entry point, arguments, (dq, dk, dv), scratch)`` of the backward
    launch.  The scratch, the per-row softmax statistics ``[pairs, N, 3]``
    in f32, exists on the CUDA-core path and, where the keys stream, on
    the tensor-core path."""
    pairs, N, hd = _check(q, ("k", k), ("v", v), ("do", do))
    outs = tuple(torch.empty_like(q) for _ in range(3))
    stats = None
    if not uses_tensor_cores(q.dtype, N, hd) or kernels.streams_keys(N):
        stats = torch.empty((pairs, N, 3), dtype=torch.float32,
                            device=q.device)
    P_ = kernels.ptr
    return "flash_bwd", [kernels.dtype_code(q.dtype), pairs, N, hd,
                         scale_as(q.dtype, scale), P_(q), P_(k), P_(v),
                         P_(do), *map(P_, outs), P_(stats)], outs, stats


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Kernel 11: the attention output ``[..., N, hd]`` in q's dtype."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, scale)
    name, args, o = fwd_launch(q, k, v, scale)
    kernels.launch(name, *args)
    return o


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, do: Tensor,
              scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel 12: (dq, dk, dv), each in its input's dtype."""
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, do, scale)
    name, args, outs, _scratch = bwd_launch(q, k, v, do, scale)
    kernels.launch(name, *args)
    return outs


# ---------------------------------------------------------- autograd -------

class FlashAttention(torch.autograd.Function):
    """Forward kernel 11; backward kernel 12 from the saved q, k, v (P is
    recomputed, as ``_fa_bwd`` recomputes it)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Differentiable ``softmax(q k^T * scale) v`` over ``[..., N, hd]``:
    kernels 11 and 12, or, past ``MAX_FUSED_SEQ``, the plain attention
    differentiated by autograd (the JAX package's ``jax.vjp`` of
    ``_attention_xla``)."""
    if routes_to_plain(q.shape[-2]):
        from fedcola_tpu_torch.ops.attention import attention_xla
        return attention_xla(q, k, v, scale)
    return FlashAttention.apply(q, k, v, scale)
