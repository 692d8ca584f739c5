"""Multi-head self-attention of the MAT blocks over stacked clients.

Counterpart of ``fedcola_tpu/ops/attention.py`` (reference
``Attention.forward``, mome.py:150-168): qkv projection, head split,
attention core, head merge, output projection.  The core is f32 scores and
softmax, P cast to the activation dtype before P.v, no mask.

Two cores, chosen as the JAX package chooses them:

* ``use_pallas`` — the flash-attention kernels (``ops/flash_attention.py``,
  plain versions on CPU tensors), which themselves run
  :func:`attention_xla` past ``MAX_FUSED_SEQ`` = 1024 tokens, as
  ``_fa_fwd`` / ``_fa_bwd`` do;
* otherwise :func:`attention_xla`, the port of ``_attention_xla``: plain
  tensor ops, the branch the JAX package takes for ``--no_pallas`` and for
  stacks below ``fused_attn_min_seq``.

The two projections are plain matmuls, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import torch

from fedcola_tpu_torch.ops.flash_attention import flash_attention, scale_as

Tensor = torch.Tensor


def attention_xla(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """``[..., N, hd]`` -> ``[..., N, hd]`` (``_attention_xla``)."""
    q = q * scale_as(q.dtype, scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def attention_heads(x: Tensor, qkv_kernel: Tensor, qkv_bias: Tensor,
                    proj_kernel: Tensor, num_heads: int,
                    use_pallas: bool = True) -> Tensor:
    """The attention sublayer up to the output projection, without its
    bias: ``[n, B*N, proj_kernel.shape[-1]]``.  x ``[n, B, N, D]``;
    qkv_kernel ``[n, D, 3I]`` (q | k | v on the out axis, each ``I =
    num_heads * hd`` wide), qkv_bias ``[n, 3I]``, proj_kernel ``[n, I,
    ...]``.  Under tensor parallelism these are one rank's heads (``I =
    D / size``) and the result its partial of the projection."""
    n, B, N, D = x.shape
    inner = qkv_kernel.shape[-1] // 3
    hd = inner // num_heads
    dt = x.dtype
    qkv = torch.matmul(x.reshape(n, B * N, D), qkv_kernel.to(dt)) \
        + qkv_bias.to(dt)[:, None, :]
    # [n, B*N, 3I] -> 3 x [n, B, H, N, hd]
    qkv = qkv.reshape(n, B, N, 3, num_heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = (t.contiguous() for t in qkv)
    core = flash_attention if use_pallas else attention_xla
    out = core(q, k, v, hd ** -0.5)
    out = out.transpose(2, 3).reshape(n, B * N, inner)
    return torch.matmul(out, proj_kernel.to(dt))


def multi_head_attention(x: Tensor, qkv_kernel: Tensor, qkv_bias: Tensor,
                         proj_kernel: Tensor, proj_bias: Tensor,
                         num_heads: int, use_pallas: bool = True) -> Tensor:
    """x ``[n, B, N, D]``; qkv_kernel ``[n, D, 3D]`` (q | k | v on the out
    axis), qkv_bias ``[n, 3D]``, proj_kernel ``[n, D, D]``, proj_bias
    ``[n, D]``; matmul operands in x's dtype."""
    out = attention_heads(x, qkv_kernel, qkv_bias, proj_kernel, num_heads,
                          use_pallas)
    return (out + proj_bias.to(x.dtype)[:, None, :]).reshape(x.shape)
