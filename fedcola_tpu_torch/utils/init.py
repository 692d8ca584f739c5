"""Weight-initialisation variants (reference ``init_weights``,
src/utils.py:126-163); port of ``fedcola_tpu/utils/init.py``.

The reference applies these through its legacy ``load_model`` path only;
the MAT keeps torch's default init, so this is an available utility, not
part of MAT construction, and ``--init_type`` is parsed and unused, as in
the JAX package.  Semantics per torch:

* Linear / Conv *kernels* (``*_kernel``, ``patch_kernel`` and the heads'
  ``kernel`` leaves) are drawn anew and their biases zeroed; embeddings,
  LayerNorms and the cls / pos tokens are untouched (torch's ``init_func``
  matches only Linear / Conv / BatchNorm modules);
* fans follow torch's ``[out, in]`` convention (the port's kernels are
  ``[in, out]``), and depth-stacked ``[depth, in, out]`` kernels are drawn
  layer by layer.
"""

from __future__ import annotations

import math
import torch

from fedcola_tpu_torch.models.mat import Params

def _is_kernel(path) -> bool:
    leaf = path[-1]
    return leaf in ("kernel", "patch_kernel") or leaf.endswith("_kernel")


def _is_bias(path) -> bool:
    """Linear / Conv biases only: LayerNorm biases (norm1_bias, norm2_bias,
    the shared norm, the text embedding's LN) stay as they are."""
    leaf = path[-1]
    if "norm" in leaf or leaf.startswith("ln"):
        return False
    if any("norm" in str(p) for p in path[:-1]):
        return False
    return leaf in ("bias", "patch_bias") or leaf.endswith("_bias")


def _init_matrix(gen: torch.Generator, shape, init_type: str,
                 gain: float) -> torch.Tensor:
    """One ``[in, out]`` kernel (or ``[P, P, C, D]`` patch conv) in
    float32, with fan_in / fan_out as torch sees the ``[out, in]``
    weight."""
    shape = tuple(shape)
    if len(shape) == 4:
        # torch's _calculate_fan_in_and_fan_out on Conv2d [D, C, P, P]:
        # feature maps times the receptive field, both directions
        fan_in = shape[2] * shape[0] * shape[1]
        fan_out = shape[3] * shape[0] * shape[1]
    else:
        fan_in, fan_out = shape[-2], shape[-1]

    def normal(std):
        return torch.randn(shape, generator=gen) * std

    if init_type == "normal":
        return normal(gain)
    if init_type == "xavier":
        return normal(gain * math.sqrt(2.0 / (fan_in + fan_out)))
    if init_type == "xavier_uniform":
        bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound
    if init_type == "kaiming":
        # kaiming_normal_(a=0, mode='fan_in'): std = sqrt(2 / fan_in)
        return normal(math.sqrt(2.0 / fan_in))
    if init_type == "truncnorm":
        # trunc_normal_(std=gain, a=-2, b=2): absolute bounds +-2
        return torch.nn.init.trunc_normal_(torch.empty(shape), std=gain,
                                           a=-2.0, b=2.0, generator=gen)
    if init_type == "orthogonal":
        rows, cols = math.prod(shape[:-1]), shape[-1]
        a = torch.randn((rows, cols), generator=gen)
        q, r = torch.linalg.qr(a if rows >= cols else a.T)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        return gain * q.reshape(shape)
    raise NotImplementedError(
        f"[ERROR] Initialization method {init_type} is not implemented!")


def init_weights(params: Params, init_type: str, init_gain: float,
                 gen: torch.Generator) -> Params:
    """A new tree with the Linear / Conv kernels of a MAT tree drawn anew
    from ``gen`` and their biases zeroed; each leaf keeps its device and
    dtype.  ``init_type='none'`` returns ``params`` unchanged."""
    if init_type == "none":
        return params

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if _is_kernel(path):
            if node.dim() >= 3 and path[-1] != "patch_kernel":
                # stacked [depth, in, out]: one draw per layer, as torch
                # initialises one module per layer
                new = torch.stack([
                    _init_matrix(gen, node.shape[1:], init_type, init_gain)
                    for _ in range(node.shape[0])])
            else:
                new = _init_matrix(gen, node.shape, init_type, init_gain)
            return new.to(node.device, node.dtype)
        if _is_bias(path):
            return torch.zeros_like(node)
        return node

    return walk(params, ())
