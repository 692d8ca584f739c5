"""The launch plan of the two flash-attention entry points (``flash_fwd``,
``flash_bwd``), assembled on CPU tensors: the arguments match the ctypes
signatures the CUDA library is bound with, on the tensor-core path and on
the CUDA-core path, in both dtypes; ``uses_tensor_cores`` is the choice
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` document (bfloat16 at
head_dim 16, 32 or 64, any N); the resident tensor-core backward
allocates no statistics scratch; CPU tensors run the plain versions and
count no launch.  Catches an argument-list slip before a card does.
"""

import pytest
import torch

from fedcola_tpu_torch.ops import flash_attention as fl
from fedcola_tpu_torch.ops import kernels

LEAD = (2, 3)                       # clients x (batch * heads), merged
DTYPES = [torch.bfloat16, torch.float32]
# (N, hd): mome_tiny's two stacks, the off-grid head_dim 48 of the model
# check, a registered test model's head_dim 8
SHAPES = [(197, 64), (40, 64), (13, 32), (5, 16), (17, 48), (5, 8)]


def _inputs(N, hd, dtype, n=3):
    return [torch.zeros(LEAD + (N, hd), dtype=dtype) for _ in range(n)]


def _split(sig):
    n_int = sig.index(kernels._F)
    assert all(t is kernels._I for t in sig[:n_int])
    assert all(t is kernels._P for t in sig[n_int + 1:])
    return n_int


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_arguments_match_the_signature(shape, dtype):
    N, hd = shape
    q, k, v = _inputs(N, hd, dtype)
    name, args, o = fl.fwd_launch(q, k, v, hd ** -0.5)
    assert name == "flash_fwd"
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)            # + the stream
    n_int = _split(sig)
    assert args[:n_int] == [kernels.dtype_code(dtype), 6, N, hd]
    assert args[n_int] == fl.scale_as(dtype, hd ** -0.5)
    assert args[n_int + 1:] == [t.data_ptr() for t in (q, k, v, o)]
    assert o.shape == q.shape and o.dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_arguments_match_the_signature(shape, dtype):
    N, hd = shape
    q, k, v, do = _inputs(N, hd, dtype, 4)
    name, args, outs, stats = fl.bwd_launch(q, k, v, do, hd ** -0.5)
    assert name == "flash_bwd"
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)
    n_int = _split(sig)
    assert args[:n_int] == [kernels.dtype_code(dtype), 6, N, hd]
    assert args[n_int] == fl.scale_as(dtype, hd ** -0.5)
    assert args[n_int + 1:-1] == [t.data_ptr() for t in (q, k, v, do, *outs)]
    assert all(o.shape == q.shape and o.dtype == dtype for o in outs)
    ptrs = args[n_int + 1:-1]
    assert len(set(ptrs)) == len(ptrs)          # every buffer its own
    # the statistics scratch belongs to the CUDA-core path alone
    if fl.uses_tensor_cores(dtype, N, hd):
        assert stats is None and args[-1] is None
    else:
        assert stats.shape == (6, N, 3) and stats.dtype == torch.float32
        assert args[-1] == stats.data_ptr()


@pytest.mark.parametrize("N", [5, 40, 197, 256])
@pytest.mark.parametrize("hd", [8, 16, 32, 48, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_uses_tensor_cores_is_the_documented_choice(dtype, hd, N):
    want = dtype == torch.bfloat16 and hd in (16, 32, 64)
    assert fl.uses_tensor_cores(dtype, N, hd) is want
    # and the backward's scratch follows it
    q, k, v, do = _inputs(N, hd, dtype, 4)
    assert (fl.bwd_launch(q, k, v, do, 0.125)[3] is None) is want


def test_shapes_the_kernels_do_not_take_are_refused():
    """head_dim past 64 is refused; sequences past 256 are not (the keys
    stream: N = 300 and 2048 take the tensor-core path in bf16, with the
    statistics scratch)."""
    assert not fl.uses_tensor_cores(torch.float16, 40, 64)
    for N in (300, 2048):
        assert fl.uses_tensor_cores(torch.bfloat16, N, 64)
        q, k, v, do = _inputs(N, 64, torch.bfloat16, 4)
        assert fl.fwd_launch(q, k, v, 0.125)[0] == "flash_fwd"
        assert fl.bwd_launch(q, k, v, do, 0.125)[3].shape == (6, N, 3)
    q, k, v, do = _inputs(40, 96, torch.bfloat16, 4)
    with pytest.raises(NotImplementedError):
        fl.fwd_launch(q, k, v, 0.125)
    with pytest.raises(NotImplementedError):
        fl.bwd_launch(q, k, v, do, 0.125)
    q, k, v = _inputs(40, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        fl.fwd_launch(q, k.float(), v, 0.125)
    with pytest.raises(ValueError):
        fl.fwd_launch(q, k.transpose(-1, -2).contiguous().transpose(-1, -2),
                      v, 0.125)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_run_the_plain_versions(dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(LEAD + (13, 32), generator=g).to(dtype)
                   for _ in range(4))
    before = dict(kernels.LAUNCHES)
    o = fl.flash_fwd(q, k, v, 32 ** -0.5)
    grads = fl.flash_bwd(q, k, v, do, 32 ** -0.5)
    assert kernels.LAUNCHES == before
    assert torch.equal(o, fl.flash_fwd_plain(q, k, v, 32 ** -0.5))
    for a, b in zip(grads, fl.flash_bwd_plain(q, k, v, do, 32 ** -0.5)):
        assert torch.equal(a, b)
    # and autograd goes through the same two functions
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fl.flash_attention(*leaves, 32 ** -0.5)
    for a, b in zip(torch.autograd.grad(out, leaves, do), grads):
        assert torch.equal(a, b)
