"""The launch plan of the attention backward's two entry points
(``attn_bwd`` from the saved P and cat, ``attn_bwd_recompute`` without
saves), assembled on CPU tensors: the arguments match the ctypes signatures
the CUDA library is bound with, the bf16 backward on the Hopper path
allocates no dS / P ``[n, B, H, N, N]`` and no f32 ``[n, B, N, 3D]`` tensor,
the row ranges of the split weight-gradient sums (dWproj ``[D, D]``, dWqkv
``[D, 3D]``) cover each client's rows once in whole 64-row K tiles as a
function of (rows, output shape) alone, and the Python predicate agrees
with the choice ``csrc/attn_bwd.cu`` documents.  Catches an argument-list
slip before a card does.
"""

import pytest
import torch

from fedcola_tpu_torch.ops import fused_attention as fa
from fedcola_tpu_torch.ops import fused_mlp as fm
from fedcola_tpu_torch.ops import kernels

NC, B = 2, 3
OUT_NAMES = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj")


def _case(entry, N, D, H, dtype):
    """Arguments of ``fa.bwd_launch`` for ``entry``."""
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    f32 = torch.float32
    w = (z(NC, D, dt=f32), z(NC, D, dt=f32), z(NC, D, 3 * D), z(NC, 3 * D),
         z(NC, D, D))
    x, da = z(NC, B, N, D), z(NC, B, N, D)
    if entry == "attn_bwd":
        return (x, z(NC, B, dt=f32), *w, z(NC, B, H, N, N), z(NC, B, N, D),
                da, H)
    return (x, None, *w, None, None, da, H)


ENTRIES = ("attn_bwd", "attn_bwd_recompute")
# (N, D, H): mome_small's two stacks, and a ragged small N
SHAPES = [(197, 384, 6), (40, 384, 6), (13, 128, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_launch_arguments_match_the_signature(entry, shape, dtype):
    N, D, H = shape
    case = _case(entry, N, D, H, dtype)
    name, args, outs = fa.bwd_launch(*case)
    assert name == entry
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)            # + the stream
    n_int = sig.index(kernels._P)
    assert all(t is kernels._I for t in sig[:n_int])
    assert all(t is kernels._P for t in sig[n_int:])
    rows = B * N
    rps = (kernels.plan_row_splits(rows, D, D)[1],
           kernels.plan_row_splits(rows, D, 3 * D)[1])
    assert args[:n_int] == [kernels.dtype_code(dtype), NC, B, N, D, H, *rps]
    assert all(a is None or isinstance(a, int) for a in args[n_int:])
    # the inputs in entry-point order, then the outputs
    inputs = [t for t in case[:-1] if t is not None]
    assert args[n_int:n_int + len(inputs)] == [t.data_ptr() for t in inputs]
    assert args[n_int + len(inputs):n_int + len(inputs) + 7] == \
        [o.data_ptr() for o in outs]
    assert len(outs) == len(OUT_NAMES)
    assert outs[0].shape == case[0].shape and outs[0].dtype == dtype
    assert [tuple(o.shape) for o in outs[1:]] == [
        (NC, D), (NC, D), (NC, D, 3 * D), (NC, 3 * D), (NC, D, D), (NC, D)]
    assert all(o.dtype == torch.float32 for o in outs[1:])
    # every pointer is a buffer of its own
    ptrs = [a for a in args[n_int:] if a is not None]
    assert len(set(ptrs)) == len(ptrs)


def _big(bufs, shape, dtype):
    return [b for b in bufs if b is not None and tuple(b.shape) == shape
            and b.dtype == dtype]


@pytest.mark.parametrize("shape", SHAPES + [(37, 96, 2)])
@pytest.mark.parametrize("entry", ENTRIES)
def test_hopper_path_allocates_no_ds_and_no_f32_dqkv(entry, shape):
    """On the Hopper path (bf16, head_dim 16/32/64) P and dS stay on chip
    and dq | dk | dv are written as bf16; off it (head_dim 48, or float32)
    the gemm_kernel path takes dS (and, recomputing, P) and the f32 dqkv as
    scratch."""
    N, D, H = shape
    recompute = entry == "attn_bwd_recompute"
    for dtype in (torch.bfloat16, torch.float32):
        x = _case(entry, N, D, H, dtype)[0]
        _, outs, scratch = fa._bwd_buffers(x, H, recompute)
        hopper = fa.uses_sm90(dtype, D, H, N)
        assert hopper == (dtype == torch.bfloat16 and D // H != 48)
        nn = _big(scratch, (NC, B, H, N, N), dtype)
        f32_dqkv = _big(scratch, (NC, B, N, 3 * D), torch.float32)
        hpart = _big(scratch, (NC * B, 3 * D), torch.float32)
        # qkv and dqkvc in x's dtype on both paths; the f32 dqkv besides
        # them only off the Hopper path
        in_dt = len(_big(scratch, (NC, B, N, 3 * D), dtype))
        if hopper:
            assert not nn and not f32_dqkv and len(hpart) == 1 and in_dt == 2
        else:
            assert len(nn) == (2 if recompute else 1)
            assert scratch[-2] is None and scratch[-1] is None
            extra = 1 if dtype == torch.bfloat16 else 3
            assert len(f32_dqkv) == extra and in_dt == (2 if extra == 1
                                                        else 3)


@pytest.mark.parametrize("rows", [15, 600, 3840, 18912])
@pytest.mark.parametrize("D", [128, 384, 768])
def test_row_splits_cover_each_row_once(rows, D):
    for out in ((D, D), (D, 3 * D)):
        S, rps = kernels.plan_row_splits(rows, *out)
        assert 1 <= S <= 8 and rps % 64 == 0 and rps > 0
        ranges = [(s * rps, min(rows, (s + 1) * rps)) for s in range(S)]
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(a < b for a, b in ranges)              # none empty
        assert all(r[1] == q[0] for r, q in zip(ranges, ranges[1:]))
        assert S == -(-rows // rps)                   # as the C side derives it
        # the MLP's planner is the same function of (rows, output shape)
        assert fm.plan_row_splits(rows, *out) == (S, rps)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_split_plan_and_partials_do_not_depend_on_the_client_count(n):
    """wpart holds the larger of the two products' partials, n clients
    each; the plan itself is the same for any n."""
    N, D, H = 197, 384, 6
    x = torch.zeros(n, 96, N, D, dtype=torch.bfloat16)
    rps, _, scratch = fa._bwd_buffers(x, H, False)
    plans = (kernels.plan_row_splits(96 * N, D, D),
             kernels.plan_row_splits(96 * N, D, 3 * D))
    assert rps == (plans[0][1], plans[1][1])
    want = max(S * n * D * cols for (S, _), cols in zip(plans, (D, 3 * D)))
    assert scratch[-1].numel() == want
    # both products fill the card at the main path's shapes
    for (S, _), tiles in zip(plans, (9, 27)):
        assert tiles * S * 2 >= kernels.H100_SMS or S == 8


def test_single_range_products_take_no_partials():
    """15 rows a client: one range, the products write the gradients
    directly and wpart is not allocated."""
    x = torch.zeros(NC, 3, 5, 128, dtype=torch.bfloat16)
    rps, _, scratch = fa._bwd_buffers(x, 2, True)
    assert rps == (64, 64) and scratch[-1] is None and scratch[-2] is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,H", [(384, 6), (128, 2), (64, 4), (64, 2),
                                 (96, 2), (192, 3), (100, 4), (120, 5),
                                 (256, 2), (48, 6)])
@pytest.mark.parametrize("N", [5, 40, 197, 256])
def test_predicate_is_the_documented_choice(dtype, D, H, N):
    """``dtype == 1 && D % 8 == 0 && hd in {16, 32, 64}``, at every N, as
    ``attn_on_sm90`` in ``csrc/attn_sm90.cuh``."""
    hd = D // H
    want = (kernels.dtype_code(dtype) == 1 and D % 8 == 0
            and hd in (16, 32, 64))
    assert fa.uses_sm90(dtype, D, H, N) == want
    # the documented examples: mome_small and the test models are on the
    # path, head_dim 48, 25, 24, 128 and 8 are not
    if dtype == torch.bfloat16:
        assert fa.uses_sm90(dtype, D, H, N) == ((D, H) in {
            (384, 6), (128, 2), (64, 4), (64, 2), (192, 3)})


def test_cpu_tensors_run_the_plain_version():
    """The wrappers launch nothing for CPU tensors."""
    N, D, H = 5, 32, 2
    case = _case("attn_bwd", N, D, H, torch.float32)
    kernels.reset_launches()
    got = fa.attn_bwd(*case)
    ref = fa.attn_bwd_plain(*case)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    x, _, *w, _, _, da, _ = case
    got = fa.attn_bwd_recompute(x, *w, da, H)
    ref = fa.attn_bwd_recompute_plain(x, *w, da, H)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not any(kernels.LAUNCHES.values())
