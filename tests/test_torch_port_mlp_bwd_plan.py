"""The launch plan of the MLP backward's four entry points (``mlp_bwd``,
``mlp_bwd_nores``, ``mlp_bwd_rows``, ``mlp_ln_bwd_rows``), assembled on CPU
tensors: the arguments match the ctypes signatures the CUDA library is
bound with, the bf16 backward on the Hopper path allocates no f32
``[rows, F]`` tensor, and the row ranges of the split weight-gradient sums
cover each client's rows once, in whole 64-row K tiles, as a function of
(rows, D, F) alone.  Catches an argument-list slip before a card does.
"""

import pytest
import torch

from fedcola_tpu_torch.ops import fused_mlp as fm
from fedcola_tpu_torch.ops import kernels

NC = 2


def _case(entry, B, N, D, F, dtype):
    """Arguments of ``fm.bwd_launch`` for ``entry`` over B*N rows."""
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    f32 = torch.float32
    w = (z(NC, D, F), z(NC, F), z(NC, F, D))
    ln = (z(NC, D, dt=f32), z(NC, D, dt=f32))
    if entry in ("mlp_bwd", "mlp_bwd_nores"):
        x = z(NC, B, N, D)
        s = z(NC, B, dt=f32) if entry == "mlp_bwd" else None
        return (x, s, *ln, *w, z(NC, B, N, D))
    x = z(NC, B * N, D)
    if entry == "mlp_ln_bwd_rows":
        return (x, None, *ln, *w, z(NC, B * N, D))
    return (x, None, None, None, *w, z(NC, B * N, D))


ENTRIES = ("mlp_bwd", "mlp_bwd_nores", "mlp_bwd_rows", "mlp_ln_bwd_rows")
SHAPES = [(3, 5, 128, 512), (4, 150, 384, 1536), (1, 111, 100, 400)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_launch_arguments_match_the_signature(entry, shape, dtype):
    B, N, D, F = shape
    case = _case(entry, B, N, D, F, dtype)
    name, args, outs = fm.bwd_launch(*case)
    assert name == entry
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)            # + the stream
    n_int = sig.index(kernels._P)
    assert all(t is kernels._I for t in sig[:n_int])
    assert all(t is kernels._P for t in sig[n_int:])
    rows = B * N
    S, rps = fm.plan_row_splits(rows, D, F)
    code = kernels.dtype_code(dtype)
    want = ([code, NC, B, N, D, F, rps] if entry in ENTRIES[:2]
            else [code, NC, rows, D, F, rps])
    assert args[:n_int] == want
    assert all(a is None or isinstance(a, int) for a in args[n_int:])
    # the inputs, in entry-point order, then the outputs
    inputs = [t for t in case if t is not None]
    assert args[n_int:n_int + len(inputs)] == [t.data_ptr() for t in inputs]
    assert args[n_int + len(inputs):n_int + len(inputs) + len(outs)] == \
        [o.data_ptr() for o in outs]
    ln = entry in ("mlp_bwd", "mlp_bwd_nores", "mlp_ln_bwd_rows")
    assert len(outs) == (7 if ln else 5)
    assert outs[0].shape == inputs[0].shape and outs[0].dtype == dtype
    assert [tuple(o.shape) for o in outs[-4:]] == [
        (NC, D, F), (NC, F), (NC, F, D), (NC, D)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_bf16_backward_allocates_no_f32_rows_by_f_tensor(entry, shape):
    """On the Hopper path (D, F multiples of 8) pre and dh stay on chip;
    off it (D=100) the gemm_kernel path takes them as f32 scratch."""
    B, N, D, F = shape
    rows = B * N
    rps, bufs = fm._bwd_buffers(_case(entry, B, N, D, F,
                                      torch.bfloat16)[0], F,
                                entry != "mlp_bwd_rows")
    big = [b for b in bufs if b is not None and b.dtype == torch.float32
           and b.shape[-1] == F and b.numel() // (NC * F) == rows]
    assert fm.uses_sm90(torch.bfloat16, D, F) == (D % 8 == 0)
    assert len(big) == (0 if fm.uses_sm90(torch.bfloat16, D, F) else 2)
    rps32, bufs32 = fm._bwd_buffers(_case(entry, B, N, D, F,
                                          torch.float32)[0], F,
                                    entry != "mlp_bwd_rows")
    assert not fm.uses_sm90(torch.float32, D, F)
    assert sum(b is not None and b.dtype == torch.float32
               and b.shape[-1] == F and b.numel() // (NC * F) == rows
               for b in bufs32) >= 2


@pytest.mark.parametrize("rows", [1, 15, 64, 65, 111, 600, 1023, 3840,
                                  18912, 100000])
@pytest.mark.parametrize("D,F", [(128, 512), (384, 1536), (768, 3072)])
def test_row_splits_cover_each_row_once(rows, D, F):
    S, rps = fm.plan_row_splits(rows, D, F)
    assert 1 <= S <= 8 and rps % 64 == 0 and rps > 0
    ranges = [(s * rps, min(rows, (s + 1) * rps)) for s in range(S)]
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(a < b for a, b in ranges)              # none empty
    assert all(r[1] == q[0] for r, q in zip(ranges, ranges[1:]))
    assert S == -(-rows // rps)                       # as the C side derives it
    # a function of (rows, D, F) alone: the item and rows entry points,
    # and any number of clients, plan the same ranges
    assert fm.plan_row_splits(rows, D, F) == (S, rps)
    x_item = torch.zeros(3, 1, rows, 8, dtype=torch.bfloat16)
    x_rows = torch.zeros(1, rows, 8, dtype=torch.bfloat16)
    want = fm.plan_row_splits(rows, 8, 16)[1]
    assert fm._bwd_buffers(x_item, 16, True)[0] == want
    assert fm._bwd_buffers(x_rows, 16, True)[0] == want


def test_main_path_shapes_fill_the_card():
    """At mome_small's training shape the split products launch at least
    two blocks per SM for each client (36 output tiles x S)."""
    for rows in (96 * 197, 96 * 40):
        S, _ = fm.plan_row_splits(rows, 384, 1536)
        assert 36 * S >= 2 * fm.H100_SMS or S == 8
