"""The launch plan of the fused route's six forward variants, assembled on
CPU tensors: the MLP's ``mlp_fwd`` with and without the residual scale,
``mlp_fwd_rows`` and ``mlp_ln_fwd_rows`` (``fused_mlp.fwd_launch``), and the
attention sublayer's ``attn_fwd`` saving P with the residual and not saving
without (``fused_attention.fwd_launch``).  The arguments match the ctypes
signatures the CUDA library is bound with, the outputs have the plain
versions' shapes and dtypes, the Python predicates mirror the C side's
choice of the Hopper path, and the 128 x 128 tiles of the four D-wide
products fill the card at the main-path shape.  Catches an argument-list
slip before a card does.
"""

import pytest
import torch

from fedcola_tpu_torch.ops import fused_attention as fa
from fedcola_tpu_torch.ops import fused_mlp as fm
from fedcola_tpu_torch.ops import kernels

NC, B = 2, 3
MLP_VARIANTS = ("mlp_fwd", "mlp_fwd_eval", "mlp_fwd_rows", "mlp_ln_fwd_rows")
ATTN_VARIANTS = ("attn_fwd", "attn_fwd_eval")
DTYPES = [torch.bfloat16, torch.float32]


def _z(*shape, dt):
    return torch.zeros(shape, dtype=dt)


def _mlp_case(variant, N, D, F, dtype):
    """Arguments of ``fm.fwd_launch`` and of the variant's plain version."""
    f32 = torch.float32
    w = (_z(NC, D, F, dt=dtype), _z(NC, F, dt=dtype), _z(NC, F, D, dt=dtype),
         _z(NC, D, dt=dtype))
    ln = (torch.ones(NC, D, dtype=f32), _z(NC, D, dt=f32))
    if variant in ("mlp_fwd", "mlp_fwd_eval"):
        s = torch.ones(NC, B, dtype=f32) if variant == "mlp_fwd" else None
        args = (_z(NC, B, N, D, dt=dtype), s, *ln, *w)
        return args, fm.mlp_fwd_plain(*args)
    x = _z(NC, B * N, D, dt=dtype)
    if variant == "mlp_ln_fwd_rows":
        return (x, None, *ln, *w), fm.mlp_ln_fwd_rows_plain(x, *ln, *w)
    return (x, None, None, None, *w), fm.mlp_fwd_rows_plain(x, *w)


def _check_signature(name, args):
    """Integers first, then pointers (the stream is the last), except
    ``attn_fwd``'s trailing ``save`` flag."""
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)            # + the stream
    for a, t in zip(args, sig):
        if t is kernels._I:
            assert isinstance(a, int) and not isinstance(a, bool)
        else:
            assert t is kernels._P and (a is None or isinstance(a, int))
    return sig.index(kernels._P)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [40, 197])
@pytest.mark.parametrize("variant", MLP_VARIANTS)
def test_mlp_forward_launch_matches_the_signature(variant, N, dtype):
    D, F = 128, 512
    case, ref = _mlp_case(variant, N, D, F, dtype)
    name, args, out = fm.fwd_launch(*case)
    assert name == variant.replace("_eval", "")
    n_int = _check_signature(name, args)
    code = kernels.dtype_code(dtype)
    item = variant.startswith("mlp_fwd") and "rows" not in variant
    assert args[:n_int] == ([code, NC, B, N, D, F] if item
                            else [code, NC, B * N, D, F])
    # the inputs in entry-point order (a null pointer for the s of the eval
    # variant), the output, then the scratch
    inputs = [t for t in case if t is not None]
    ptrs = [t.data_ptr() for t in inputs]
    if variant == "mlp_fwd_eval":
        ptrs.insert(1, None)
    assert args[n_int:n_int + len(ptrs)] == ptrs
    assert args[n_int + len(ptrs)] == out.data_ptr()
    scratch = args[n_int + len(ptrs) + 1:]
    assert len(scratch) == (1 if variant == "mlp_fwd_rows" else 4)
    assert all(isinstance(a, int) for a in scratch)
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [40, 197])
@pytest.mark.parametrize("variant", ATTN_VARIANTS)
def test_attention_forward_launch_matches_the_signature(variant, N, dtype):
    D, H = 128, 2
    f32 = torch.float32
    save = variant == "attn_fwd"
    s = torch.ones(NC, B, dtype=f32) if save else None
    w = (torch.ones(NC, D, dtype=f32), _z(NC, D, dt=f32),
         _z(NC, D, 3 * D, dt=dtype), _z(NC, 3 * D, dt=dtype),
         _z(NC, D, D, dt=dtype), _z(NC, D, dt=dtype))
    x = _z(NC, B, N, D, dt=dtype)
    name, args, outs = fa.fwd_launch(x, s, *w, H, save)
    assert name == "attn_fwd"
    n_int = _check_signature(name, args)
    assert args[:n_int] == [kernels.dtype_code(dtype), NC, B, N, D, H]
    assert args[-1] == int(save)
    want = [x.data_ptr(), s.data_ptr() if save else None] + \
        [t.data_ptr() for t in w] + \
        [None if o is None else o.data_ptr() for o in outs]
    assert args[n_int:n_int + len(want)] == want
    assert all(isinstance(a, int) for a in args[n_int + len(want):-1])
    assert len(args[n_int + len(want):-1]) == 4      # h, mean, rstd, qkv
    ref = fa.attn_fwd_plain(x, s, *w, H, save)
    assert (outs[1] is None) == (ref[1] is None) == (not save)
    for o, r in zip(outs, ref):
        if r is not None:
            assert o.shape == r.shape and o.dtype == r.dtype == dtype


def test_a_sublayer_without_ln_is_refused():
    case, _ = _mlp_case("mlp_fwd", 5, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="LN"):
        fm.fwd_launch(case[0], case[1], None, None, *case[4:])


@pytest.mark.parametrize("N", [40, 197])
def test_hopper_path_predicates_mirror_the_c_side(N):
    """mome_small (D=384, F=1536, 6 heads) in bf16 runs the Hopper path in
    both sublayers; float32, D=100 (off TMA's 8-element grid) and head_dim
    48 do not."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fm.uses_sm90(bf, 384, 1536) and fa.uses_sm90(bf, 384, 6, N)
    assert not fm.uses_sm90(f32, 384, 1536)
    assert not fa.uses_sm90(f32, 384, 6, N)
    assert not fm.uses_sm90(bf, 100, 400)
    assert not fa.uses_sm90(bf, 100, 2, N)          # head_dim 50
    assert not fa.uses_sm90(bf, 96, 2, N)           # head_dim 48
    assert all(fa.uses_sm90(bf, hd * 2, 2, N) for hd in (16, 32, 64))
    # every N: the head kernels stream the keys past 256
    assert fa.uses_sm90(bf, 384, 6, 257) and fa.uses_sm90(bf, 384, 6, 2048)


@pytest.mark.parametrize("product,cols", [("fc1", 1536), ("fc2", 384),
                                          ("qkv", 1152), ("proj", 384)])
def test_main_path_tiles_fill_the_card(product, cols):
    """At mome_small's training shape (n=2 clients, 96 x 197 rows) each of
    the four forward products has at least one 128 x 128 tile per SM."""
    rows, n = 96 * 197, 2
    tiles = n * -(-rows // kernels.SM90_BM) * -(-cols // 128)
    assert tiles >= kernels.H100_SMS, (product, tiles)
