"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes (N = 37 and 5, D = 128, H = 2; flash attention at
hd = 64 and 48; the rows-mode MLP at 600 and 15 rows), float32 and
bfloat16, forward outputs, P, cat and every gradient; plus the launch
counters and the wrappers' refusals.  The bf16 MLP backward's Hopper GEMM
(``csrc/gemm_sm90.cuh``) is also held alone against ``torch.matmul`` in its
four operand layouts, and its backward for the zero fill at a client's
ragged last tile, run-to-run bitwise reproducibility, rows vs item entry
points, and the ``gemm_kernel`` branch that D off the 8 grid takes.  The
bf16 attention backward's Hopper path (the same GEMM plus the tensor-core
head kernel of ``csrc/attn_bwd_core.cuh``) is held to the plain versions at
N = 256, 197, 40 and 13 and head_dim 64, 32 and 16, for item and client
isolation, for bitwise repeats, and for the old path at head_dim 48.  The
bf16 flash kernels' tensor-core path (``csrc/attn_fwd_core.cuh`` and the
flash mode of ``csrc/attn_bwd_core.cuh``) is held to the plain versions at
N = 256, 197, 40, 13 and 5 and head_dim 64, 32 and 16, for pair isolation
and bitwise repeats; the kernels a call launches are read from a profile,
which is how the tests know that head_dim 48 and float32 stay on the
CUDA-core kernels; the new forward core is also run in the fused
sublayer's packed layout with P written.  The bf16 forwards of the fused
route (``csrc/mlp_fwd.cu``, ``csrc/attn_fwd.cu``: the Hopper GEMM with the
GELU and residual epilogues, and that forward core) are held to their plain
versions at n = 1 and 3 clients, D = 64 to 1024, head_dim 64, 32 and 16 and
N = 256, 197, 40 and 1, with bitwise repeats; the two epilogues alone to a
float32 reference at ragged M and N across a client boundary; and D = 100
and head_dim 48 to the plain versions on the ``gemm_kernel`` path.  Past
N = 256 every attention kernel streams the keys: rows 1, 1e, 2 and 5 at
N = 257, 300, 333, 512, 513 and 1536 and the flash kernels at 257, 300,
333, 512, 513 and 1024 (head_dim 64, 32, 16; tensor-core and CUDA-core
paths) are held to the plain versions in float32 and bfloat16 with
bitwise repeats, the bf16 entry points are shown to launch the Hopper
streamed kernels whether P moves in TMA tiles (N = 512) or element by
element (N = 300), the flash route takes the plain attention at
N = 1025, and ``resident_digests`` gives the outputs of the resident
kernels (N = 256, 197, 40) for a comparison with another build.

Marked ``cuda``: every test skips without a CUDA device.  This file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from fedcola_tpu_torch.ops import flash_attention as fl
from fedcola_tpu_torch.ops import fused_attention as fa
from fedcola_tpu_torch.ops import fused_mlp as fm
from fedcola_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda
NC, B, D, H = 2, 3, 128, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(names, N, dtype, dev, seed=0):
    r = np.random.RandomState(seed)
    F = 4 * D
    shapes = {"x": (NC, B, N, D), "do": (NC, B, N, D), "s": (NC, B),
              "lns": (NC, D), "lnb": (NC, D), "wqkv": (NC, D, 3 * D),
              "bqkv": (NC, 3 * D), "wproj": (NC, D, D), "bproj": (NC, D),
              "w1": (NC, D, F), "b1": (NC, F), "w2": (NC, F, D),
              "b2": (NC, D)}
    out = {}
    for k in names:
        if k == "s":
            a = r.choice([0.0, 1.0 / 0.9], size=shapes[k])
        elif k == "lns":
            a = r.rand(*shapes[k]) + 0.5
        else:
            a = r.randn(*shapes[k]) * (0.1 if k.startswith("w") else 1.0)
        t = torch.from_numpy(a.astype(np.float32)).to(dev)
        out[k] = t if k in ("s", "lns", "lnb") else t.to(dtype)
    return out


def _agree(got, ref, dtype):
    for g, r in zip(got, ref):
        if r is None:
            continue
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all()
        d = (g - r).abs().max().item()
        m = r.abs().max().item()
        if dtype == torch.float32:
            assert d <= 1e-4 * max(1.0, m), (d, m)
        else:
            assert d <= 3e-2 * m, (d, m)


ATTN = ("x", "s", "lns", "lnb", "wqkv", "bqkv", "wproj", "bproj", "do")
MLP = ("x", "s", "lns", "lnb", "w1", "b1", "w2", "b2", "do")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [37, 5])
def test_attention_kernels_match_plain(dev, N, dtype):
    t = _inputs(ATTN, N, dtype, dev)
    w = [t[k] for k in ATTN[2:8]]
    for s, save in ((t["s"], True), (None, False)):
        _agree(fa.attn_fwd(t["x"], s, *w, H, save=save),
               fa.attn_fwd_plain(t["x"], s, *w, H, save=save), dtype)
    _, P, cat = fa.attn_fwd_plain(t["x"], t["s"], *w, H)
    args = (t["x"], t["s"], *w[:5], P, cat, t["do"], H)
    _agree(fa.attn_bwd(*args), fa.attn_bwd_plain(*args), dtype)
    args = (t["x"], *w[:5], t["do"], H)
    _agree(fa.attn_bwd_recompute(*args), fa.attn_bwd_recompute_plain(*args),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [37, 5])
def test_mlp_kernels_match_plain(dev, N, dtype):
    t = _inputs(MLP, N, dtype, dev)
    w = [t[k] for k in MLP[2:8]]
    for s in (t["s"], None):
        _agree([fm.mlp_fwd(t["x"], s, *w)], [fm.mlp_fwd_plain(t["x"], s, *w)],
               dtype)
    for s in (t["s"], None):
        args = (t["x"], s, *w[:5], t["do"])
        _agree(fm.mlp_bwd(*args), fm.mlp_bwd_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [200, 5])
def test_rows_mlp_kernels_match_plain(dev, N, dtype):
    """Rows 7-10 over B*N = 600 and 15 flattened rows (neither a multiple
    of the Pallas row tiles, 512 and 256)."""
    t = _inputs(MLP, N, dtype, dev)
    x, do = (t[k].reshape(NC, B * N, D) for k in ("x", "do"))
    ln = [t["lns"], t["lnb"]]
    w = [t[k] for k in MLP[4:8]]
    _agree([fm.mlp_fwd_rows(x, *w)], [fm.mlp_fwd_rows_plain(x, *w)], dtype)
    _agree(fm.mlp_bwd_rows(x, *w[:3], do),
           fm.mlp_bwd_rows_plain(x, *w[:3], do), dtype)
    _agree([fm.mlp_ln_fwd_rows(x, *ln, *w)],
           [fm.mlp_ln_fwd_rows_plain(x, *ln, *w)], dtype)
    _agree(fm.mlp_ln_bwd_rows(x, *ln, *w[:3], do),
           fm.mlp_ln_bwd_rows_plain(x, *ln, *w[:3], do), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,hd", [(197, 64), (37, 48), (5, 64)])
def test_flash_kernels_match_plain(dev, N, hd, dtype):
    r = np.random.RandomState(N)
    q, k, v, do = (torch.from_numpy(r.randn(2, 3, 2, N, hd).astype(
        np.float32)).to(dev).to(dtype) for _ in range(4))
    scale = hd ** -0.5
    _agree([fl.flash_fwd(q, k, v, scale)], [fl.flash_fwd_plain(q, k, v, scale)],
           dtype)
    _agree(fl.flash_bwd(q, k, v, do, scale),
           fl.flash_bwd_plain(q, k, v, do, scale), dtype)


def test_autograd_functions_launch_each_kernel_once(dev):
    t = _inputs(ATTN + MLP, 9, torch.bfloat16, dev)
    kernels.reset_launches()
    x = t["x"].clone().requires_grad_(True)
    h = fa.fused_attention_residual(x, t["s"], t["lns"], t["lnb"], t["wqkv"],
                                    t["bqkv"], t["wproj"], t["bproj"], H)
    h = fm.fused_mlp_residual_sublayer_items(h, t["s"], t["lns"], t["lnb"],
                                             t["w1"], t["b1"], t["w2"],
                                             t["b2"])
    h.backward(t["do"])
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "attn_fwd": 1, "attn_bwd": 1, "mlp_fwd": 1, "mlp_bwd": 1}
    assert torch.isfinite(x.grad.float()).all()

    kernels.reset_launches()
    x = t["x"].clone().requires_grad_(True)
    h = fa.fused_attention(x, t["lns"], t["lnb"], t["wqkv"], t["bqkv"],
                           t["wproj"], t["bproj"], H)
    h = fm.fused_mlp_sublayer_items(h, t["lns"], t["lnb"], t["w1"], t["b1"],
                                    t["w2"], t["b2"])
    q = h.reshape(NC, B, 9, H, D // H).transpose(2, 3).contiguous()
    h = fl.flash_attention(q, q, q, 0.125)
    h.backward(t["do"].reshape(NC, B, 9, H, D // H).transpose(2, 3))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "attn_fwd": 1, "attn_bwd_recompute": 1, "mlp_fwd": 1,
        "mlp_bwd_nores": 1, "flash_fwd": 1, "flash_bwd": 1}
    assert torch.isfinite(x.grad.float()).all()

    kernels.reset_launches()
    x = t["x"].reshape(NC, B * 9, D).clone().requires_grad_(True)
    w = [t[k] for k in ("w1", "b1", "w2", "b2")]
    h = fm.fused_mlp_sublayer(x, t["lns"], t["lnb"], *w)
    h = fm.fused_mlp(h, *w)
    h.backward(t["do"].reshape(NC, B * 9, D))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "mlp_ln_fwd_rows": 1, "mlp_ln_bwd_rows": 1, "mlp_fwd_rows": 1,
        "mlp_bwd_rows": 1}
    assert torch.isfinite(x.grad.float()).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    t = _inputs(ATTN, 9, torch.float32, dev)
    w = [t[k] for k in ATTN[2:8]]
    with pytest.raises(ValueError, match="contiguous"):
        fa.attn_fwd(t["x"].transpose(1, 2).contiguous().transpose(1, 2),
                    t["s"], *w, H)
    with pytest.raises(TypeError):
        fa.attn_fwd(t["x"], t["s"], *w[:2], w[2].double(), *w[3:], H)
    with pytest.raises(NotImplementedError):
        fa.attn_fwd(t["x"], t["s"], *w, 1)        # head_dim 128 > 64
    # N past the resident kernels' 256 is taken (the keys stream) ...
    q = torch.zeros(2, 4, 300, 64, device=dev)
    assert torch.equal(fl.flash_fwd(q, q, q, 0.125), q)
    x = _inputs(("x",), 300, torch.float32, dev)["x"]
    assert fa.attn_fwd(x, None, *w, H, save=False)[0].shape == x.shape
    # ... and head_dim past 64 is still refused
    q = torch.zeros(2, 4, 16, 96, device=dev)
    with pytest.raises(NotImplementedError):
        fl.flash_fwd(q, q, q, 0.125)              # head_dim 96 > 64


def _sm90_gemm(a, b, ta, tb, M, N, K):
    """``fc_sm90_gemm_test``: c = A . B per client on the Hopper mainloop;
    a is [n, M, K] (ta=0) or [n, K, M] (ta=1), b is [n, N, K] (tb=0) or
    [n, K, N] (tb=1)."""
    c = torch.full((a.shape[0], M, N), float("nan"), device=a.device)
    err = kernels.library().fc_sm90_gemm_test(
        ta, tb, a.shape[0], M, N, K, a.data_ptr(), b.data_ptr(), c.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return c


@pytest.mark.parametrize("M,N,K", [(200, 136, 72), (72, 264, 40),
                                   (1000, 24, 600)])
@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_sm90_mainloop_matches_matmul_in_every_layout(dev, ta, tb, M, N, K):
    """x.W^T (K-major B), x.W (MN-major B) and A^T.B (MN-major A) at M, N
    and K off the 128 / 64 tiles; bf16 products summed in f32, so only the
    summation order differs from torch.matmul in f32."""
    r = np.random.RandomState(M + N + K)
    A = torch.from_numpy(r.randn(NC, M, K).astype(np.float32)).to(dev)
    Bm = torch.from_numpy(r.randn(NC, K, N).astype(np.float32)).to(dev)
    A, Bm = A.bfloat16(), Bm.bfloat16()
    a = A.transpose(1, 2).contiguous() if ta else A
    b = Bm if tb else Bm.transpose(1, 2).contiguous()
    ref = torch.matmul(A.float(), Bm.float())
    got = _sm90_gemm(a, b, ta, tb, M, N, K)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() * K


def _rows_inputs(rows, Dm, seed, dev):
    r = np.random.RandomState(seed)
    Fm = 4 * Dm
    a = {"x": r.randn(NC, rows, Dm), "do": r.randn(NC, rows, Dm),
         "lns": r.rand(NC, Dm) + 0.5, "lnb": r.randn(NC, Dm) * 0.1,
         "w1": r.randn(NC, Dm, Fm) * 0.1, "b1": r.randn(NC, Fm) * 0.1,
         "w2": r.randn(NC, Fm, Dm) * 0.1}
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev).to(
        torch.float32 if k.startswith("ln") else torch.bfloat16)
        for k, v in a.items()}


def _four_backwards(t, s=None):
    """(entry point, outputs) of the four backward entry points on the same
    [n, rows, D] inputs (the item ones on the [n, 1, rows, D] view)."""
    x, do = t["x"], t["do"]
    ln = (t["lns"], t["lnb"])
    w = (t["w1"], t["b1"], t["w2"])
    s = torch.ones(NC, 1, device=x.device) if s is None else s
    return {"mlp_bwd": fm.mlp_bwd(x[:, None], s, *ln, *w, do[:, None]),
            "mlp_bwd_nores": fm.mlp_bwd(x[:, None], None, *ln, *w,
                                        do[:, None]),
            "mlp_bwd_rows": fm.mlp_bwd_rows(x, *w, do),
            "mlp_ln_bwd_rows": fm.mlp_ln_bwd_rows(x, *ln, *w, do)}


@pytest.mark.parametrize("rows", [15, 111, 600])
def test_bf16_backward_reads_no_other_clients_rows(dev, rows):
    """Client 1's inputs large, client 0's do all zero: client 0's weight
    and bias gradients are exactly 0, so its ragged last row tile read
    TMA's zero fill and not client 1's first rows."""
    t = _rows_inputs(rows, D, rows, dev)
    t["x"][1] *= 100
    t["do"][1] *= 100
    t["do"][0] = 0
    for name, g in _four_backwards(t).items():
        for grad in g[-4:]:
            assert torch.count_nonzero(grad[0]) == 0, name
            assert torch.count_nonzero(grad[1]) > 0, name


@pytest.mark.parametrize("rows", [111, 600])
def test_bf16_backward_is_bitwise_reproducible(dev, rows):
    """Two calls of each backward entry point give the same bits (fixed
    summation orders, no atomics; 600 rows take two split ranges)."""
    t = _rows_inputs(rows, D, 7, dev)
    first, second = _four_backwards(t), _four_backwards(t)
    for name in first:
        for a, b in zip(first[name], second[name]):
            assert torch.equal(a, b), name


def test_bf16_ln_rows_backward_is_the_item_backward_bitwise(dev):
    """Row 10 on [n, rows, D] and row 6 on [n, 1, rows, D] run the same
    launches (rows per client and the split plan agree)."""
    t = _rows_inputs(600, D, 8, dev)
    g = _four_backwards(t)
    for a, b in zip(g["mlp_ln_bwd_rows"], g["mlp_bwd_nores"]):
        assert torch.equal(a, b.reshape(a.shape))


def test_bf16_backward_off_the_8_grid_takes_gemm_kernel(dev):
    """D = 100 (F = 400): TMA's 16-byte row strides rule the Hopper path
    out, so the entry point runs gemm_kernel, held to the plain version."""
    Dm = 100
    assert not fm.uses_sm90(torch.bfloat16, Dm, 4 * Dm)
    t = _rows_inputs(111, Dm, 9, dev)
    x, do = t["x"], t["do"]
    ln = (t["lns"], t["lnb"])
    w = (t["w1"], t["b1"], t["w2"])
    _agree(fm.mlp_bwd_rows(x, *w, do), fm.mlp_bwd_rows_plain(x, *w, do),
           torch.bfloat16)
    _agree(fm.mlp_ln_bwd_rows(x, *ln, *w, do),
           fm.mlp_ln_bwd_rows_plain(x, *ln, *w, do), torch.bfloat16)


def _attn_case(N, Dm, Hm, dev, seed=0, Bm=B):
    """bf16 inputs of both attention backward entry points at width Dm."""
    r = np.random.RandomState(seed)
    f = lambda *sh, sc=1.0: torch.from_numpy(
        (r.randn(*sh) * sc).astype(np.float32)).to(dev)
    t = {"x": f(NC, Bm, N, Dm).bfloat16(), "da": f(NC, Bm, N, Dm).bfloat16(),
         "s": torch.from_numpy(r.choice([0.0, 1.0 / 0.9], size=(NC, Bm))
                               .astype(np.float32)).to(dev),
         "lns": f(NC, Dm, sc=0.2) + 1.0, "lnb": f(NC, Dm, sc=0.1),
         "wqkv": f(NC, Dm, 3 * Dm, sc=Dm ** -0.5).bfloat16(),
         "bqkv": f(NC, 3 * Dm, sc=0.1).bfloat16(),
         "wproj": f(NC, Dm, Dm, sc=Dm ** -0.5).bfloat16(),
         "bproj": f(NC, Dm, sc=0.1).bfloat16()}
    t["w"] = [t[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj")]
    return t


def _both_attn_backwards(t, Hm, s="s"):
    """Outputs of ``attn_bwd`` (from the plain forward's saves) and
    ``attn_bwd_recompute``, with their plain versions."""
    sv = t[s] if s else None
    _, P, cat = fa.attn_fwd_plain(t["x"], sv, *t["w"], t["bproj"], Hm)
    a2 = (t["x"], sv, *t["w"], P, cat, t["da"], Hm)
    a5 = (t["x"], *t["w"], t["da"], Hm)
    return {"attn_bwd": (fa.attn_bwd(*a2), fa.attn_bwd_plain(*a2)),
            "attn_bwd_recompute": (fa.attn_bwd_recompute(*a5),
                                   fa.attn_bwd_recompute_plain(*a5))}


@pytest.mark.parametrize("Dm,Hm", [(128, 2), (64, 2), (64, 4)])
@pytest.mark.parametrize("N", [256, 197, 40, 13])
def test_bf16_attention_backward_hopper_path_matches_plain(dev, N, Dm, Hm):
    """head_dim 64, 32 and 16 at N = 256 (the kernels' limit: 16 blocks),
    197 (13 blocks, 5 ragged keys), 40 and 13 (one ragged block): every
    gradient of both entry points, with and without the residual scale."""
    assert fa.uses_sm90(torch.bfloat16, Dm, Hm, N)
    t = _attn_case(N, Dm, Hm, dev, seed=N + Dm + Hm)
    for s in ("s", None):
        for got, ref in _both_attn_backwards(t, Hm, s).values():
            _agree(got, ref, torch.bfloat16)


@pytest.mark.parametrize("N", [197, 13])
def test_bf16_attention_backward_keeps_items_and_clients_apart(dev, N):
    """One item's da zero beside a large neighbour: its dx is exactly 0
    (no key, query or dO row of another item reaches it).  Then client 0's
    da all zero beside a large client 1: every gradient of client 0 is
    exactly 0 (the 3-D tensor maps' zero fill at the ragged last tile)."""
    t = _attn_case(N, D, H, dev, seed=3)
    t["x"][0, 2] *= 50
    t["da"][0, 2] *= 50
    t["da"][0, 1] = 0
    t["s"][:] = 1.0
    for name, (got, ref) in _both_attn_backwards(t, H).items():
        assert torch.count_nonzero(got[0][0, 1]) == 0, name
        assert torch.count_nonzero(got[0][0, 2]) > 0, name
        _agree(got, ref, torch.bfloat16)
    t["x"][1] *= 50
    t["da"][1] *= 50
    t["da"][0] = 0
    for name, (got, _) in _both_attn_backwards(t, H).items():
        for grad in got:
            assert torch.count_nonzero(grad[0]) == 0, name
            assert torch.count_nonzero(grad[1]) > 0, name


@pytest.mark.parametrize("N", [197, 13])
def test_bf16_attention_backward_is_bitwise_reproducible(dev, N):
    """Two calls of each entry point give the same bits (no atomics; 591
    rows a client take two split ranges in dWproj and dWqkv)."""
    t = _attn_case(N, D, H, dev, seed=5)
    if N == 197:
        assert kernels.plan_row_splits(B * N, D, 3 * D)[0] > 1
    first, second = _both_attn_backwards(t, H), _both_attn_backwards(t, H)
    for name in first:
        for a, b in zip(first[name][0], second[name][0]):
            assert torch.equal(a, b), name


def test_bf16_attention_backward_off_the_head_grid_takes_the_old_path(dev):
    """head_dim 48 (D = 96, 2 heads): not a size of the tensor-core head
    kernel, so both entry points run gemm_kernel and the CUDA-core passes,
    held to the plain versions; float32 always does."""
    assert not fa.uses_sm90(torch.bfloat16, 96, 2, 37)
    assert not fa.uses_sm90(torch.float32, D, H, 37)
    t = _attn_case(37, 96, 2, dev, seed=6)
    for got, ref in _both_attn_backwards(t, 2).values():
        _agree(got, ref, torch.bfloat16)


# ------------------------------------- flash attention on tensor cores ----

def _flash_inputs(N, hd, dtype, dev, lead=(2, 3, 2)):
    r = np.random.RandomState(N + hd)
    return [torch.from_numpy(r.randn(*lead, N, hd).astype(np.float32))
            .to(dev).to(dtype) for _ in range(4)]


def _kernels_of(fn):
    """Names of the CUDA kernels that ``fn`` launches, from a profile."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


@pytest.mark.parametrize("hd", [64, 32, 16])
@pytest.mark.parametrize("N", [256, 197, 40, 13, 5])
def test_flash_tensor_core_path_matches_plain(dev, N, hd):
    dt = torch.bfloat16
    assert fl.uses_tensor_cores(dt, N, hd)
    q, k, v, do = _flash_inputs(N, hd, dt, dev)
    scale = hd ** -0.5
    _agree([fl.flash_fwd(q, k, v, scale)],
           [fl.flash_fwd_plain(q, k, v, scale)], dt)
    _agree(fl.flash_bwd(q, k, v, do, scale),
           fl.flash_bwd_plain(q, k, v, do, scale), dt)


@pytest.mark.parametrize("dtype,hd,new", [(torch.bfloat16, 64, True),
                                          (torch.bfloat16, 16, True),
                                          (torch.bfloat16, 48, False),
                                          (torch.float32, 64, False)])
def test_flash_path_choice_by_dtype_and_head_dim(dev, dtype, hd, new):
    """The choice is made in C; the kernel names of a profiled call show
    which path ran: the per-head mma.sync kernels, or the CUDA-core
    attention core and the row / column passes."""
    q, k, v, do = _flash_inputs(37, hd, dtype, dev)
    scale = hd ** -0.5
    assert fl.uses_tensor_cores(dtype, 37, hd) is new
    fwd = _kernels_of(lambda: fl.flash_fwd(q, k, v, scale))
    bwd = _kernels_of(lambda: fl.flash_bwd(q, k, v, do, scale))
    if "kernel" not in fwd:
        pytest.skip("the profiler recorded no kernel on this machine")
    assert ("attn_fwd_head_kernel" in fwd) is new
    assert ("attn_core_fwd_kernel" in fwd) is not new
    assert ("attn_bwd_head_kernel" in bwd) is new
    assert ("flash_bwd_rows_kernel" in bwd) is not new
    assert ("flash_bwd_cols_kernel" in bwd) is not new
    _agree([fl.flash_fwd(q, k, v, scale)],
           [fl.flash_fwd_plain(q, k, v, scale)], dtype)
    _agree(fl.flash_bwd(q, k, v, do, scale),
           fl.flash_bwd_plain(q, k, v, do, scale), dtype)


@pytest.mark.parametrize("N,hd", [(197, 64), (13, 32)])
def test_flash_pairs_are_isolated_and_calls_repeat_bitwise(dev, N, hd):
    """Scaling one pair's q, k, v and do 50x leaves its neighbours' outputs
    and gradients exactly as they were (no read or sum crosses a pair), and
    a second call gives the first call's bits."""
    dt = torch.bfloat16
    q, k, v, do = _flash_inputs(N, hd, dt, dev, lead=(5,))
    scale = hd ** -0.5
    first = (fl.flash_fwd(q, k, v, scale),) + fl.flash_bwd(q, k, v, do, scale)
    again = (fl.flash_fwd(q, k, v, scale),) + fl.flash_bwd(q, k, v, do, scale)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    big = [t.clone() for t in (q, k, v, do)]
    for t in big:
        t[2] *= 50
    q2, k2, v2, do2 = big
    other = (fl.flash_fwd(q2, k2, v2, scale),) + \
        fl.flash_bwd(q2, k2, v2, do2, scale)
    keep = [0, 1, 3, 4]
    for a, b in zip(first, other):
        assert torch.equal(a[keep], b[keep])
        assert not torch.equal(a[2], b[2])


@pytest.mark.parametrize("N,Dm,heads", [(197, 128, 2), (40, 128, 4),
                                        (13, 96, 6), (5, 64, 1)])
def test_forward_core_packed_layout_with_saved_P(dev, N, Dm, heads):
    """``csrc/attn_fwd_core.cuh`` in the fused sublayer's layout (qkv
    [items, N, 3D] in, P [items, H, N, N] and cat [items, N, D] out)
    against the P and cat of ``attn_fwd_plain`` (its ``_probs`` and
    ``_cat`` on the same qkv)."""
    dt = torch.bfloat16
    items = 5
    r = np.random.RandomState(N)
    qkv = torch.from_numpy(r.randn(items, N, 3 * Dm).astype(np.float32)) \
        .to(dev).to(dt)
    P = torch.full((items, heads, N, N), float("nan"), device=dev, dtype=dt)
    cat = torch.full((items, N, Dm), float("nan"), device=dev, dtype=dt)
    err = kernels.library().fc_attn_fwd_core_test(
        items, N, Dm, heads, qkv.data_ptr(), P.data_ptr(), cat.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    qkv5 = qkv.reshape(1, items, N, 3 * Dm)
    P_ref = fa._probs(qkv5, heads).to(dt)
    cat_ref = fa._cat(P_ref, qkv5)[0]
    P_ref = P_ref[0]
    _agree([P, cat], [P_ref, cat_ref], dt)
    # no save: the same cat bits, nothing else written
    cat2 = torch.full_like(cat, float("nan"))
    err = kernels.library().fc_attn_fwd_core_test(
        items, N, Dm, heads, qkv.data_ptr(), None, cat2.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(cat, cat2)


# ------------------------------- the fused route's forwards on Hopper ----

@pytest.mark.parametrize("M,N,K,seq", [(200, 136, 72, 40), (72, 264, 40, 9),
                                       (1000, 24, 600, 125), (197, 384, 384,
                                                              197)])
@pytest.mark.parametrize("epi", ["gelu", "bias", "residual"])
def test_sm90_forward_epilogues_match_f32_reference(dev, epi, M, N, K, seq):
    """``fc_sm90_epilogue_test``: T(gelu(a.w + b)), T(a.w + b) and T(x +
    s[row / seq] * (a.w + b)) per client at M and N off the 128 tiles.  The
    output is poisoned first, and client 1 is 50x client 0, so a tile that
    ran past client 0's last row into client 1 (reading or writing) shows;
    the only differences from the f32 reference are the summation order
    and one bf16 rounding (2^-8 relative)."""
    r = np.random.RandomState(M + N + K)
    f = lambda *sh: torch.from_numpy(r.randn(*sh).astype(np.float32)).to(dev)
    a, w = f(NC, M, K).bfloat16(), (f(NC, K, N) * K ** -0.5).bfloat16()
    bias, x = f(NC, N).bfloat16(), f(NC, M, N).bfloat16()
    a[1] *= 50
    sc = torch.from_numpy(r.choice([0.0, 0.5, 1.0 / 0.9], size=(NC * M // seq,))
                          .astype(np.float32)).to(dev)
    out = torch.full((NC, M, N), float("nan"), device=dev,
                     dtype=torch.bfloat16)
    acc = torch.matmul(a.float(), w.float()) + bias.float()[:, None]
    if epi == "gelu":
        ref = fm.gelu_exact(acc)
    elif epi == "bias":
        ref = acc
    else:
        ref = x.float() + sc.repeat_interleave(seq).reshape(NC, M, 1) * acc
    err = kernels.library().fc_sm90_epilogue_test(
        0 if epi == "gelu" else 1, NC, M, N, K, seq, a.data_ptr(),
        w.data_ptr(), bias.data_ptr(), x.data_ptr(),
        sc.data_ptr() if epi == "residual" else None, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    for c in range(NC):
        d = (out[c].float() - ref[c]).abs()
        assert (d <= 2.0 ** -7 * ref[c].abs() + 1e-3 * ref[c].abs().max()) \
            .all(), (c, d.max().item())


def _fwd_case(n, Bm, N, Dm, dev, seed):
    """bf16 inputs of the attention and the MLP sublayer forward, n clients
    of Bm items."""
    r = np.random.RandomState(seed)
    f = lambda *sh, sc=1.0: torch.from_numpy(
        (r.randn(*sh) * sc).astype(np.float32)).to(dev)
    Fm = 4 * Dm
    t = {"x": f(n, Bm, N, Dm).bfloat16(),
         "s": torch.from_numpy(r.choice([0.0, 1.0 / 0.9], size=(n, Bm))
                               .astype(np.float32)).to(dev),
         "ln": [f(n, Dm, sc=0.2) + 1.0, f(n, Dm, sc=0.1)]}
    t["attn"] = [f(n, Dm, 3 * Dm, sc=Dm ** -0.5).bfloat16(),
                 f(n, 3 * Dm, sc=0.1).bfloat16(),
                 f(n, Dm, Dm, sc=Dm ** -0.5).bfloat16(),
                 f(n, Dm, sc=0.1).bfloat16()]
    t["mlp"] = [f(n, Dm, Fm, sc=Dm ** -0.5).bfloat16(),
                f(n, Fm, sc=0.1).bfloat16(),
                f(n, Fm, Dm, sc=Fm ** -0.5).bfloat16(),
                f(n, Dm, sc=0.1).bfloat16()]
    return t


def _forwards(t, Hm):
    """Outputs of every forward variant of both sublayers on one case, as
    (kernel outputs, plain outputs) by name."""
    x, s, ln = t["x"], t["s"], t["ln"]
    xr = x.reshape(x.shape[0], -1, x.shape[-1])
    both = lambda fn, plain, *a: (fn(*a), plain(*a))
    one = lambda pair: ([pair[0]], [pair[1]])
    return {
        "attn_fwd": both(fa.attn_fwd, fa.attn_fwd_plain, x, s, *ln,
                         *t["attn"], Hm, True),
        "attn_fwd_eval": both(fa.attn_fwd, fa.attn_fwd_plain, x, None, *ln,
                              *t["attn"], Hm, False),
        "attn_fwd_save_nores": both(fa.attn_fwd, fa.attn_fwd_plain, x, None,
                                    *ln, *t["attn"], Hm, True),
        "mlp_fwd": one(both(fm.mlp_fwd, fm.mlp_fwd_plain, x, s, *ln,
                            *t["mlp"])),
        "mlp_fwd_eval": one(both(fm.mlp_fwd, fm.mlp_fwd_plain, x, None, *ln,
                                 *t["mlp"])),
        "mlp_fwd_rows": one(both(fm.mlp_fwd_rows, fm.mlp_fwd_rows_plain, xr,
                                 *t["mlp"])),
        "mlp_ln_fwd_rows": one(both(fm.mlp_ln_fwd_rows,
                                    fm.mlp_ln_fwd_rows_plain, xr, *ln,
                                    *t["mlp"])),
    }


@pytest.mark.parametrize("Dm,Hm", [(128, 2), (384, 12), (768, 12),
                                   (1024, 64), (64, 4)])
@pytest.mark.parametrize("n,N", [(1, 256), (3, 197), (3, 40), (1, 1), (3, 1)])
def test_bf16_forwards_hopper_path_match_plain(dev, n, N, Dm, Hm):
    """head_dim 64, 32, 64, 16, 16 at D = 128 to 1024 (and 64: one ragged
    column tile), n = 1 and 3 clients of 3 items, so a client's rows (768,
    591, 120, 1, 3) are never a multiple of 128 but once: out, P and cat of
    the attention forward (saving with and without the residual, and the
    eval variant), the four MLP forwards; a second call gives the first
    call's bits."""
    dt = torch.bfloat16
    assert fa.uses_sm90(dt, Dm, Hm, N) and fm.uses_sm90(dt, Dm, 4 * Dm)
    t = _fwd_case(n, B, N, Dm, dev, seed=n + N + Dm)
    first, second = _forwards(t, Hm), _forwards(t, Hm)
    for name, (got, ref) in first.items():
        _agree(got, ref, dt)
        for a, b in zip(got, second[name][0]):
            assert (a is None and b is None) or torch.equal(a, b), name
    assert first["attn_fwd_eval"][0][1] is None
    # the eval variant is the saving one without P: the same out and cat
    assert torch.equal(first["attn_fwd_eval"][0][0],
                       first["attn_fwd_save_nores"][0][0])
    assert torch.equal(first["attn_fwd_eval"][0][2],
                       first["attn_fwd_save_nores"][0][2])


def test_bf16_forwards_keep_items_and_clients_apart(dev):
    """One item changed and 50x its neighbours, then client 1 likewise
    with other weights: the other
    items' and client 0's outputs keep their bits (no row, key or scale of
    a neighbour reaches them through a ragged tile)."""
    t = _fwd_case(2, B, 197, D, dev, seed=11)
    base = _forwards(t, H)
    # rolled along the features, so that LN does not undo the change
    t["x"][0, 2] = t["x"][0, 2].roll(1, -1) * 50
    item = _forwards(t, H)
    t["x"][1] = t["x"][1].roll(1, -1) * 50
    for k in ("attn", "mlp"):
        for w in t[k]:
            w[1] *= 3
    client = _forwards(t, H)
    for name in base:
        a, b, c = base[name][0][0], item[name][0][0], client[name][0][0]
        a, b, c = (u.reshape(2, B, 197, D) for u in (a, b, c))
        assert torch.equal(a[0, :2], b[0, :2]), name
        assert not torch.equal(a[0, 2], b[0, 2]), name
        assert torch.equal(b[0], c[0]), name
        assert not torch.equal(b[1], c[1]), name


def test_forward_path_choice_by_dtype_and_shape(dev):
    """The choice is made in C; the kernel names of a profiled call show
    which path ran.  bf16 on the grid launches no ``gemm_kernel`` and no
    ``attn_core_fwd_kernel``; float32, D = 100 (MLP) and head_dim 48
    (attention) launch no ``sm90_gemm_kernel`` and agree with their plain
    versions on the old path."""
    cases = []
    for dtype, Dm, Hm in ((torch.bfloat16, D, H), (torch.float32, D, H),
                          (torch.bfloat16, 96, 2), (torch.bfloat16, 100, 0)):
        t = _fwd_case(2, B, 37, Dm, dev, seed=Dm)
        for k in ("x", "attn", "mlp"):
            t[k] = t[k].to(dtype) if k == "x" else [w.to(dtype) for w in t[k]]
        mlp_new = fm.uses_sm90(dtype, Dm, 4 * Dm)
        attn_new = bool(Hm) and fa.uses_sm90(dtype, Dm, Hm, 37)
        cases.append((dtype, Dm, mlp_new, attn_new))
        m_args = (t["x"], t["s"], *t["ln"], *t["mlp"])
        _agree([fm.mlp_fwd(*m_args)], [fm.mlp_fwd_plain(*m_args)], dtype)
        mlp = _kernels_of(lambda: fm.mlp_fwd(*m_args))
        if "kernel" not in mlp:
            pytest.skip("the profiler recorded no kernel on this machine")
        assert ("sm90_gemm_kernel" in mlp) is mlp_new, (dtype, Dm)
        assert ("gemm_kernel<" in mlp.replace("sm90_gemm_kernel<", "")) \
            is not mlp_new, (dtype, Dm)
        if not Hm:      # D = 100: the MLP alone
            continue
        a_args = (t["x"], t["s"], *t["ln"], *t["attn"], Hm)
        _agree(fa.attn_fwd(*a_args), fa.attn_fwd_plain(*a_args), dtype)
        attn = _kernels_of(lambda: fa.attn_fwd(*a_args))
        assert ("sm90_gemm_kernel" in attn) is attn_new, (dtype, Dm)
        assert ("attn_fwd_head_kernel" in attn) is attn_new, (dtype, Dm)
        assert ("attn_core_fwd_kernel" in attn) is not attn_new, (dtype, Dm)
    assert [c[2:] for c in cases] == [(True, True), (False, False),
                                      (True, False), (False, False)]


# ------------------------------------ long sequences: the keys streamed ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hm", [2, 4, 8])
@pytest.mark.parametrize("N", [257, 300, 333, 512, 513, 1536])
def test_streamed_attention_kernels_match_plain(dev, N, Hm, dtype):
    """Rows 1, 1e, 2 and 5 past the resident kernels' 256 keys at head_dim
    64, 32 and 16: N = 257 (the edge: one key in the last chunk, one query
    in the last block), 300, 333 and 513 (rows of P not 16-byte aligned:
    the bf16 kernels write and read P element by element) and 512 (the
    long line's length) and 1536 (P in TMA tiles); every output, P, cat and
    every gradient against the plain versions, and a second call of each
    in bf16 gives the first call's bits."""
    assert kernels.streams_keys(N)
    t = _inputs(ATTN, N, dtype, dev, seed=N + Hm)
    w = [t[k] for k in ATTN[2:8]]
    for s, save in ((t["s"], True), (None, False)):
        got = fa.attn_fwd(t["x"], s, *w, Hm, save=save)
        _agree(got, fa.attn_fwd_plain(t["x"], s, *w, Hm, save=save), dtype)
        again = fa.attn_fwd(t["x"], s, *w, Hm, save=save)
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    _, P, cat = fa.attn_fwd_plain(t["x"], t["s"], *w, Hm)
    for fn, plain, args in (
            (fa.attn_bwd, fa.attn_bwd_plain,
             (t["x"], t["s"], *w[:5], P, cat, t["do"], Hm)),
            (fa.attn_bwd_recompute, fa.attn_bwd_recompute_plain,
             (t["x"], *w[:5], t["do"], Hm))):
        got = fn(*args)
        _agree(got, plain(*args), dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, fn(*args)))


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 32),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 48),
                                      (torch.float32, 64)])
@pytest.mark.parametrize("N", [257, 300, 333, 512, 513, 1024])
def test_streamed_flash_kernels_match_plain(dev, N, hd, dtype):
    """Rows 11 and 12 past 256 keys, up to the flash route's 1024: the
    tensor-core kernels (bf16 at head_dim 64, 32, 16; N = 300, 333 and 513
    leave a ragged last chunk and block) and the CUDA-core ones (head_dim
    48, float32), forward and every gradient against the plain versions,
    and bitwise repeats."""
    q, k, v, do = _flash_inputs(N, hd, dtype, dev)
    scale = hd ** -0.5
    got = [fl.flash_fwd(q, k, v, scale)]
    _agree(got, [fl.flash_fwd_plain(q, k, v, scale)], dtype)
    assert torch.equal(got[0], fl.flash_fwd(q, k, v, scale))
    got = fl.flash_bwd(q, k, v, do, scale)
    _agree(got, fl.flash_bwd_plain(q, k, v, do, scale), dtype)
    assert all(torch.equal(a, b)
               for a, b in zip(got, fl.flash_bwd(q, k, v, do, scale)))


@pytest.mark.parametrize("N", [300, 512])
def test_streamed_kernels_launched_by_shape(dev, N):
    """Past 256 keys the bf16 entry points launch the Hopper streamed
    kernels (TMA + wgmma, ``csrc/attn_wgmma.cuh``) at N = 300, where P is
    moved element by element, as at N = 512, where it moves in TMA tiles:
    the second path is chosen by shape in C, not taken after a failure."""
    t = _inputs(ATTN, N, torch.bfloat16, dev, seed=N)
    w = [t[k] for k in ATTN[2:8]]
    _, P, cat = fa.attn_fwd_plain(t["x"], t["s"], *w, H)
    q, k, v, do = _flash_inputs(N, 64, torch.bfloat16, dev)
    tiles = str(N == 512).lower()  # P's rows 16-byte aligned
    assert kernels.p_moves_in_tiles(N) is (N == 512)
    calls = {
        f"attn_fwd_head_stream_kernel<64, true, {tiles}>":
            lambda: fa.attn_fwd(t["x"], t["s"], *w, H),
        f"attn_bwd_head_rows_stream_kernel<64, 0, {tiles}>":
            lambda: fa.attn_bwd(t["x"], t["s"], *w[:5], P, cat, t["do"], H),
        "attn_bwd_head_cols_stream_kernel<64, 2, false>":
            lambda: fl.flash_bwd(q, k, v, do, 0.125)}
    for name, call in calls.items():
        launched = _kernels_of(call)
        if "kernel" not in launched:
            pytest.skip("the profiler recorded no kernel on this machine")
        assert name in launched, (name, launched)


def test_flash_route_takes_plain_attention_past_1024(dev):
    """N = 1025 on the flash route runs ``attention_xla`` (no flash launch),
    forward and backward, as the JAX package's ``_fa_fwd`` / ``_fa_bwd``
    do; the fused route's kernel takes the same N."""
    from fedcola_tpu_torch.ops.attention import attention_xla
    q, k, v, do = _flash_inputs(1025, 64, torch.bfloat16, dev, lead=(1, 2))
    leaves = [u.clone().requires_grad_(True) for u in (q, k, v)]
    kernels.reset_launches()
    o = fl.flash_attention(*leaves, 0.125)
    grads = torch.autograd.grad(o, leaves, do)
    assert kernels.LAUNCHES["flash_fwd"] == kernels.LAUNCHES["flash_bwd"] == 0
    ref = attention_xla(*leaves, 0.125)
    assert torch.equal(o, ref)
    for a, b in zip(grads, torch.autograd.grad(ref, leaves, do)):
        assert torch.equal(a, b)
    t = _inputs(ATTN, 1025, torch.bfloat16, dev)
    fa.attn_fwd(t["x"], None, *[t[k] for k in ATTN[2:8]], H, save=False)
    assert kernels.LAUNCHES["attn_fwd"] == 1


def resident_digests(dev):
    """SHA-1 of every bf16 attention entry point's outputs at resident N
    (256, 197, 40; seeded inputs)."""
    from fedcola_tpu_torch.profile_attn_bwd import digest
    out = {}
    for N in (256, 197, 40):
        t = _attn_case(N, D, H, dev, seed=N)
        w = t["w"] + [t["bproj"]]
        out[f"attn_fwd N={N}"] = fa.attn_fwd(t["x"], t["s"], *w, H)
        out[f"attn_fwd eval N={N}"] = fa.attn_fwd(t["x"], None, *w, H,
                                                  save=False)[:1]
        for name, (got, _) in _both_attn_backwards(t, H).items():
            out[f"{name} N={N}"] = got
        q, k, v, do = _flash_inputs(N, 64, torch.bfloat16, dev)
        out[f"flash_fwd N={N}"] = [fl.flash_fwd(q, k, v, 0.125)]
        out[f"flash_bwd N={N}"] = fl.flash_bwd(q, k, v, do, 0.125)
    return {k: digest(v) for k, v in out.items()}


# ``resident_digests`` as the tree before the streamed kernels gave them
# (the parent build, on an NVIDIA H100 80GB HBM3): the kernels that take
# N <= 256 keep their code, so they keep these bits.
RESIDENT_SHA1 = {
    "attn_fwd N=256": "663001895dbd8701753f07c97aa4149e05e70013",
    "attn_fwd eval N=256": "3e67a211c2367a4a7ae7a955e5131c62111cf8dc",
    "attn_bwd N=256": "6f0dd1ceaa5de61912a524b32b7f030a0bd6ab5a",
    "attn_bwd_recompute N=256": "445cdb0eee9cba6879b73e49d916ad55cc520ce9",
    "flash_fwd N=256": "c00f42526b6db74cc6441d83766c30400f512b6a",
    "flash_bwd N=256": "de2953b84ac3119da44cf8edb3425b803e2c401e",
    "attn_fwd N=197": "19530e040ec217ea3b80678b5a05bc7b80aa49f4",
    "attn_fwd eval N=197": "7217a08ee2a3d91acd463a3446c32c7e8aeb4001",
    "attn_bwd N=197": "bd20ccc3d9f6abd17ac40b28306e8c6705c77a65",
    "attn_bwd_recompute N=197": "2bfd361728ecb8f481009ab7539f8c46e1b657d5",
    "flash_fwd N=197": "3a188169793a8f4b3eca4e021b5172041992208d",
    "flash_bwd N=197": "41a6378870efca0f41a3ca4380773c78d3cd1433",
    "attn_fwd N=40": "493c7deadb5be3278f0591ee2fc012d702e8f41c",
    "attn_fwd eval N=40": "af6b2514b15ffc86a5504ae4d42d65c641a7dcc8",
    "attn_bwd N=40": "fb557e23e5689769f817f715a9373380b097c32b",
    "attn_bwd_recompute N=40": "d043067fe367ce695913cc1ccf61e922d41bde3e",
    "flash_fwd N=40": "abca321f6071a69e12ff97e35665238ec9237fe3",
    "flash_bwd N=40": "0f8eabaf7492c205ecf89ad8624dd2c5939d6351",
}


def test_resident_kernels_give_the_same_bits_as_before(dev):
    """Every bf16 attention entry point at N = 256, 197 and 40 gives the
    bits it gave before the streamed variants were added beside it."""
    got = resident_digests(dev)
    assert {k: v for k, v in got.items() if RESIDENT_SHA1[k] != v} == {}
