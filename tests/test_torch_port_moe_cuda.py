"""The routed experts' grouped GEMM (``csrc/moe_gemm.cu`` through
``ops/moe_gemm.py``) against its plain version on the card: the forward
(y, and the kept g and u), dX and the three per-group weight gradients;
y in bfloat16 and in float32; ragged groups from a random routing, groups
left empty, and every token on one expert, over n = 1 and 3 stacked
clients; a repeat gives the same bits; a routing plan, dispatch, experts
and combine with no host readback of the routing counts.  The dispatch
and combine row kernels (``csrc/moe_rows.cu``) against their plain
versions at the same routings and at the Moonlight cell's image and text
steps: bit for bit but for dw (within 1e-5 of its norm: another order of
its sums), padding rows zero, nothing past ``poff[G]`` read (NaN there),
a repeat's bits, and a layer's four passes each on its kernel and counted
in ``moe_fused``.

Both sides take the same bf16 buffer and weights and accumulate in
float32; they differ in the order of the sums and in the roundings to
bf16 that follow from it, so a bf16 output agrees within 1e-2 of its norm
(a bf16 ulp is 2^-8 = 0.0039 relative), the f32 weight gradients within
5e-3 (they sum rows rounded on either side).

Marked ``cuda``: every test skips without a CUDA device.  This file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_moe_cuda.py
"""

import pytest
import torch

from fedcola_tpu_torch.ops import kernels, moe_gemm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _idx(kind, n, T, k, router, held, gen, dev):
    """Chosen experts ``[n, T, k]``: ``ragged`` a random routing (distinct
    experts a token), ``empty`` client 0 on no held expert, ``one`` every
    token on held expert 0 (its other slots off the held range)."""
    scores = torch.rand(n, T, router, generator=gen, device=dev)
    idx = scores.topk(k, dim=-1).indices
    if kind == "empty":
        idx[0] = torch.arange(held, held + k, device=dev)
    elif kind == "one":
        idx[:] = torch.arange(held - 1, held - 1 + k, device=dev)
        idx[..., 0] = 0
    return idx


def _case(kind, n, D, F, T, dev, seed=0, k=6, router=16, held=4):
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = _idx(kind, n, T, k, router, held, gen, dev)
    plan = moe_gemm.route_plan(idx, 0, held)
    x = torch.randn(n * T, D, generator=gen, device=dev).bfloat16()
    xp = moe_gemm.dispatch(x, plan)
    G = n * held
    w = [(torch.randn(G, a, b, generator=gen, device=dev) * a ** -0.5)
         .bfloat16() for a, b in ((D, F), (D, F), (F, D))]
    dy = torch.randn(plan.cap, D, generator=gen, device=dev).bfloat16()
    return plan, xp, w, dy


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _live(t, plan):
    """The rows a group holds (the kernel leaves rows past poff[G] unset)."""
    return t[:int(plan.poff[-1])]


@pytest.mark.parametrize("kind", ["ragged", "empty", "one"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_forward(dev, kind, n, out):
    plan, xp, (wg, wu, wd), _ = _case(kind, n, 256, 192, 300, dev)
    got = moe_gemm.glu_fwd_kernel(xp, wg, wu, wd, plan.poff, True, out)
    want = moe_gemm.glu_fwd_plain(xp, wg, wu, wd, plan.poff, True, out)
    assert got[0].dtype == out
    for name, a, b in zip(("y", "h", "g", "u"), got, want):
        assert _rel(_live(a, plan), _live(b, plan)) < 1e-2, name


@pytest.mark.parametrize("kind", ["ragged", "empty", "one"])
@pytest.mark.parametrize("n", [1, 3])
def test_backward(dev, kind, n):
    plan, xp, (wg, wu, wd), dy = _case(kind, n, 256, 192, 300, dev)
    _, _, g, u = moe_gemm.glu_fwd_plain(xp, wg, wu, wd, plan.poff, True,
                                        torch.bfloat16)
    dy = _live(dy, plan).contiguous()
    dy = torch.cat([dy, dy.new_zeros(plan.cap - len(dy), dy.shape[1])])
    got = moe_gemm.glu_bwd_kernel(dy, xp, wg, wu, wd, g, u, plan.poff)
    want = moe_gemm.glu_bwd_plain(dy, xp, wg, wu, wd, g, u, plan.poff)
    assert _rel(_live(got[0], plan), _live(want[0], plan)) < 1e-2, "dx"
    for name, a, b in zip(("dwg", "dwu", "dwd"), got[1:], want[1:]):
        assert a.dtype == torch.float32
        assert _rel(a, b) < 5e-3, name
    if kind == "empty":
        # client 0's groups hold no rows: their gradients are zero
        held = 4
        for a in got[1:]:
            assert not a[:held].any()


def test_real_width_and_repeat(dev):
    """Moonlight's widths (D 2048, F 1408) at an image step's share of
    rows; two runs give the same bits."""
    plan, xp, (wg, wu, wd), dy = _case("ragged", 1, 2048, 1408, 2400, dev,
                                       router=64, held=8)
    dy = torch.cat([_live(dy, plan),
                    dy.new_zeros(plan.cap - int(plan.poff[-1]), 2048)])
    runs = []
    for _ in range(2):
        f = moe_gemm.glu_fwd_kernel(xp, wg, wu, wd, plan.poff, True,
                                    torch.bfloat16)
        b = moe_gemm.glu_bwd_kernel(dy, xp, wg, wu, wd, f[2], f[3],
                                    plan.poff)
        runs.append([_live(f[0], plan)] + [_live(b[0], plan)] + list(b[1:]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want = moe_gemm.glu_fwd_plain(xp, wg, wu, wd, plan.poff, True,
                                  torch.bfloat16)
    assert _rel(runs[0][0], _live(want[0], plan)) < 1e-2
    wb = moe_gemm.glu_bwd_plain(dy, xp, wg, wu, wd, want[2], want[3],
                                plan.poff)
    for a, b in zip(runs[0][2:], wb[1:]):
        assert _rel(a, b) < 5e-3


def _rows_case(kind, n, D, T, dev, seed=0, router=16, held=4):
    """A plan and the row kernels' inputs: x, weights and dout, and the
    buffers yp and dxp with NaN past ``poff[G]`` (nothing there may be
    read)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = _idx(kind, n, T, 6, router, held, gen, dev)
    plan = moe_gemm.route_plan(idx, 0, held)
    L = int(plan.poff[-1])
    x = torch.randn(n * T, D, generator=gen, device=dev).bfloat16()
    yp, dxp = (torch.randn(plan.cap, D, generator=gen, device=dev)
               .bfloat16() for _ in range(2))
    yp[L:] = float("nan")
    dxp[L:] = float("nan")
    w = torch.rand(n * T, 6, generator=gen, device=dev) + 0.05
    dout = torch.randn(n * T, D, generator=gen, device=dev)
    return plan, x, yp, dxp, w, dout


def _rows_agree(plan, x, yp, dxp, w, dout):
    """Each row kernel against its plain version: xp, the combine, dx and
    dyp bit for bit on rows [0, poff[G]) (padding rows zero), dw within
    1e-5 of its norm; a second call gives the same bits."""
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    L = int(po[-1])
    pad = rp[:L] >= pr.numel()
    runs = []
    for _ in range(2):
        dyp, dw = moe_gemm.combine_bwd_kernel(dout, yp, w, pr, rp, po, k)
        runs.append([moe_gemm.dispatch_kernel(x, pr, rp, po, k)[:L],
                     moe_gemm.combine_kernel(yp, w, pr, k),
                     moe_gemm.dispatch_bwd_kernel(dxp, pr, k), dyp[:L], dw])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    xp, out, dx, dyp, dw = runs[0]
    want_dyp, want_dw = moe_gemm.combine_bwd_plain(dout, yp, w, pr, rp, po,
                                                   k)
    assert torch.equal(xp, moe_gemm.dispatch_plain(x, pr, rp, po, k)[:L])
    assert torch.equal(out, moe_gemm.combine_plain(yp, w, pr, k))
    assert torch.equal(dx, moe_gemm.dispatch_bwd_plain(dxp, pr, k))
    assert torch.equal(dyp, want_dyp[:L])
    assert _rel(dw, want_dw) < 1e-5
    for t in (xp, dyp):
        assert not t[pad].any()
    for t in (out, dx, dw):
        assert torch.isfinite(t.float()).all()


@pytest.mark.parametrize("kind", ["ragged", "empty", "one"])
@pytest.mark.parametrize("n", [1, 3])
def test_row_kernels(dev, kind, n):
    _rows_agree(*_rows_case(kind, n, 256, 300, dev))


@pytest.mark.parametrize("T", [96 * 197, 96 * 40])
def test_row_kernels_at_the_moonlight_steps(dev, T):
    """Moonlight's widths (D 2048, top-6, 8 held of 64) at an image step's
    and a text step's tokens."""
    _rows_agree(*_rows_case("ragged", 1, 2048, T, dev, router=64, held=8))


def test_layer_counts_every_pass(dev):
    """A layer's forward and backward on the card: the dispatch and the
    combine each way take their row kernel, one launch each and four
    ``moe_fused`` counts."""
    from fedcola_tpu_torch.utils import profiling
    plan, x0, _, _, wts, _ = _rows_case("ragged", 2, 256, 300, dev)
    ws = [torch.randn(plan.groups, a, b, device=dev) * a ** -0.5
          for a, b in ((256, 128), (256, 128), (128, 256))]
    x = x0.clone().requires_grad_(True)
    names = ("moe_dispatch_fwd", "moe_combine_fwd", "moe_dispatch_bwd",
             "moe_combine_bwd")
    before = {k: kernels.LAUNCHES[k] for k in names}
    timer = profiling.Timer(cuda=True)
    with timer.recording():
        yp = moe_gemm.grouped_glu(moe_gemm.dispatch(x, plan), *ws, plan.poff)
        moe_gemm.combine(yp, wts, plan).square().sum().backward()
    assert timer.counters["moe_fused"] == 4
    assert all(kernels.LAUNCHES[k] == before[k] + 1 for k in names)
    assert torch.isfinite(x.grad.float()).all()


def test_layer_repeats_without_readback(dev):
    """Routing plan, dispatch, grouped GLU and combine, forward and
    backward, in a stream capture (which refuses a host readback), twice
    with the same bits; one launch each way."""
    n, T, D, F, k, held = 2, 500, 256, 128, 6, 4
    gen = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.randn(n * T, D, generator=gen, device=dev).bfloat16()
    wts = torch.rand(n * T, k, generator=gen, device=dev)
    ws = [torch.randn(n * held, a, b, generator=gen, device=dev) * a ** -0.5
          for a, b in ((D, F), (D, F), (F, D))]
    idx = torch.rand(n, T, 16, generator=gen, device=dev).topk(k, -1).indices

    def layer():
        x = x0.clone().requires_grad_(True)
        w = [t.clone().requires_grad_(True) for t in ws]
        plan = moe_gemm.route_plan(idx, 0, held)
        yp = moe_gemm.grouped_glu(moe_gemm.dispatch(x, plan), *w, plan.poff)
        out = moe_gemm.combine(yp, wts, plan)
        out.square().sum().backward()
        return [out.detach(), x.grad] + [t.grad for t in w]

    layer()                                   # builds and warms up
    before = dict(kernels.LAUNCHES)
    a = layer()
    for name in ("moe_gemm_fwd", "moe_gemm_bwd", "moe_dispatch_fwd",
                 "moe_dispatch_bwd", "moe_combine_fwd", "moe_combine_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        # a readback inside a capture raises: the plan, the routed experts
        # and the row kernels read their counts on the device only
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            plan = moe_gemm.route_plan(idx, 0, held)
            yp = moe_gemm.grouped_glu(moe_gemm.dispatch(x0, plan),
                                      *[t.bfloat16() for t in ws], plan.poff)
            out = moe_gemm.combine(yp, wts, plan)
            moe_gemm.dispatch_bwd_kernel(yp, plan.pair_row, k)
            moe_gemm.combine_bwd_kernel(out, yp, wts, plan.pair_row,
                                        plan.row_pair, plan.poff, k)
    b = layer()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_refuses(dev):
    plan, xp, (wg, wu, wd), _ = _case("ragged", 1, 256, 192, 100, dev)
    with pytest.raises(TypeError):
        moe_gemm.glu_fwd_kernel(xp.float(), wg.float(), wu.float(),
                                wd.float(), plan.poff, False, torch.float32)
    with pytest.raises(ValueError):
        moe_gemm.glu_fwd_kernel(xp, wg[:, :, :100], wu[:, :, :100],
                                wd[:, :100], plan.poff, False,
                                torch.bfloat16)


def test_remat_recompute_repeats_the_forward(dev, monkeypatch):
    """A remat 'full' recompute in the backward gives the forward's bits:
    at Moonlight's widths (the dense layer and one MoE layer) and an image
    step (B 96, N 197), every MLA output and every routing of the
    recompute equals the forward's.  The cuDNN attention backend does not
    (about 0.2 % of the MLA outputs differ), so the block holds SDPA to
    the memory-efficient backend."""
    from fedcola_tpu_torch.models import moe
    from fedcola_tpu_torch.models.mat import MATConfig
    from fedcola_tpu_torch.models.registry import MOONLIGHT_SIZES
    cfg = MATConfig(block="moonlight",
                    **dict(MOONLIGHT_SIZES["mome_moonlight_a3b"], depth=2),
                    modalities=("img", None), tasks=("cls", None),
                    num_classes=(100, None), compute_dtype="bfloat16",
                    vocab_size=30522, max_text_len=40)
    assert cfg.remat_policy == "full"
    blk = {k: v.unsqueeze(0).to(dev).requires_grad_(True) for k, v in
           moe.init_stack(cfg, torch.Generator().manual_seed(0)).items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 96, 197, 2048, generator=gen,
                    device=dev).bfloat16().requires_grad_(True)
    seen = {True: [], False: []}

    def keep(fn):
        def run(*a):
            out = fn(*a)
            first = out[0] if isinstance(out, tuple) else out
            recompute = torch._C._current_graph_task_id() != -1
            seen[recompute].append(first.detach().clone())
            return out
        return run

    monkeypatch.setattr(moe, "mla", keep(moe.mla))
    monkeypatch.setattr(moe, "route", keep(moe.route))
    moe.run_stack(cfg, blk, x, True, None).float().square().mean().backward()
    # the recompute runs the layers last first
    fwd, re = seen[False], seen[True]
    assert len(fwd) == len(re) == 3           # two MLAs, one routing
    for a, b in zip(fwd, [re[2], re[0], re[1]]):
        assert torch.equal(a, b)
