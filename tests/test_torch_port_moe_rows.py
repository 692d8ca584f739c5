"""The MoE layer's dispatch and combine (``ops/moe_gemm.py``; the card's
row kernels are ``csrc/moe_rows.cu``) on the CPU, where they run their
plain versions:

* forward and every gradient against a dense one-hot reference (the
  buffer as a 0/1 matrix over the tokens, the combine as the matrix of the
  routing weights), and through ``torch.autograd.gradcheck`` in float64,
  over a random routing, a client routed to no held expert and every token
  on one held expert, for n = 1 and 3 stacked clients;
* the dispatch, a per-group scale and the combine together against the
  routing alone, with no use of the plan's layout;
* rows of ``yp`` and ``dxp`` past ``poff[G]`` are never read (filled with
  NaN, the outputs do not change): the contract the kernels rely on, as
  they leave those rows unwritten;
* the kernel wrappers' launch arguments against ``kernels._SIGNATURES``
  (the launch faked, CPU tensors), one ``moe_fused`` count a pass, and
  their refusals; CPU tensors take the plain versions with no launch and
  no count.

Tolerances: float64 on both sides, differing only in the order of sums:
1e-12 relative.  A few seconds on one worker.
"""

import pytest
import torch

from fedcola_tpu_torch.ops import kernels, moe_gemm
from fedcola_tpu_torch.utils import profiling

KINDS = ["ragged", "empty", "one"]
K, HELD, ROUTER, FIRST = 3, 2, 5, 1


def _idx(kind, n, T, gen):
    """Chosen experts ``[n, T, K]`` of the router's ``ROUTER``, the held
    ones ``FIRST .. FIRST + HELD - 1``: ``ragged`` a random routing,
    ``empty`` client 0 on no held expert, ``one`` every token on held
    expert 0 (its other slots off the held range)."""
    idx = torch.rand(n, T, ROUTER, generator=gen).topk(K, dim=-1).indices
    if kind == "empty":
        idx[0] = torch.tensor([0, 3, 4])
    elif kind == "one":
        idx[:] = torch.tensor([FIRST, 3, 4])
    return idx


def _case(kind, n, T=5, D=3, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    idx = _idx(kind, n, T, gen)
    plan = moe_gemm.route_plan(idx, FIRST, HELD)
    x = torch.randn(n * T, D, generator=gen, dtype=dtype)
    w = torch.rand(n * T, K, generator=gen, dtype=dtype) + 0.1
    return idx, plan, x, w


def _dense(plan, w):
    """(S [cap, tokens], M [tokens, cap]): S one on each live row at its
    token, M the routing weight of each held slot at its row (an unheld
    slot's weight lands in a last column, dropped)."""
    tokens, cap = plan.tokens, plan.cap
    S = torch.zeros(cap, tokens, dtype=w.dtype)
    for p, r in enumerate(plan.pair_row.tolist()):
        if r < cap:
            S[r, p // plan.k] = 1.0
    M = torch.zeros(tokens, cap + 1, dtype=w.dtype).scatter(
        1, plan.pair_row.view(tokens, plan.k), w)
    return S, M[:, :cap]


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 3])
def test_dispatch_against_the_one_hot_matrix(kind, n):
    _, plan, x, w = _case(kind, n)
    S, _ = _dense(plan, w)
    x1 = x.clone().requires_grad_(True)
    xp = moe_gemm.dispatch(x1, plan)
    assert torch.equal(xp, S @ x)
    dxp = torch.randn(xp.shape, dtype=xp.dtype,
                      generator=torch.Generator().manual_seed(5))
    xp.backward(dxp)
    assert _rel(x1.grad, S.T @ dxp) < 1e-12
    if kind == "empty":
        # client 0's tokens reach no row: no gradient
        assert not x1.grad[:5].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 3])
def test_combine_against_the_weight_matrix(kind, n):
    _, plan, _, w = _case(kind, n)
    gen = torch.Generator().manual_seed(6)
    yp = torch.randn(plan.cap, 3, generator=gen, dtype=torch.float64)
    yp1, w1 = yp.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = moe_gemm.combine(yp1, w1, plan)
    yp2, w2 = yp.clone().requires_grad_(True), w.clone().requires_grad_(True)
    _, M = _dense(plan, w2)
    want = M @ yp2
    assert out.dtype == torch.float64
    assert _rel(out, want) < 1e-12
    dout = torch.randn(out.shape, dtype=out.dtype, generator=gen)
    out.backward(dout)
    want.backward(dout)
    assert _rel(yp1.grad, yp2.grad) < 1e-12
    assert _rel(w1.grad, w2.grad) < 1e-12
    # rows no pair reads (padding, past poff[G]) get no gradient
    read = torch.zeros(plan.cap, dtype=torch.bool)
    read[plan.pair_row[plan.pair_row < plan.cap]] = True
    assert not yp1.grad[~read].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 3])
def test_gradcheck_in_float64(kind, n):
    _, plan, x, w = _case(kind, n, T=4, D=2)
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    assert torch.autograd.gradcheck(
        lambda a: moe_gemm._Dispatch.apply(a, pr, rp, po, k),
        (x.requires_grad_(True),))
    yp = torch.randn(plan.cap, 2, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    assert torch.autograd.gradcheck(
        lambda a, b: moe_gemm._Combine.apply(a, b, pr, rp, po, k),
        (yp.requires_grad_(True), w.requires_grad_(True)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 3])
def test_dispatch_scale_combine_against_the_routing(kind, n):
    """Each group's rows scaled by its own factor between the dispatch and
    the combine: token t gets ``sum_j w[t, j] c[g(t, j)] x[t]`` over its
    held slots, ``g`` the (client, held expert) group of the slot's expert,
    whatever rows the plan gave the pairs."""
    idx, plan, x, w = _case(kind, n)
    G = n * HELD
    c = torch.arange(1, G + 1, dtype=torch.float64)
    po = plan.poff.tolist()
    scale = torch.zeros(plan.cap, 1, dtype=torch.float64)
    for g in range(G):
        scale[po[g]:po[g + 1]] = c[g]
    out = moe_gemm.combine(moe_gemm.dispatch(x, plan) * scale, w, plan)
    T = x.shape[0] // n
    want = torch.zeros_like(x)
    for t in range(n * T):
        for j in range(K):
            e = int(idx.reshape(n * T, K)[t, j]) - FIRST
            if 0 <= e < HELD:
                want[t] += w[t, j] * c[(t // T) * HELD + e] * x[t]
    assert _rel(out, want) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_past_the_groups_are_never_read(kind, dtype):
    """``yp`` and ``dxp`` NaN past ``poff[G]``: the combine, its backward
    and the dispatch's backward give the bits they give on zeros there."""
    _, plan, x, w = _case(kind, 3, T=40, D=16, dtype=dtype)
    w = w.float()
    L = int(plan.poff[-1])
    assert L < plan.cap
    gen = torch.Generator().manual_seed(3)
    yp = torch.randn(plan.cap, 16, generator=gen).to(dtype)
    dxp = torch.randn(plan.cap, 16, generator=gen).to(dtype)
    dout = torch.randn(plan.tokens, 16, generator=gen)
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    runs = []
    for fill in (0.0, float("nan")):
        y, d = yp.clone(), dxp.clone()
        y[L:], d[L:] = fill, fill
        dyp, dw = moe_gemm.combine_bwd_plain(dout, y, w, pr, rp, po, k)
        runs.append([moe_gemm.combine_plain(y, w, pr, k),
                     moe_gemm.dispatch_bwd_plain(d, pr, k), dyp[:L], dw])
    for a, b in zip(*runs):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


def _fake_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    return calls


def _bf16_case():
    _, plan, x, w = _case("ragged", 3, T=40, D=16, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    yp = torch.randn(plan.cap, 16, generator=gen).bfloat16()
    dout = torch.randn(plan.tokens, 16, generator=gen)
    return plan, x, w.float(), yp, dout


def _kernel_call(name, plan, x, w, yp, dout):
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    if name == "moe_dispatch_fwd":
        return moe_gemm.dispatch_kernel(x, pr, rp, po, k), (x, rp, po)
    if name == "moe_dispatch_bwd":
        return moe_gemm.dispatch_bwd_kernel(yp, pr, k), (yp, pr)
    if name == "moe_combine_fwd":
        return moe_gemm.combine_kernel(yp, w, pr, k), (yp, w, pr)
    return (moe_gemm.combine_bwd_kernel(dout, yp, w, pr, rp, po, k),
            (dout, w, yp, pr, rp, po))


ROW_KERNELS = ["moe_dispatch_fwd", "moe_dispatch_bwd", "moe_combine_fwd",
               "moe_combine_bwd"]


@pytest.mark.parametrize("name", ROW_KERNELS)
def test_launch_arguments(monkeypatch, name):
    """The wrapper's arguments match the entry point's ctypes signature
    (the stream comes last, from ``launch``), its ints are the shapes and
    its pointers the inputs then the outputs it allocated; one
    ``moe_fused`` count a pass."""
    plan, x, w, yp, dout = _bf16_case()
    calls = _fake_launch(monkeypatch)
    timer = profiling.Timer()
    with timer.recording():
        out, inputs = _kernel_call(name, plan, x, w, yp, dout)
    assert timer.counters["moe_fused"] == 1
    assert [c[0] for c in calls] == [name]
    args = calls[0][1]
    sig = kernels._SIGNATURES["fc_" + name]
    assert len(args) + 1 == len(sig)
    ints = [a for a, t in zip(args, sig) if t is kernels._I]
    ptrs = [a for a, t in zip(args, sig) if t is kernels._P]
    assert len(ints) + len(ptrs) == len(args)
    T, cap, G = plan.tokens, plan.cap, plan.groups
    assert ints == {"moe_dispatch_fwd": [T, K, 16, G, cap],
                    "moe_dispatch_bwd": [T, K, 16, cap],
                    "moe_combine_fwd": [T, K, 16, cap],
                    "moe_combine_bwd": [T, K, 16, G, cap]}[name]
    outs = list(out) if isinstance(out, tuple) else [out]
    assert ptrs == [t.data_ptr() for t in list(inputs) + outs]
    shapes = {"moe_dispatch_fwd": [(cap, 16)], "moe_dispatch_bwd": [(T, 16)],
              "moe_combine_fwd": [(T, 16)],
              "moe_combine_bwd": [(cap, 16), (T, K)]}[name]
    assert [tuple(t.shape) for t in outs] == shapes
    dtypes = {"moe_dispatch_fwd": [torch.bfloat16],
              "moe_dispatch_bwd": [torch.bfloat16],
              "moe_combine_fwd": [torch.float32],
              "moe_combine_bwd": [torch.bfloat16, torch.float32]}[name]
    assert [t.dtype for t in outs] == dtypes


@pytest.mark.parametrize("fault", ["float32", "slots", "width", "strided",
                                   "misaligned", "weights"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch,
                                                           fault):
    plan, x, w, yp, dout = _bf16_case()
    _fake_launch(monkeypatch)
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    with pytest.raises((TypeError, ValueError)):
        if fault == "float32":
            moe_gemm.dispatch_kernel(x.float(), pr, rp, po, k)
        elif fault == "slots":
            # a token's slots live in one warp's lanes
            moe_gemm.combine_kernel(yp, w.repeat(1, 11), pr.repeat(11),
                                    k * 11)
        elif fault == "width":
            moe_gemm.dispatch_bwd_kernel(yp[:, :12].contiguous(), pr, k)
        elif fault == "strided":
            moe_gemm.combine_kernel(yp.T.contiguous().T, w, pr, k)
        elif fault == "misaligned":
            flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
            moe_gemm.dispatch_kernel(flat[1:].view(x.shape), pr, rp, po, k)
        else:
            moe_gemm.combine_bwd_kernel(dout, yp, w.double(), pr, rp, po, k)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the layer's dispatch and combine, forward and backward,
    run the plain versions: their bits, no launch, no ``moe_fused``."""
    plan, x, w, yp, dout = _bf16_case()
    kernels.reset_launches()
    timer = profiling.Timer()
    x1 = x.clone().requires_grad_(True)
    w1 = w.clone().requires_grad_(True)
    with timer.recording():
        xp = moe_gemm.dispatch(x1, plan)
        out = moe_gemm.combine(xp * 2, w1, plan)
        out.backward(dout)
    pr, rp, po, k = plan.pair_row, plan.row_pair, plan.poff, plan.k
    want_xp = moe_gemm.dispatch_plain(x, pr, rp, po, k)
    assert torch.equal(xp, want_xp)
    assert torch.equal(out, moe_gemm.combine_plain(want_xp * 2, w, pr, k))
    dyp, dw = moe_gemm.combine_bwd_plain(dout, want_xp * 2, w, pr, rp, po, k)
    assert torch.equal(w1.grad, dw)
    assert torch.equal(x1.grad, moe_gemm.dispatch_bwd_plain(dyp * 2, pr, k))
    assert "moe_fused" not in timer.counters
    assert not any(kernels.LAUNCHES.values())
