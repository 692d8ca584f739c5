"""The routed experts of an MoE layer over stacked clients: the routing
plan, the dispatch of token rows to the held experts, the grouped GEMM
(kernel ``csrc/moe_gemm.cu``) and the combine back to token order.

A group is one (client, held expert) pair: ``G = n x held`` groups.  The
plan (:func:`route_plan`) lays a layer's token-expert pairs out as rows of
one buffer, group after group, each group's rows padded to a multiple of
``BM`` (128, the kernel's row tile) with zero rows, so that a row tile
never straddles two groups and a weight-gradient sum over a group's rows
reads only its own rows (the padding adds zeros).  The buffer holds
``cap`` rows, the most any routing can ask for: every token on
``min(top_k, held)`` held experts, plus a group's padding; the group
offsets ``poff [G + 1]`` live on the device and nothing reads them on the
host, so a step does no readback of the routing counts.  No pair is
dropped.

* :func:`dispatch` gathers each pair's token row (the padding gathers a
  zero row); its backward sums a token's rows over its ``top_k`` slots in
  slot order, in float32.
* :func:`grouped_glu` is ``down(silu(x gate_e) * (x up_e))`` of every
  row by its group's expert ``e``: bf16 operands, f32 accumulation.  On
  CUDA tensors one launch of ``fc_moe_gemm_fwd`` (gate and up in one dual
  product with the SiLU-mul epilogue, then down) and one of
  ``fc_moe_gemm_bwd`` (dH with the SiLU-mul backward in its epilogue, dX,
  and each group's dW of the three kernels) run; the CPU runs the plain
  version :func:`glu_fwd_plain` / :func:`glu_bwd_plain`, which rounds where
  the kernel rounds.
* :func:`combine` is ``sum_j w[t, j] * y[row(t, j)]`` over a token's slots
  in slot order, in float32; its backward writes each row once.

The dispatch and the combine, each way, run on CUDA tensors one launch of
a row kernel (``csrc/moe_rows.cu``: ``fc_moe_dispatch_fwd``,
``fc_moe_dispatch_bwd``, ``fc_moe_combine_fwd``, ``fc_moe_combine_bwd``)
that touches only the rows ``[0, poff[G])`` and the held pairs, counted in
the round's ``moe_fused``; the CPU runs the plain versions
(:func:`dispatch_plain`, :func:`combine_plain` and their backwards), which
write every row of the buffer and whose bits the kernels give (all but
the combine backward's dw, summed in another fixed order).  The kernels
leave the buffer's rows past ``poff[G]`` unwritten: nothing reads them.

Every sum has one writer and a fixed order, so a step is bitwise
repeatable.  The kernels replace no TPU kernel: the JAX package has no MoE
layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor

BM = 128            # the kernel's row tile: a group's rows are padded to it
MAX_SLOTS = 32      # the row kernels keep a token's slots in a warp's lanes


@dataclass(frozen=True)
class RoutePlan:
    """Where each token-expert pair of a layer lies in the expert buffer.

    ``pair_row [P]``: the buffer row of pair ``p = token * k + slot``, or
    ``cap`` (a zero row) where the pair's expert is not held here;
    ``row_pair [cap]``: the pair of each buffer row, or ``P`` on a padding
    row; ``poff [G + 1]`` int32: each group's first row (multiples of
    ``BM``); ``counts [G]``: the pairs of each group."""
    tokens: int          # n x T
    k: int
    groups: int
    cap: int
    pair_row: Tensor
    row_pair: Tensor
    poff: Tensor
    counts: Tensor


def capacity(tokens: int, k: int, held: int, groups: int) -> int:
    """Rows the buffer needs at most: each token on ``min(k, held)`` held
    experts, and each group's padding to ``BM``; a multiple of ``BM``."""
    rows = tokens * min(k, held) + groups * (BM - 1)
    return -(-rows // BM) * BM


def route_plan(idx: Tensor, first: int, held: int) -> RoutePlan:
    """The plan of the chosen experts ``idx [n, T, k]`` (expert numbers of
    the router's range) for the experts ``first .. first + held - 1``:
    group ``c * held + e`` holds client ``c``'s pairs on held expert ``e``,
    in token order.  Device operations only."""
    n, T, k = idx.shape
    dev = idx.device
    P, G = n * T * k, n * held
    cap = capacity(n * T, k, held, G)
    local = idx.long() - first
    mine = (local >= 0) & (local < held)
    client = torch.arange(n, device=dev)[:, None, None]
    gid = torch.where(mine, client * held + local,
                      torch.full_like(local, G)).reshape(P)
    counts = torch.zeros(G + 1, dtype=torch.long, device=dev).scatter_add_(
        0, gid, torch.ones_like(gid))[:G]
    padded = (counts + BM - 1) // BM * BM
    poff = torch.zeros(G + 1, dtype=torch.long, device=dev)
    poff[1:] = torch.cumsum(padded, 0)
    start = torch.cumsum(counts, 0) - counts
    order = torch.sort(gid, stable=True).indices
    gs = gid[order]
    gc = gs.clamp(max=max(G - 1, 0))
    rank = torch.arange(P, device=dev) - start[gc]
    dest = torch.where(gs < G, poff[gc] + rank, torch.full_like(gs, cap))
    row_pair = torch.full((cap + 1,), P, dtype=torch.long, device=dev)
    row_pair[dest] = order          # held pairs' rows are distinct
    pair_row = torch.empty(P, dtype=torch.long, device=dev)
    pair_row[order] = dest
    return RoutePlan(n * T, k, G, cap, pair_row, row_pair[:cap],
                     poff.to(torch.int32), counts)


def _pad_row(x: Tensor) -> Tensor:
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _slot_sum(rows: Tensor, pair_row: Tensor, k: int, weight=None) -> Tensor:
    """``sum_j weight[t, j] * rows[pair_row[t * k + j]]`` in float32 (float64
    for float64 rows), slot by slot (``rows`` carries a last zero row at
    index ``cap``)."""
    acc = torch.promote_types(rows.dtype, torch.float32)
    at = pair_row.view(-1, k)
    out = None
    for j in range(k):
        r = rows[at[:, j]].to(acc)
        if weight is not None:
            r = r * weight[:, j, None]
        out = r if out is None else out + r
    return out


# The plan's tensors go through save_for_backward: under remat 'full' the
# backward then reads the recomputed forward's plan, the one its saved
# buffers were laid out by, even where a recompute routes a near tie
# otherwise (a library product need not repeat its bits).
class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair_row, row_pair, poff, k: int):
        ctx.k = k
        ctx.save_for_backward(pair_row)
        return dispatch_fwd(x, pair_row, row_pair, poff, k)

    @staticmethod
    def backward(ctx, dxp):
        (pair_row,) = ctx.saved_tensors
        with span("moe.dispatch", timed=False, device=True):
            dx = dispatch_bwd(dxp.contiguous(), pair_row, ctx.k)
        return dx, None, None, None, None


def dispatch(x: Tensor, plan: RoutePlan) -> Tensor:
    """Token rows ``x [n*T, D]`` -> the expert buffer ``[cap, D]``."""
    return _Dispatch.apply(x, plan.pair_row, plan.row_pair, plan.poff,
                           plan.k)


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, yp, w, pair_row, row_pair, poff, k: int):
        ctx.k = k
        ctx.save_for_backward(yp, w, pair_row, row_pair, poff)
        return combine_fwd(yp, w, pair_row, k)

    @staticmethod
    def backward(ctx, dout):
        yp, w, pair_row, row_pair, poff = ctx.saved_tensors
        with span("moe.combine", timed=False, device=True):
            dyp, dw = combine_bwd(dout.contiguous(), yp, w, pair_row,
                                  row_pair, poff, ctx.k)
        return dyp, dw, None, None, None, None


def combine(yp: Tensor, w: Tensor, plan: RoutePlan) -> Tensor:
    """The buffer's rows ``yp [cap, D]`` back to token order, weighted by
    ``w [n*T, k]`` (float32): ``[n*T, D]`` float32."""
    return _Combine.apply(yp, w, plan.pair_row, plan.row_pair, plan.poff,
                          plan.k)


# ----------------------------------------------------------- plain ---------

def dispatch_plain(x, pair_row, row_pair, poff, k: int):
    """``xp [cap, D]``: each row its pair's token row of ``x``, a padding
    row (and every row past ``poff[G]``) zeros."""
    tokens = pair_row.numel() // k
    src = torch.where(row_pair < pair_row.numel(), row_pair // k,
                      torch.full_like(row_pair, tokens))
    return _pad_row(x)[src]


def dispatch_bwd_plain(dxp, pair_row, k: int):
    """``dx [n*T, D]``: a token's rows of ``dxp`` summed in float32 in slot
    order, in dxp's dtype."""
    return _slot_sum(_pad_row(dxp), pair_row, k).to(dxp.dtype)


def combine_plain(yp, w, pair_row, k: int):
    """``sum_j w[t, j] * yp[pair_row[t * k + j]]``, slot by slot, in
    float32 (float64 for float64 operands)."""
    return _slot_sum(_pad_row(yp), pair_row, k, w)


def combine_bwd_plain(dout, yp, w, pair_row, row_pair, poff, k: int):
    """(dyp, dw): ``dyp[row] = w[pair] * dout[token]`` in yp's dtype, zeros
    on padding rows and past ``poff[G]``; ``dw[t, j] = yp[row] . dout[t]``,
    zero where the slot's expert is not held."""
    P = pair_row.numel()
    tok = torch.where(row_pair < P, row_pair // k,
                      torch.full_like(row_pair, P // k))
    wr = torch.cat([w.reshape(P), w.new_zeros(1)])[row_pair]
    dyp = (_pad_row(dout)[tok] * wr[:, None]).to(yp.dtype)
    ypad = _pad_row(yp)
    at = pair_row.view(-1, k)
    dw = torch.stack([(ypad[at[:, j]].to(dout.dtype) * dout).sum(-1)
                      for j in range(k)], dim=1)
    return dyp, dw


def _groups(poff: Tensor):
    po = poff.tolist()
    return [(g, po[g], po[g + 1]) for g in range(len(po) - 1)
            if po[g + 1] > po[g]]


def glu_fwd_plain(xp, wg, wu, wd, poff, save: bool, out_dtype):
    """(y, h, g, u): ``g = x wg_e``, ``u = x wu_e`` in f32 (kept rounded to
    x's dtype when ``save``), ``h = T(silu(g) u)``, ``y = h wd_e`` rounded
    to ``out_dtype``, per group's rows; rows past ``poff[G]`` are zero."""
    cap, D = xp.shape
    Fh = wg.shape[-1]
    dt = xp.dtype
    y = xp.new_zeros((cap, D), dtype=out_dtype)
    h = xp.new_zeros((cap, Fh))
    g = xp.new_zeros((cap, Fh)) if save else None
    u = xp.new_zeros((cap, Fh)) if save else None
    for grp, a, b in _groups(poff):
        x = xp[a:b].float()
        gv, uv = x @ wg[grp].float(), x @ wu[grp].float()
        h[a:b] = (F.silu(gv) * uv).to(dt)
        if save:
            g[a:b], u[a:b] = gv.to(dt), uv.to(dt)
        y[a:b] = (h[a:b].float() @ wd[grp].float()).to(out_dtype)
    return y, h, g, u


def glu_bwd_plain(dy, xp, wg, wu, wd, g, u, poff):
    """(dx, dwg, dwu, dwd) from the saved rounded ``g``, ``u``: ``dh = dy
    wd_eᵀ``; ``dg = T(dh u silu'(g))``, ``du = T(dh silu(g))``, ``h =
    T(silu(g) u)``; ``dx = T(dg wg_eᵀ + du wu_eᵀ)``; the f32 weight
    gradients ``xᵀ dg``, ``xᵀ du``, ``hᵀ dy`` over each group's rows."""
    dt = xp.dtype
    dx = torch.zeros_like(xp)
    dwg, dwu, dwd = (torch.zeros(w.shape, dtype=torch.float32,
                                 device=w.device) for w in (wg, wu, wd))
    for grp, a, b in _groups(poff):
        dyf = dy[a:b].float()
        gf, uf = g[a:b].float(), u[a:b].float()
        dh = dyf @ wd[grp].float().T
        sig = torch.sigmoid(gf)
        dgv = (dh * uf * sig * (1.0 + gf * (1.0 - sig))).to(dt)
        duv = (dh * gf * sig).to(dt)
        hv = (gf * sig * uf).to(dt)
        dx[a:b] = (dgv.float() @ wg[grp].float().T
                   + duv.float() @ wu[grp].float().T).to(dt)
        x = xp[a:b].float()
        dwg[grp] = x.T @ dgv.float()
        dwu[grp] = x.T @ duv.float()
        dwd[grp] = hv.float().T @ dyf
    return dx, dwg, dwu, dwd


# ------------------------------------------------------------ kernel -------

def _check_shapes(xp, wg, wu, wd, poff):
    cap, D = xp.shape
    G, _, Fh = wg.shape
    dev = xp.device
    for t, name, shape in ((wg, "wg", (G, D, Fh)), (wu, "wu", (G, D, Fh)),
                           (wd, "wd", (G, Fh, D))):
        kernels.check(t, name, shape, xp.dtype, dev)
    kernels.check(poff, "poff", (G + 1,), torch.int32, dev)
    kernels.check(xp, "xp", (cap, D), xp.dtype, dev)
    if xp.dtype != torch.bfloat16:
        raise TypeError(f"the grouped GEMM takes bfloat16 operands, not "
                        f"{xp.dtype}")
    if D % 8 or Fh % 8 or cap % BM:
        raise ValueError(f"the grouped GEMM needs D ({D}) and F ({Fh}) "
                         f"multiples of 8 and a buffer of whole {BM}-row "
                         f"tiles ({cap} rows)")


def glu_fwd_kernel(xp, wg, wu, wd, poff, save: bool, out_dtype):
    """``fc_moe_gemm_fwd``: the same outputs as :func:`glu_fwd_plain`
    (rows past ``poff[G]`` left unwritten)."""
    _check_shapes(xp, wg, wu, wd, poff)
    cap, D = xp.shape
    G, _, Fh = wg.shape
    y = torch.empty((cap, D), dtype=out_dtype, device=xp.device)
    h = torch.empty((cap, Fh), dtype=xp.dtype, device=xp.device)
    g = torch.empty_like(h) if save else None
    u = torch.empty_like(h) if save else None
    kernels.launch("moe_gemm_fwd", G, cap, D, Fh,
                   int(out_dtype == torch.float32), *map(kernels.ptr, (
                       xp, wg, wu, wd, poff, y, h, g, u)))
    return y, h, g, u


def glu_bwd_kernel(dy, xp, wg, wu, wd, g, u, poff):
    """``fc_moe_gemm_bwd``: the same outputs as :func:`glu_bwd_plain`."""
    _check_shapes(xp, wg, wu, wd, poff)
    cap, D = xp.shape
    G, _, Fh = wg.shape
    for t, name, shape in ((dy, "dy", (cap, D)), (g, "g", (cap, Fh)),
                           (u, "u", (cap, Fh))):
        kernels.check(t, name, shape, xp.dtype, xp.device)
    dx = torch.empty_like(xp)
    dg, du, h = (torch.empty_like(g) for _ in range(3))
    dwg, dwu, dwd = (torch.empty(w.shape, dtype=torch.float32,
                                 device=xp.device) for w in (wg, wu, wd))
    kernels.launch("moe_gemm_bwd", G, cap, D, Fh, *map(kernels.ptr, (
        dy, xp, wg, wu, wd, g, u, poff, dx, dg, du, h, dwg, dwu, dwd)))
    return dx, dwg, dwu, dwd


def glu_fwd(xp, wg, wu, wd, poff, save: bool, out_dtype):
    if xp.is_cuda:
        return glu_fwd_kernel(xp, wg, wu, wd, poff, save, out_dtype)
    return glu_fwd_plain(xp, wg, wu, wd, poff, save, out_dtype)


def glu_bwd(dy, xp, wg, wu, wd, g, u, poff):
    if xp.is_cuda:
        return glu_bwd_kernel(dy, xp, wg, wu, wd, g, u, poff)
    return glu_bwd_plain(dy, xp, wg, wu, wd, g, u, poff)


def _check_rows(pair_row, k: int, D: int, dev):
    """The pairs' rows and the row width, as the row kernels
    (``csrc/moe_rows.cu``) index them: a token's slots in one warp's
    lanes, rows of whole 16-byte vectors."""
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"the row kernels take 1 to {MAX_SLOTS} slots a "
                         f"token, not {k}")
    if D % 8:
        raise ValueError(f"the row kernels move rows of whole 16-byte "
                         f"vectors: D ({D}) must be a multiple of 8")
    kernels.check(pair_row, "pair_row", (pair_row.numel(),), torch.long, dev)
    if pair_row.numel() % k:
        raise ValueError(f"pair_row holds {pair_row.numel()} pairs, not "
                         f"whole tokens of {k} slots")


def _check_vec(t, name, shape, dtype, dev):
    kernels.check(t, name, shape, dtype, dev)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def dispatch_kernel(x, pair_row, row_pair, poff, k: int):
    """``fc_moe_dispatch_fwd``: :func:`dispatch_plain`'s rows ``[0,
    poff[G])`` (rows past it left unwritten)."""
    tokens, D = x.shape
    cap, G = row_pair.numel(), poff.numel() - 1
    _check_rows(pair_row, k, D, x.device)
    _check_vec(x, "x", (pair_row.numel() // k, D), torch.bfloat16, x.device)
    kernels.check(row_pair, "row_pair", (cap,), torch.long, x.device)
    kernels.check(poff, "poff", (G + 1,), torch.int32, x.device)
    xp = torch.empty((cap, D), dtype=x.dtype, device=x.device)
    kernels.launch("moe_dispatch_fwd", tokens, k, D, G, cap,
                   *map(kernels.ptr, (x, row_pair, poff, xp)))
    count("moe_fused")
    return xp


def dispatch_bwd_kernel(dxp, pair_row, k: int):
    """``fc_moe_dispatch_bwd``: :func:`dispatch_bwd_plain`'s bits."""
    cap, D = dxp.shape
    tokens = pair_row.numel() // k
    _check_rows(pair_row, k, D, dxp.device)
    _check_vec(dxp, "dxp", (cap, D), torch.bfloat16, dxp.device)
    dx = torch.empty((tokens, D), dtype=dxp.dtype, device=dxp.device)
    kernels.launch("moe_dispatch_bwd", tokens, k, D, cap,
                   *map(kernels.ptr, (dxp, pair_row, dx)))
    count("moe_fused")
    return dx


def combine_kernel(yp, w, pair_row, k: int):
    """``fc_moe_combine_fwd``: :func:`combine_plain`'s bits."""
    cap, D = yp.shape
    tokens = pair_row.numel() // k
    _check_rows(pair_row, k, D, yp.device)
    _check_vec(yp, "yp", (cap, D), torch.bfloat16, yp.device)
    kernels.check(w, "w", (tokens, k), torch.float32, yp.device)
    out = torch.empty((tokens, D), dtype=torch.float32, device=yp.device)
    kernels.launch("moe_combine_fwd", tokens, k, D, cap,
                   *map(kernels.ptr, (yp, w, pair_row, out)))
    count("moe_fused")
    return out


def combine_bwd_kernel(dout, yp, w, pair_row, row_pair, poff, k: int):
    """``fc_moe_combine_bwd``: :func:`combine_bwd_plain`'s dyp bit for bit
    on rows ``[0, poff[G])`` (rows past it left unwritten), dw summed in
    another fixed order."""
    cap, D = yp.shape
    tokens, G = pair_row.numel() // k, poff.numel() - 1
    _check_rows(pair_row, k, D, yp.device)
    _check_vec(yp, "yp", (cap, D), torch.bfloat16, yp.device)
    _check_vec(dout, "dout", (tokens, D), torch.float32, yp.device)
    kernels.check(w, "w", (tokens, k), torch.float32, yp.device)
    kernels.check(row_pair, "row_pair", (cap,), torch.long, yp.device)
    kernels.check(poff, "poff", (G + 1,), torch.int32, yp.device)
    dyp = torch.empty_like(yp)
    dw = torch.empty((tokens, k), dtype=torch.float32, device=yp.device)
    kernels.launch("moe_combine_bwd", tokens, k, D, G, cap,
                   *map(kernels.ptr, (dout, w, yp, pair_row, row_pair, poff,
                                      dyp, dw)))
    count("moe_fused")
    return dyp, dw


def dispatch_fwd(x, pair_row, row_pair, poff, k: int):
    if x.is_cuda:
        return dispatch_kernel(x, pair_row, row_pair, poff, k)
    return dispatch_plain(x, pair_row, row_pair, poff, k)


def dispatch_bwd(dxp, pair_row, k: int):
    if dxp.is_cuda:
        return dispatch_bwd_kernel(dxp, pair_row, k)
    return dispatch_bwd_plain(dxp, pair_row, k)


def combine_fwd(yp, w, pair_row, k: int):
    if yp.is_cuda:
        return combine_kernel(yp, w, pair_row, k)
    return combine_plain(yp, w, pair_row, k)


def combine_bwd(dout, yp, w, pair_row, row_pair, poff, k: int):
    if yp.is_cuda:
        return combine_bwd_kernel(dout, yp, w, pair_row, row_pair, poff, k)
    return combine_bwd_plain(dout, yp, w, pair_row, row_pair, poff, k)


class _GroupedGLU(torch.autograd.Function):
    """Weights come in as the float32 masters ``[G, ...]`` and are cast to
    the buffer's dtype here, so that their gradients leave in float32."""

    @staticmethod
    def forward(ctx, xp, wg, wu, wd, poff):
        dt = xp.dtype
        wgc, wuc, wdc = (w.to(dt).contiguous() for w in (wg, wu, wd))
        save = any(ctx.needs_input_grad[:4])
        y, _, g, u = glu_fwd(xp, wgc, wuc, wdc, poff, save, dt)
        if save:
            ctx.save_for_backward(xp, wgc, wuc, wdc, g, u, poff)
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, wgc, wuc, wdc, g, u, poff = ctx.saved_tensors
        dx, dwg, dwu, dwd = glu_bwd(dy.to(xp.dtype).contiguous(), xp, wgc,
                                    wuc, wdc, g, u, poff)
        return dx, dwg, dwu, dwd, None


def grouped_glu(xp: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                poff: Tensor) -> Tensor:
    """Each buffer row through its group's SiLU-GLU expert: ``xp [cap,
    D]``, ``wg`` / ``wu [G, D, F]``, ``wd [G, F, D]``; ``[cap, D]`` in xp's
    dtype."""
    return _GroupedGLU.apply(xp, wg, wu, wd, poff)
