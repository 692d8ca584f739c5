"""Operations and bytes of one call of each hand-written kernel, per the
bounds of PERF.md §6, for the work a call must do: ``rows`` valid
sequences of length N over ``n`` stacked clients (weights are read once a
client).  bf16 activations and weights (2 bytes), float32 LayerNorm
parameters, DropPath scales and weight gradients (4 bytes).

    row 1 / 1e  attention forward (save / eval)  8·N·D² + 4·N²·D a row
    row 2       attention backward, saved P      22·N·D² + 8·N²·D
    row 3 / 3e  MLP forward                      4·N·D·F
    row 4       MLP backward                     10·N·D·F
    row 11/11e  flash forward, a (row, head)     4·N²·hd; q, k, v, o
    row 12      flash backward                   10·N²·hd; q, k, v, dO, dq, dk, dv

Row 1 writes P (H·N² bf16) and the head outputs for row 2, which reads
them back; the bytes of a call are its inputs read once and its outputs
written once.  An architecture's routes sum the calls of each of its
layers (``portbench/arch/``).
"""

from __future__ import annotations


def _attn_w(D: int) -> float:
    return (4 * D * D + 4 * D) * 2 + 2 * D * 4


def _mlp_w(D: int, F: int) -> float:
    return (2 * D * F + F + D) * 2 + 2 * D * 4


def attn_fwd(rows, n, N, D, H, save: bool):
    ops = rows * (8.0 * N * D * D + 4.0 * N * N * D)
    per = 2 * N * D * 2 + ((H * N * N + N * D) * 2 + 4 if save else 0)
    return ops, rows * per + n * _attn_w(D)


def attn_bwd(rows, n, N, D, H):
    ops = rows * (22.0 * N * D * D + 8.0 * N * N * D)
    per = (4 * N * D + H * N * N) * 2 + 4
    return ops, rows * per + n * (_attn_w(D) + (4 * D * D + 6 * D) * 4)


def mlp_fwd(rows, n, N, D, F, residual: bool):
    return rows * 4.0 * N * D * F, \
        rows * (2 * N * D * 2 + (4 if residual else 0)) + n * _mlp_w(D, F)


def mlp_bwd(rows, n, N, D, F):
    return rows * 10.0 * N * D * F, \
        rows * (3 * N * D * 2 + 4) + n * (_mlp_w(D, F)
                                          + (2 * D * F + F + 3 * D) * 4)


def flash_fwd(pairs, N, hd):
    return 4.0 * pairs * N * N * hd, pairs * 4 * N * hd * 2


def flash_bwd(pairs, N, hd):
    return 10.0 * pairs * N * N * hd, pairs * 7 * N * hd * 2
