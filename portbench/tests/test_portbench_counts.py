"""The counts of ``portbench/counts`` against the hand counts: model FLOPs
of mome_small (9.2 GFLOP an image forward, 1.73 a 40-token text forward,
32.8 a training img+txt pair) and the kernel bounds of PERF.md §6."""

import json

import pytest

from portbench.arch import mat
from portbench.counts import kernels
from portbench.counts.peaks import least_seconds
from portbench.counts.work import train_row_flops
from portbench.inputs import round_work
from portbench.tests.tinyroot import REPO

SMALL = json.loads((REPO / "portbench/configs/mome_small.json").read_text())
TINY = json.loads((REPO / "portbench/configs/mome_tiny.json").read_text())


def test_model_flops_hand_counts():
    img = mat.forward_flops(SMALL, "img")
    txt = mat.forward_flops(SMALL, "txt")
    assert img == pytest.approx(9.2e9, rel=2e-3)
    assert txt == pytest.approx(1.73e9, rel=3e-3)
    assert train_row_flops(mat, SMALL, "img") == pytest.approx(27.6e9,
                                                               rel=2e-3)
    assert train_row_flops(mat, SMALL, "txt") == pytest.approx(5.2e9,
                                                               rel=5e-3)
    assert train_row_flops(mat, SMALL, "img+txt") == pytest.approx(
        32.8e9, rel=2e-3)
    # a classification head adds 2 D C
    assert mat.forward_flops(SMALL, "img", 100) - img == 2 * 384 * 100


@pytest.mark.parametrize("row, call, ms", [
    ("1", lambda: kernels.attn_fwd(192, 2, 197, 384, 6, True), 0.0567),
    ("2", lambda: kernels.attn_bwd(192, 2, 197, 384, 6), 0.1472),
    ("3", lambda: kernels.mlp_fwd(192, 2, 197, 384, 1536, True), 0.0902),
    ("4", lambda: kernels.mlp_bwd(192, 2, 197, 384, 1536), 0.2256),
    ("11", lambda: kernels.flash_fwd(192 * 3, 197, 64), 0.0173),
    ("12", lambda: kernels.flash_bwd(192 * 3, 197, 64), 0.0303),
    ("1e", lambda: kernels.attn_fwd(500, 1, 197, 384, 6, False), 0.1476),
    ("3e", lambda: kernels.mlp_fwd(500, 1, 197, 384, 1536, False), 0.2350),
])
def test_kernel_bounds_match_perf_table(row, call, ms):
    assert least_seconds(*call()) * 1e3 == pytest.approx(ms, rel=0.01), row


def test_layer_least_sums_its_rows():
    one = mat.routes()["fused"].least(96, 1, 197, SMALL, True)
    calls = [kernels.attn_fwd(96, 1, 197, 384, 6, True),
             kernels.mlp_fwd(96, 1, 197, 384, 1536, True),
             kernels.attn_bwd(96, 1, 197, 384, 6),
             kernels.mlp_bwd(96, 1, 197, 384, 1536)]
    assert one == pytest.approx(sum(least_seconds(*c) for c in calls))
    assert mat.routes()["flash"].least(96, 1, 197, TINY, False) == \
        pytest.approx(least_seconds(*kernels.flash_fwd(96 * 3, 197, 64)))


def test_round_work_counts_rows_and_steps():
    class D:
        name, modality, shards = "x", "img", None
    import numpy as np
    d = D()
    d.shards = [np.arange(100), np.arange(30)]
    w = round_work([d], [0, 1], epochs=2, batch=96)
    assert w.rows == 260
    # client 0: 96, 4, 96, 4; client 1: 30, 30
    assert w.step_rows["x"] == [126, 34, 96, 4]
    assert w.steps == 4 and w.clients == {"x": 2}
