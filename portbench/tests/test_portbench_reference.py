"""The plain reference against the port's plain CPU path at test width
(float32): the followed rounds (every group's local steps, the
compensated aggregation with the aux exchange) and the central
evaluation agree to round-off, and the control, the reference at float8
operands in the program's place, is refused by the same limits."""

import pytest
import torch

from portbench.cell import run_cell
from portbench.control import control_lines
from portbench.spec import resolve_cell
from portbench.tests.tinyroot import make_root

LIMIT = 1e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"), LIMIT)


@pytest.mark.parametrize("name", ["pop.tiny", "eval.tiny"])
def test_run_is_correct(root, name):
    res = run_cell(resolve_cell(root, name), 2 ** 31 + 99, 0.2, False,
                   "cpu", 0.0, root)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {"pop.tiny": {"loss", "change", "eval_loss", "rtv_meanr",
                         "init_eval_loss", "init_rtv_meanr", "loss_median",
                         "change_median"},
            "eval.tiny": {"eval_loss", "rtv_meanr"}}[name]
    assert set(res["readings"]) == want
    assert all(v < LIMIT for v in res["readings"].values())


def test_traced_run_reports_per_layer(root):
    res = run_cell(resolve_cell(root, "pop.tiny"), 3, 0.2, True, "cpu", 0.0,
                   root)
    assert res["correct"]
    # trace_rounds untraced, as many traced on the card alone, as many
    # traced in full
    assert res["attempted"] == 6
    # the program's clocks are read; the CPU traces no kernel, so the
    # device metrics find nothing to read
    assert {"aggregate_ms.train", "eval_ms.train", "mfu.train"} <= set(
        res["metrics"])
    assert "idle_share.train" not in res["metrics"]


@pytest.mark.parametrize("name", ["pop.tiny", "eval.tiny"])
def test_control_fails(root, name):
    cell = resolve_cell(root, name)
    for line in control_lines(cell, [7, 2 ** 31 + 5, 11], "cpu", root,
                              True):
        assert max(line["program"].values()) < LIMIT
        assert max(line["control"].values()) > LIMIT, line
