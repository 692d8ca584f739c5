"""A run with its timed path broken underneath comes out not correct:
each fault of ``portbench/faults.py`` the cell can have, planted in the
program, on the CPU at test width (the look for a card skipped)."""

import pytest
import torch

from portbench.cell import run_cell
from portbench.faults import planted
from portbench.spec import resolve_cell
from portbench.tests.tinyroot import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("name, fault", [
    ("pop.tiny", "frozen"), ("pop.tiny", "half"), ("pop.tiny", "answer"),
    ("eval.tiny", "answer")])
def test_fault_is_not_correct(root, name, fault):
    cell = resolve_cell(root, name)
    with planted(fault):
        res = run_cell(cell, 2 ** 31 + 17, 0.2, False, "cpu", 0.0, root)
    assert not res["correct"], res["checks"]
