"""The readers of the program's spans on a canned traced window: ms a
round (or pass), the mean over the untraced rounds, None where no round
recorded the span (a program without it)."""

import pytest

from portbench.spec import metric_reader
from portbench.tests.tinyroot import REPO

RECORDS = [
    {"sections": {"train": 1.5, "train.forward": 0.4, "train.backward": 0.5,
                  "train.opt": 0.3, "train.data": 0.1, "train.sync": 0.01,
                  "aggregate": 0.02, "aggregate.sync": 0.005,
                  "round.sync": 0.003, "eval": 0.2, "eval.drain": 0.05,
                  "eval.rank": 0.03, "eval.sync": 0.002},
     "eval_seconds": 0.2},
    {"sections": {"train": 1.4, "train.forward": 0.6, "train.backward": 0.7,
                  "train.opt": 0.5, "train.data": 0.3, "train.sync": 0.03,
                  "aggregate": 0.04, "aggregate.sync": 0.007,
                  "round.sync": 0.001, "eval": 0.4, "eval.drain": 0.07,
                  "eval.rank": 0.05, "eval.sync": 0.002},
     "eval_seconds": 0.4},
]
# a round of a program that opens no spans: its top-level sections only
BARE = {"sections": {"train": 1.3, "aggregate": 0.03}, "eval_seconds": 0.1}


def _ctx(records):
    return {"records": records}


@pytest.mark.parametrize("name, want", [
    ("forward_ms.train", 500.0),
    ("backward_ms.train", 600.0),
    ("opt_ms.train", 400.0),
    ("data_ms.train", 200.0),
    ("sync_ms.train", 30.0),
    ("drain_ms.eval", 60.0),
    ("rank_ms.eval", 40.0),
])
def test_span_reader(name, want):
    read = metric_reader(REPO, name)
    assert read(_ctx(RECORDS)) == pytest.approx(want)
    # a round without the span is left out of the mean
    assert read(_ctx(RECORDS + [BARE])) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "forward_ms.train", "backward_ms.train", "opt_ms.train", "data_ms.train",
    "sync_ms.train", "drain_ms.eval", "rank_ms.eval"])
def test_no_span_gives_none(name):
    read = metric_reader(REPO, name)
    assert read(_ctx([BARE, BARE])) is None
    assert read(_ctx([])) is None
