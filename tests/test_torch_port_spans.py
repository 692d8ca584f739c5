"""The round's spans and counters (``utils/profiling.py``) on the CPU, at
test width: the coco.sh line at its own population (``--debug``, one
epoch), then an evaluation alone.

* A round records every span of the update and the central evaluation in
  ``round_sections``, each child within its parent, the top-level names
  those the log line totals;
* an evaluation-only round records the ``eval`` spans, ``eval.rank`` for
  the retrieval set;
* under ``torch.profiler`` every span is a host event ``fc_<name>``, the
  model's sublayers too;
* with the profiler off, no profiler range (``record_function``, the
  host range ``_RecordFunctionFast``) is entered, in a kernel launch
  neither; with it on, a launch is the ``record_function`` the rooflines
  read;
* ``round_counters`` holds its five counters, ``steps`` the stacked steps
  of the chunks the feeder planned, ``opt_fused`` none of them on the CPU
  (the optimizer's plain version).
"""

import numpy as np
import pytest
import torch

from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.config import parse_args
from fedcola_tpu_torch.data import fixtures
from fedcola_tpu_torch.data.loaders import load_federated_data
from fedcola_tpu_torch.federation import server as server_mod
from fedcola_tpu_torch.federation.server import create_server
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.utils import profiling

UPDATE_SPANS = {"train", "train.open", "train.data", "train.forward",
                "train.backward", "train.opt", "train.close", "train.sync",
                "aggregate", "aggregate.plan", "aggregate.apply",
                "aggregate.aux", "aggregate.check", "aggregate.sync"}
EVAL_SPANS = {"eval", "eval.forward", "eval.drain", "eval.rank", "eval.sync"}
MODEL_SPANS = {"mat.weights", "mat.embed", "mat.attn", "mat.mlp", "mat.head"}


# every profiler range a span can open, and the names each was opened with
NAMES = {}


def _counting(owner, attr):
    """``owner.attr`` (a profiler range) noting each name it opens."""
    real = getattr(owner, attr)

    class Counting:
        def __init__(self, name, *args):
            NAMES[attr].append(name)
            self.inner = real(name, *args)

        def __enter__(self):
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    return Counting


def _count_ranges(mp):
    for owner, attr in ((torch.profiler, "record_function"),
                        (torch._C._profiler, "_RecordFunctionFast")):
        NAMES[attr] = []
        mp.setattr(owner, attr, _counting(owner, attr))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    coco = fixtures.coco_fixture(str(d / "coco"), 44, 12, 32)
    flags = tmain.cut(tmain.population_flags(
        coco, str(d / "none"), str(d / "none")), {
        "--model_name": "mome_test16_patch16_32", "--resize": "32",
        "--B": "8", "--E": "1", "--R": "3", "--seq_len": "12",
        "--vocab_size": "120", "--device": "cpu", "--debug": (),
        "--result_path": str(d / "r"), "--log_path": str(d / "l")})
    cfg = parse_args(list(flags))
    return create_server(cfg, load_federated_data(
        cfg, np.random.RandomState(cfg.seed)))


@pytest.fixture(scope="module")
def round1(server):
    """Round 1 (update, then the central evaluation) with the profiler off,
    ``record_function`` counted and the feeder's chunks counted."""
    planned = []

    class Counted(server_mod.Prefetcher):
        def __next__(self):
            chunk = super().__next__()
            planned.append(int(chunk["step_valid"].any(0).sum()))
            return chunk

    mp = pytest.MonkeyPatch()
    mp.setattr(server_mod, "Prefetcher", Counted)
    _count_ranges(mp)
    try:
        server.round = 1
        server.update()
        server.evaluate([])
    finally:
        mp.undo()
    return server.results[1], sum(planned), \
        [n for names in NAMES.values() for n in names]


def test_round_records_every_span(round1):
    res, _, _ = round1
    sections = res["round_sections"]
    assert set(sections) == UPDATE_SPANS | EVAL_SPANS, sorted(sections)
    # the top-level names are the sections the log line totals
    assert {k for k in sections if "." not in k} == \
        {"train", "aggregate", "eval"}
    for name, seconds in sections.items():
        assert seconds >= 0, name
        if "." in name:
            assert seconds <= sections[name.split(".")[0]], name
    assert res["eval_seconds"] <= sections["eval"] + 1e-3
    assert res["round_seconds"] >= sections["train"] + sections["aggregate"]


def test_eval_only_round(server):
    server.round = 2
    server.evaluate([])
    sections = server.results[2]["round_sections"]
    # Coco is a retrieval set: its ranking is the ``eval.rank`` span
    assert set(sections) == EVAL_SPANS, sorted(sections)
    assert sections["eval.forward"] + sections["eval.drain"] \
        + sections["eval.rank"] <= sections["eval"]
    assert server.results[2]["round_counters"]["steps"] == 0


def test_spans_on_the_profiler_clock(server):
    from torch.profiler import ProfilerActivity, profile
    server.round = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.update()
        server.evaluate([])
    names = {e.key for e in prof.key_averages()}
    want = {"fc_" + n for n in UPDATE_SPANS | EVAL_SPANS | MODEL_SPANS}
    assert want <= names, sorted(want - names)
    # the trace-only spans stay out of the round's sections
    assert not MODEL_SPANS & set(server.results[3]["round_sections"])


def test_profiler_off_enters_no_range(round1, monkeypatch):
    _, _, names = round1
    assert not [n for n in names if n.startswith("fc_")], names[:8]

    class Library:
        @staticmethod
        def fc_attn_fwd(stream):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(kernels, "library", lambda: Library)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)
    monkeypatch.setitem(kernels.LAUNCHES, "attn_fwd", 0)
    _count_ranges(monkeypatch)
    kernels.launch("attn_fwd")
    assert NAMES == {"record_function": [], "_RecordFunctionFast": []}
    assert kernels.LAUNCHES["attn_fwd"] == 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        kernels.launch("attn_fwd")
    # a record_function, drawn on the device's timeline too, with the entry
    # point's name: the rooflines read the device time under it
    assert NAMES == {"record_function": ["fc_attn_fwd"],
                     "_RecordFunctionFast": []}


def test_round_counters(round1):
    res, planned, _ = round1
    counters = res["round_counters"]
    assert set(counters) == {"steps", "opt_fused", "launches", "readbacks",
                             "device_mallocs"}
    assert planned > 0 and counters["steps"] == planned
    # the CPU runs the kernels' plain versions, and has no device segments
    assert counters["launches"] == 0 and counters["device_mallocs"] is None
    assert counters["opt_fused"] == 0
    # a readback per group's metrics, per model's finite check, per eval
    # batch drained and per ranking
    assert counters["readbacks"] >= 6


def test_span_names():
    timer = profiling.Timer()
    with timer.recording():
        with profiling.span(".x"):
            pass
        with profiling.span("a"):
            with profiling.span(".x"):
                with profiling.readback():
                    pass
            with profiling.span("a.y", timed=False):
                pass
    assert set(timer.sections) == {"round.x", "a", "a.x", "a.sync"}
    assert timer.counters["readbacks"] == 1
    # the log line totals the top-level sections alone
    assert timer.summary() == f"a={timer.sections['a']:.2f}s " \
        f"total={timer.sections['a']:.2f}s"
    # no round recorded, no profiler: nothing is recorded
    with profiling.span("b"):
        pass
    assert "b" not in timer.sections
