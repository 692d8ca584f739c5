"""Cells resolve their configuration, traffic and metrics by name, and a
configuration, a mix and a metric added as new files are found without an
edit to any file already there."""

import json

import pytest

from portbench.spec import metric_reader, resolve_cell
from portbench.tests.tinyroot import REPO, make_root


def test_cell_resolves_by_name():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = resolve_cell(REPO, w["name"])
        assert cell.config["model_name"].startswith("mome_")
        assert cell.traffic["mode"] in ("rounds", "eval")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m.moves in names
            assert callable(metric_reader(REPO, m.name))


def test_training_traffic_is_the_listed_cut():
    # the rows a training cell runs are those its configuration lists as
    # cut (``reduced``: ``train_rows``, ``test_rows``)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = resolve_cell(REPO, w["name"])
        if cell.traffic["mode"] != "rounds":
            continue
        for ds, d in cell.traffic["datasets"].items():
            assert d.get("train", d.get("train_images")) == \
                cell.config["train_rows"][ds]
            assert d.get("test", d.get("test_images")) == \
                cell.config["test_rows"][ds]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        resolve_cell(REPO, "no-such.cell")


def test_new_files_are_found(tmp_path):
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench" / "metrics" / "rows_per_round.train.py").write_text(
        "def read(ctx):\n    return ctx['work']['rows'] / 2\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "rows_per_round.train", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "group update",
                           "moves": "train_samples_per_s",
                           "workloads": ["pop.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = resolve_cell(root, "pop.tiny")
    assert cell.config["embed_dim"] == 16
    assert cell.traffic["datasets"]["Coco"]["test_images"] == 10
    assert "rows_per_round.train" in {m.name for m in cell.per_layer}
    assert metric_reader(root, "rows_per_round.train")(
        {"work": {"rows": 8}}) == 4
    assert "rows_per_round.train" not in {
        m.name for m in resolve_cell(root, "eval.tiny").per_layer}
    for p, data in before.items():
        assert p.read_bytes() == data
