"""Cells, configurations, architectures, traffic mixes and metric readers,
found by name.

``BENCHMARK.json`` at the checkout's root names every cell; a cell names
one configuration (``portbench/configs/<name>.json`` through the entry's
``file``) and one traffic mix (``portbench/traffic/<name>.json``); a
configuration names its architecture, ``portbench/arch/<name>.py``, under
``architecture`` (``mat`` where it names none); a per-layer metric
``<name>`` is the reader ``portbench/metrics/<name>.py``.  Later additions
are new files and new entries: nothing here names a cell, a mix, an
architecture or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

DEFAULT_ARCH = "mat"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None         # per-layer metrics only


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    architecture: str
    arch: ModuleType                    # portbench/arch/<architecture>.py
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the root")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e_of: Dict[str, List[str]]) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` when listed;
    else, for a per-layer metric, every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return cell in e2e_of.get(metric["moves"], [])
    return True


def resolve_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic files read and
    the metrics it reports."""
    root = Path(root)
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    w = entries[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    architecture = config.get("architecture", DEFAULT_ARCH)
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    cells = [x["name"] for x in bench["workloads"]]
    e2e_of = {m["name"]: [c for c in cells if _reports(m, c, {})]
              for m in bench["end_to_end"]}
    pick = lambda ms: [Metric(m["name"], m["unit"], m.get("moves"))  # noqa: E731
                       for m in ms if _reports(m, name, e2e_of)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                architecture=architecture, arch=arch_of(root, architecture),
                traffic=traffic, end_to_end=pick(bench["end_to_end"]),
                per_layer=pick(bench["per_layer"]))


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    """The Python file ``path``, loaded as a module of its own."""
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a name")
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{prefix}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root: Path, name: str) -> Callable:
    """``read(ctx)`` of ``portbench/metrics/<name>.py``: the metric's value
    from a traced run's context, or None when it finds nothing to read."""
    return _load(Path(root) / "portbench" / "metrics" / f"{name}.py",
                 "metric", name).read


def arch_of(root: Path, name: str) -> ModuleType:
    """The architecture file ``portbench/arch/<name>.py``."""
    return _load(Path(root) / "portbench" / "arch" / f"{name}.py", "arch",
                 name)
