"""A checkout root for the CPU tests: ``BENCHMARK.json`` and a copy of
``portbench/`` with a test-width configuration (``mome_test16_patch16_32``:
D 16, 2 layers, 2 heads, 32 px, float32) and two small mixes of the
coco.sh line, added as files of their own, the way a later change adds a
cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {"model_name": "mome_test16_patch16_32", "embed_dim": 16, "depth": 2,
        "num_heads": 2, "img_size": 32, "patch_size": 16, "in_chans": 3,
        "mlp_ratio": 4.0, "qkv_bias": True, "drop_path_rate": 0.0,
        "vocab_size": 120, "max_text_len": 12, "compute_dtype": "float32",
        "reduced": []}


def _set(flags, name, values):
    i = flags.index(name)
    j = i + 1
    while j < len(flags) and not flags[j].startswith("--"):
        j += 1
    flags[i + 1:j] = values


def tiny_traffic(mode: str) -> dict:
    t = json.loads((REPO / "portbench" / "traffic" / "coco-pop.json")
                   .read_text())
    f = t["flags"]
    for name, vals in (("--Ks", ["4", "4", "4"]), ("--Cs", ["0.5"]),
                       ("--E", ["2"]), ("--B", ["8"]),
                       ("--eval_batch_size", ["16"]), ("--resize", ["32"])):
        _set(f, name, vals)
    t.update(mode=mode, follow_rounds=2 if mode == "rounds" else 0,
             trace_rounds=2, datasets={
                 "CIFAR100": {"modality": "img", "task": "cls",
                              "classes": 100, "train": 120, "test": 20,
                              "pixels": 16},
                 "AG_NEWS": {"modality": "txt", "task": "cls", "classes": 4,
                             "train": 60, "test": 20},
                 "Coco": {"modality": "img+txt", "task": "rtv",
                          "train_images": 24, "test_images": 10,
                          "captions": 5, "pixels": 32}})
    return t


def make_root(tmp: Path, limit: float = 1e-3) -> Path:
    """``tmp`` as a checkout root holding the tiny cells ``pop.tiny``
    (rounds) and ``eval.tiny`` (evaluation passes)."""
    tmp = Path(tmp)
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny", "source": "test width",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"] += [
        {"name": "pop.tiny", "config": "tiny", "traffic": "pop-tiny",
         "chips": 1, "why": "CPU tests"},
        {"name": "eval.tiny", "config": "tiny", "traffic": "eval-tiny",
         "chips": 1, "why": "CPU tests"}]
    for m in b["end_to_end"] + b["per_layer"]:
        cells = m.get("workloads", [])
        if any(c.startswith("coco-pop.") for c in cells):
            cells.append("pop.tiny")
        if any(c.startswith("coco-eval5k.") for c in cells):
            cells.append("eval.tiny")
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    p = tmp / "portbench"
    (p / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (p / "traffic" / "pop-tiny.json").write_text(
        json.dumps(tiny_traffic("rounds")))
    (p / "traffic" / "eval-tiny.json").write_text(
        json.dumps(tiny_traffic("eval")))
    (p / "limits" / "pop.tiny.json").write_text(json.dumps(
        {k: limit for k in ("loss", "change", "eval_loss", "rtv_meanr",
                            "init_eval_loss", "init_rtv_meanr")}))
    (p / "limits" / "eval.tiny.json").write_text(json.dumps(
        {k: limit for k in ("eval_loss", "rtv_meanr")}))
    return tmp
