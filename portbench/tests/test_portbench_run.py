"""The command: without a card it exits non-zero and prints no result
(never a CPU run), and a directory that holds only ``BENCHMARK.json``
and ``portbench/`` cannot run it either."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.tests.tinyroot import REPO

CMD = [sys.executable, "-m", "portbench.run", "--workload",
       "coco-pop.mome_small", "--seed", "1", "--seconds", "1", "--trace",
       "0"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_no_card_no_result(no_card):
    p = subprocess.run(CMD, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_bare_directory_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_benchmark_json_names_the_command():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    names = [w["name"] for w in b["workloads"]]
    for w in names:
        assert (REPO / "portbench" / "limits" / f"{w}.json").is_file()
