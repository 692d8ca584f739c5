"""One run of one cell: set-up, the measured (or traced) window, then the
comparison with the plain reference.

Set-up makes the data and weights from the seed, builds the program's
server on them and drives it through its first ``follow_rounds`` rounds
(update, then central evaluation, as ``main.py`` runs a round with
``--eval_every 1``) through the window's own calls; an ``eval`` cell runs
one evaluation pass.  That warms every shape the window uses.  The window
then runs whole rounds, each ending in a synchronize: the plan's next
``window_rounds`` rounds, the same in every run, so that every run times
the same work; an ``eval`` cell runs its passes, alike to the byte, until
``seconds`` have passed on the host clock.  After it closes and the
program's state is freed, the reference follows the same rounds from the
same inputs, and the numbers of ``check.py`` decide ``correct``.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from portbench import check, program
from portbench.counts.work import plan_work
from portbench.inputs import make_datasets, make_weights, round_work, \
    sample_round
from portbench.reference.fedcola import Federation, Line
from portbench.reference.precision import Products, no_tf32
from portbench.spec import Cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "fedcola_tpu")


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, for any
    the program comes to use (its own kernel build is ``build/kernels/``
    there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window_rounds(traffic: dict, seconds: float) -> int:
    """Whole rounds a window of ``seconds`` runs: the traffic's
    ``round_seconds`` is a round's length on the card it is sized for."""
    return max(1, round(seconds / float(traffic["round_seconds"])))


def _inputs(cell: Cell, seed: int, device: str):
    A = cell.arch
    line = Line.from_flags(cell.traffic["flags"])
    datasets = make_datasets(cell.traffic, A.data_shapes(cell.config), seed,
                             device)
    specs = {d.name: A.model_spec(cell.config, d.modality, d.task, d.classes,
                                  line.with_aux) for d in datasets}
    layouts = {ds: A.layout(s) for ds, s in specs.items()}
    return line, datasets, layouts


class Run:
    """The program's side of one run: its server and what it reported."""

    def __init__(self, cell: Cell, seed: int, device: str, root: Path):
        self.cell, self.seed, self.device = cell, seed, device
        self.mode = cell.traffic["mode"]
        t0 = time.perf_counter()
        self.line, self.data, self.layouts = _inputs(cell, seed, device)
        weights = make_weights(self.layouts, seed, device, cell.arch)
        t1 = time.perf_counter()
        self.server = program.create(cell, self.data, weights, device,
                                     str(root / "build" / "portbench_out"))
        # set-up seconds by part, for the look (standard error)
        self.setup_parts = {"inputs": t1 - t0,
                            "server": time.perf_counter() - t1}
        self.round = 0
        self.losses: Dict[int, Dict[int, float]] = {}
        self.records, self.works = [], []

    def step(self) -> None:
        """One whole round (update, then the central evaluation), or one
        evaluation pass; ends in a synchronize."""
        import torch
        self.round += 1
        s = self.server
        s.round = self.round
        if self.mode == "rounds":
            with torch.profiler.record_function("portbench.update"):
                s.update()
        with torch.profiler.record_function("portbench.evaluate"):
            s.evaluate([])
        program.sync(self.device)

    def follow(self, rounds: int) -> None:
        """The set-up's rounds; a training cell first evaluates the initial
        weights (round 0), the one evaluation whose gap training does not
        blur."""
        if self.mode == "rounds":
            self.server.round = 0
            self.server.evaluate([])
            program.sync(self.device)
        for _ in range(rounds):
            self.step()
            if self.mode == "rounds":
                self.losses[self.round] = program.client_losses(
                    self.server, self.round)

    def timed_step(self) -> None:
        self.step()
        self.records.append(program.round_record(self.server, self.round))
        if self.mode == "rounds":
            plan = sample_round(self.line.seed, self.data, self.line.fraction,
                                self.round)
            got = sorted(program.client_losses(self.server, self.round))
            if got != plan:
                raise RuntimeError(f"round {self.round}: the program "
                                   f"sampled {got}, the plan {plan}")
            self.works.append(round_work(self.data, plan, self.line.epochs,
                                         self.line.batch))

    def window_work(self) -> dict:
        return plan_work(self.cell.arch, self.cell.config, self.data,
                         self.works, len(self.records), self.line.eval_batch)


def _reference(cell: Cell, seed: int, device: str, follow: int,
               eval_round: int, fp8: bool = False):
    """The reference over the same inputs: the followed rounds' losses,
    each leaf's change, its first gradients, the evaluation."""
    line, data, layouts = _inputs(cell, seed, device)
    w0 = make_weights(layouts, seed, device, cell.arch)
    fed = Federation(cell.arch, line, cell.config, data,
                     make_weights(layouts, seed, device, cell.arch), device,
                     Products(fp8))
    init = fed.evaluate(0) if follow else None
    losses = {r: fed.run_round(r) for r in range(1, follow + 1)}
    delta = {ds: check.norms(cell.arch.parts, fed.params[ds], w0[ds])
             for ds in w0}
    return {"losses": losses, "delta": delta, "grads": fed.first_grads,
            "eval": fed.evaluate(eval_round), "init_eval": init}


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    out = check.eval_gaps(prog["eval"], ref["eval"])
    if ref.get("init_eval"):
        out.update({f"init_{k}": v for k, v in check.eval_gaps(
            prog["init_eval"], ref["init_eval"]).items()})
    if ref["losses"]:
        out.update(check.training_gaps(prog, ref))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: Path) -> dict:
    """One run; returns the result line's fields and the lines for
    standard error."""
    import torch
    root = Path(root)
    cache_env(root)
    if device == "cuda":
        no_tf32()
    t_run = time.perf_counter()
    run = Run(cell, seed, device, root)
    follow = int(cell.traffic["follow_rounds"]) if run.mode == "rounds" else 0
    t_follow = time.perf_counter()
    run.follow(max(follow, 1))
    after = program.snapshot(run.server) if follow else None
    setup_s = time.perf_counter() - t_start
    parts = {"imports": t_run - t_start, **run.setup_parts,
             "followed": time.perf_counter() - t_follow}

    summary: dict = {}
    if trace:
        # the profiler's host work stretches the rounds it traces, so three
        # phases of ``trace_rounds`` rounds each: untraced (the program's
        # clocks, the whole step's share of the peak), traced on the card
        # alone (its busy seconds over the window) and traced in full
        # (kernels, ranges and the host under the gaps)
        from portbench.trace import traced
        n = int(cell.traffic["trace_rounds"])
        t0 = time.perf_counter()
        for _ in range(n):
            run.timed_step()
        timed = {"window_s": time.perf_counter() - t0,
                 "model_flops": run.window_work()["model_flops"],
                 "records": list(run.records)}
        busy: dict = {}
        with traced(busy, device_only=True):
            for _ in range(n):
                run.timed_step()
        run.records, run.works = [], []
        with traced(summary):
            for _ in range(n):
                run.timed_step()
        window = summary["window_s"]
        summary["device"] = {k: busy[k] for k in ("busy_s", "window_s")}
    else:
        t0 = time.perf_counter()
        if run.mode == "rounds":
            for _ in range(window_rounds(cell.traffic, seconds)):
                run.timed_step()
        else:
            while True:
                run.timed_step()
                if time.perf_counter() - t0 >= seconds:
                    break
        window = time.perf_counter() - t0
    work = run.window_work()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    # the outputs compared: the followed rounds of a training cell, the
    # window's last pass of an evaluation cell
    eval_round = follow if follow else run.round
    prog = {"losses": dict(run.losses),
            "eval": program.eval_results(run.server, eval_round, run.data),
            "init_eval": program.eval_results(run.server, 0, run.data)
            if follow else None}
    attempted = run.round - (follow if follow else 1)
    failed = sum(not all(np.isfinite(v) for v in _numbers(
        program.eval_results(run.server, r, run.data)))
        for r in range(run.round - attempted + 1, run.round + 1))
    lines = [f"window {window:.3f} s, {attempted} "
             f"{'rounds' if run.mode == 'rounds' else 'passes'}, "
             f"{work['rows']} training rows, {work['items']} eval items, "
             f"peak {peak} bytes", f"launches {program.launches()}",
             "setup " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()),
             "rounds " + " ".join(f"{r['round_seconds'] or 0:.3f}+"
                                  f"{r['eval_seconds'] or 0:.3f}"
                                  for r in run.records),
             _smi(device)]

    del run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if follow:
        _, _, layouts = _inputs(cell, seed, device)
        w0 = make_weights(layouts, seed, device, cell.arch)
        prog["delta"] = {ds: check.norms(cell.arch.parts, after[ds], w0[ds])
                         for ds in after}
        del after, w0
    t_ref = time.perf_counter()
    ref = _reference(cell, seed, device, follow, eval_round)
    lines.append(f"reference {time.perf_counter() - t_ref:.1f} s")
    got = readings(prog, ref)
    correct, checks = check.judge(got, check.limits_of(root, cell.name))

    metrics = {}
    if trace:
        ctx = trace_context(cell, summary, work, timed)
        for m in cell.per_layer:
            v = metric_reader(root, m.name)(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        rates = {"train_samples_per_s": work["rows"] / window,
                 "eval_items_per_s": work["items"] / window,
                 "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": rates[m.name], "unit": m.unit}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "summary": summary, "checks": checks,
            "readings": got, "lines": lines, "peak": peak}


def trace_context(cell: Cell, summary: dict, work: dict, timed: dict):
    """What the per-layer readers read (``readers.py``)."""
    return {"trace": summary, "work": work, "timed": timed,
            "records": timed["records"],
            "routes": {r: v.ranges for r, v in cell.arch.routes().items()}}


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    else:
        yield float(tree)


def _smi(device: str) -> str:
    if device != "cuda":
        return "nvidia-smi: not on a card"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return "nvidia-smi: " + out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: unavailable ({e})"

