"""The readings the limits of ``portbench/limits/<cell>.json`` are set from,
at the cell's own size; the benchmark's runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 \\
        [--control] [--fault frozen|half|answer] [--dtype float32] [--detail]

For each seed, one JSON line: the program's readings against the plain
reference (what the cell's run compares, without the measured window);
with ``--control``, also the control's, the reference itself computed with
float8 e4m3 (the precision below the configuration's bf16,
``reference/precision.py``) in the program's place; with ``--fault``, the readings of the program with
that fault planted (``faults.py``); with ``--dtype``, the program at
another compute precision (a witness: at float32 it should agree with the
reference to round-off); with ``--detail``, each followed round's worst
loss gap, the parameters of widest change gap and the evaluation's
numbers on both sides.  All seeds run in one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

from portbench import check, program
from portbench.cell import Run, _inputs, _reference, cache_env, readings
from portbench.inputs import make_weights
from portbench.reference.precision import no_tf32
from portbench.spec import resolve_cell


def program_side(cell, seed: int, device: str, root: Path) -> dict:
    """The program's outputs over the cell's followed rounds (or one
    evaluation pass) from the seed's inputs."""
    run = Run(cell, seed, device, root)
    follow = int(cell.traffic["follow_rounds"]) if run.mode == "rounds" else 0
    run.follow(max(follow, 1))
    out = {"losses": dict(run.losses),
           "eval": program.eval_results(run.server, run.round, run.data),
           "init_eval": program.eval_results(run.server, 0, run.data)
           if follow else None, "round": run.round}
    if follow:
        _, _, layouts = _inputs(cell, seed, device)
        w0 = make_weights(layouts, seed, device, cell.arch)
        out["delta"] = {ds: check.norms(cell.arch.parts, t, w0[ds])
                        for ds, t in run.server.global_params.items()}
    return out


def detail(prog: dict, ref: dict) -> dict:
    out = {"eval": {ds: [prog["eval"][ds], r]
                    for ds, r in ref["eval"].items()}}
    if ref["losses"]:
        out["loss_by_round"] = {r: max(check.loss_gaps(
            {r: prog["losses"][r]}, {r: v})) for r, v in ref["losses"].items()}
        out["worst_parts"] = check.worst_parts(prog["delta"], ref["delta"],
                                               ref["grads"])
    return out


def control_lines(cell, seeds, device: str, root: Path, control: bool,
                  fault=None, dtype=None, details=False):
    """One dict of readings a seed."""
    import torch
    cache_env(Path(root))
    if device == "cuda":
        no_tf32()
    follow = int(cell.traffic["follow_rounds"]) \
        if cell.traffic["mode"] == "rounds" else 0
    prog_cell = cell if dtype is None else dataclasses.replace(
        cell, config={**cell.config, "compute_dtype": dtype})
    for seed in seeds:
        if fault:
            from portbench.faults import planted
            with planted(fault):
                prog = program_side(prog_cell, seed, device, root)
        else:
            prog = program_side(prog_cell, seed, device, root)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = _reference(cell, seed, device, follow, prog["round"])
        line = {"seed": seed, "fault": fault, "dtype": dtype,
                "program": readings(prog, ref)}
        if details:
            line["program_detail"] = detail(prog, ref)
        if control:
            low = _reference(cell, seed, device, follow, prog["round"],
                             fp8=True)
            line["control"] = readings(low, ref)
            if details:
                line["control_detail"] = detail(low, ref)
        yield line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--detail", action="store_true")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control reads the card: no CUDA device",
              file=sys.stderr)
        return 2
    root = Path.cwd()
    cell = resolve_cell(root, args.workload)
    for line in control_lines(cell, args.seeds, "cuda", root, args.control,
                              args.fault, args.dtype, args.detail):
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
