"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``fedcola_tpu_torch``, on a machine with the card(s) the
cell asks for.  Exits non-zero without printing a result when CUDA is
absent or has fewer cards, when a module of JAX or the JAX package was
loaded, or when anything fails.  The last lines of standard error, and
the last key of the result line, give each number compared beside its
limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    root = Path.cwd()
    from portbench.spec import resolve_cell
    cell = resolve_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    from portbench.cell import forbidden_modules, run_cell
    from portbench.check import describe
    from portbench.trace import breakdown
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, root)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if args.trace:
        device.update(res["summary"]["device"])
        out["breakdown"] = breakdown(res["summary"])
    out["checks"] = res["checks"]
    loose = [f"reading {k} {v!r} (not compared)"
             for k, v in sorted(res["readings"].items())
             if k not in res["checks"]]
    for line in res["lines"] + loose + describe(res["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
