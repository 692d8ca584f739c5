"""The comparison that decides ``correct``: each number the program's timed
path produced against the plain reference's, as a relative gap, held to
its limit in ``portbench/limits/<cell>.json``.

* ``loss``, ``loss_median``: the worst and the median of the sampled
  clients' mean training losses of each followed round,
  ``|program - reference| / reference``.
* ``change``: per parameter of every global model (the architecture's
  ``parts`` of each leaf), the norm of its change over the followed
  rounds, ``|‖Δ program‖ - ‖Δ reference‖|`` over the larger of the
  reference's ``‖Δ‖`` of that parameter and of the model's median one;
  the worst (``change``) and the median (``change_median``).  Parameters
  whose first reference gradient is under a thousandth of the model's
  median one's (a key's bias under softmax) move by round-off alone and
  are left out.
* ``eval_loss``: the worst classification test set's mean cross-entropy.
* ``rtv_meanr``: the worst mean rank of a retrieval set (i2t and t2i, the
  whole set and the mean of its folds).
* ``init_eval_loss``, ``init_rtv_meanr``: the same of a training cell's
  evaluation of its initial weights, before the first round.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench.tree import get, leaves


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def loss_gaps(prog: Dict[int, Dict[int, float]],
              ref: Dict[int, Dict[int, float]]) -> List[float]:
    gaps = []
    for r, losses in ref.items():
        if set(prog[r]) != set(losses):
            raise RuntimeError(f"round {r}: the program trained clients "
                               f"{sorted(prog[r])}, the plan "
                               f"{sorted(losses)}")
        gaps += [_rel(prog[r][c], v) for c, v in losses.items()]
    return gaps


def change_gaps(prog_delta: Dict[str, Dict[tuple, float]],
                ref_delta: Dict[str, Dict[tuple, float]],
                first_grads: Dict[str, Dict[tuple, float]]) -> List[float]:
    gaps = []
    for ds, ref in ref_delta.items():
        grads = first_grads.get(ds, {})
        gmed = float(np.median(list(grads.values()))) if grads else 0.0
        kept = [p for p in ref if grads.get(p, gmed) >= 1e-3 * gmed]
        med = float(np.median([ref[p] for p in kept]))
        gaps += [abs(prog_delta[ds][p] - ref[p]) / max(ref[p], med, 1e-30)
                 for p in kept]
    return gaps


def training_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The worst and the median of the clients' loss gaps and of the
    parameters' change gaps."""
    loss = loss_gaps(prog["losses"], ref["losses"])
    change = change_gaps(prog["delta"], ref["delta"], ref["grads"])
    return {"loss": max(loss), "loss_median": float(np.median(loss)),
            "change": max(change),
            "change_median": float(np.median(change))}


def eval_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    out: Dict[str, List[float]] = {"eval_loss": [], "rtv_meanr": []}
    for ds, r in ref.items():
        p = prog[ds]
        if "loss" in r:
            out["eval_loss"].append(_rel(p["loss"], r["loss"]))
        else:
            out["rtv_meanr"] += [_rel(p[f][d]["meanr"], r[f][d]["meanr"])
                                 for f in ("5k", "1k") for d in ("i2t", "t2i")]
    return {k: max(v) for k, v in out.items() if v}


def limits_of(root: Path, cell: str) -> Dict[str, float]:
    path = Path(root) / "portbench" / "limits" / f"{cell}.json"
    return {k: float(v) for k, v in json.loads(path.read_text()).items()
            if not k.startswith("_")}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number that has a limit within it; a limit
    with no number is not correct.  A reading with no limit is not
    compared (PERF.md names each, with why)."""
    checks = {k: {"value": readings.get(k), "limit": limits[k]}
              for k in sorted(limits)}
    ok = all(c["value"] is not None and c["limit"] is not None
             and np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def describe(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def norms(parts, tree_a: dict,
          tree_b: Optional[dict] = None) -> Dict[tuple, float]:
    """Per parameter (the architecture's ``parts`` of each leaf): ``‖a -
    b‖`` (or ``‖a‖``), in float64."""
    out = {}
    for path, a in leaves(tree_a):
        d = a.double() if tree_b is None else a.double() - get(
            tree_b, path).double()
        for sub, x in parts(path, d):
            out[sub] = float(x.norm())
    return out


def worst_parts(prog_delta, ref_delta, first_grads, k: int = 5):
    """The ``k`` parts with the widest change gaps, for a look."""
    rows = []
    for ds, ref in ref_delta.items():
        grads = first_grads.get(ds, {})
        gmed = float(np.median(list(grads.values()))) if grads else 0.0
        med = float(np.median(list(ref.values())))
        for p, r in ref.items():
            gap = abs(prog_delta[ds][p] - r) / max(r, med, 1e-30)
            rows.append((gap, ds, str(p), prog_delta[ds][p], r,
                         grads.get(p, 0.0) / max(gmed, 1e-30)))
    return sorted(rows, reverse=True)[:k]
