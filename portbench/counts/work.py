"""The work of whole rounds and evaluation passes, from the benchmark's
own plan (the sampled clients, their shard sizes, E and B, the test
sizes): rows and items, model FLOPs, and each kernel route's least time.
Nothing here reads the program."""

from __future__ import annotations

from typing import List

from portbench.counts.kernels import layer_least
from portbench.counts.model import forward_flops, tokens, towers, \
    train_row_flops
from portbench.inputs import DatasetArrays, RoundWork


def eval_items(datasets: List[DatasetArrays]) -> int:
    """Items one central evaluation encodes: each test image once (a
    retrieval set's unique images) and each text row or caption once."""
    n = 0
    for d in datasets:
        t = d.test
        if d.task == "cls":
            n += len(t["targets"])
        else:
            n += len(t["image_store"]) + len(t["texts"])
    return n


def _eval_batches(d: DatasetArrays, batch: int):
    """(tower, rows) of each batch one evaluation runs on ``d``."""
    t = d.test
    if d.task == "cls":
        sizes = {towers(d.modality)[0]: len(t["targets"])}
    else:
        sizes = {"img": len(t["image_store"]), "txt": len(t["texts"])}
    for tower, n in sizes.items():
        for j in range(0, n, batch):
            yield tower, min(batch, n - j)


def eval_flops(config: dict, datasets: List[DatasetArrays],
               batch: int) -> float:
    return sum(forward_flops(config, tower, d.classes or 0) * rows
               for d in datasets for tower, rows in _eval_batches(d, batch))


def train_flops(config: dict, datasets: List[DatasetArrays],
                work: RoundWork) -> float:
    return sum(train_row_flops(config, d.modality, d.classes or 0)
               * sum(work.step_rows.get(d.name, ()))
               for d in datasets)


def route_least(config: dict, route: str, datasets: List[DatasetArrays],
                rounds: List[RoundWork], evals: int, batch: int) -> float:
    """Least seconds of ``route``'s calls over ``rounds`` (training) and
    ``evals`` central evaluations."""
    depth = config["depth"]
    total = 0.0
    for work in rounds:
        for d in datasets:
            n = work.clients.get(d.name, 0)
            for rows in work.step_rows.get(d.name, ()):
                for tower in towers(d.modality):
                    total += depth * layer_least(
                        route, rows, n, tokens(config, tower), config, True)
    for d in datasets:
        for tower, rows in _eval_batches(d, batch):
            total += evals * depth * layer_least(
                route, rows, 1, tokens(config, tower), config, False)
    return total
