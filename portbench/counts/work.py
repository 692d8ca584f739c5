"""The work of whole rounds and evaluation passes, from the benchmark's
own plan (the sampled clients, their shard sizes, E and B, the test
sizes): rows and items, model FLOPs, and each kernel route's least time,
through the cell's architecture (``portbench/arch/``).  Nothing here
reads the program."""

from __future__ import annotations

from typing import List

from portbench.inputs import DatasetArrays, RoundWork


def towers(modality: str):
    return {"img": ("img",), "txt": ("txt",), "img+txt": ("img", "txt")}[
        modality]


def train_row_flops(arch, config: dict, modality: str,
                    classes: int = 0) -> float:
    """One training row (a sample, or an image-caption pair): 3 forwards."""
    return 3.0 * sum(arch.forward_flops(config, t, classes)
                     for t in towers(modality))


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


def eval_flops(arch, config: dict, datasets: List[DatasetArrays],
               batch: int) -> float:
    return sum(arch.forward_flops(config, tower, d.classes or 0) * rows
               for d in datasets for tower, rows in _eval_batches(d, batch))


def train_flops(arch, config: dict, datasets: List[DatasetArrays],
                work: RoundWork) -> float:
    return sum(train_row_flops(arch, config, d.modality, d.classes or 0)
               * sum(work.step_rows.get(d.name, ()))
               for d in datasets)


def route_least(arch, config: dict, route: str,
                datasets: List[DatasetArrays], rounds: List[RoundWork],
                evals: int, batch: int) -> float:
    """Least seconds of ``route``'s calls over ``rounds`` (training) and
    ``evals`` central evaluations: each layer kind's least, as many times
    as a tower has it."""
    least = arch.routes()[route].least
    total = 0.0
    for work in rounds:
        for d in datasets:
            n = work.clients.get(d.name, 0)
            for rows in work.step_rows.get(d.name, ()):
                for tower in towers(d.modality):
                    N = arch.tokens(config, tower)
                    for count, layer in arch.layers(config, tower):
                        total += count * least(rows, n, N, layer, True)
    for d in datasets:
        for tower, rows in _eval_batches(d, batch):
            N = arch.tokens(config, tower)
            for count, layer in arch.layers(config, tower):
                total += evals * count * least(rows, 1, N, layer, False)
    return total


def plan_work(arch, config: dict, datasets: List[DatasetArrays],
              rounds: List[RoundWork], evals: int, batch: int) -> dict:
    """The work of ``rounds`` and ``evals`` central evaluations: model
    FLOPs, stacked group steps, training rows, evaluated items, and every
    route's least seconds."""
    flops = evals * eval_flops(arch, config, datasets, batch) + sum(
        train_flops(arch, config, datasets, w) for w in rounds)
    return {"model_flops": flops,
            "steps": sum(w.steps for w in rounds),
            "rows": sum(w.rows for w in rounds),
            "items": evals * eval_items(datasets),
            "least": {r: route_least(arch, config, r, datasets, rounds,
                                     evals, batch)
                      for r in arch.routes()}}
