"""The system under test, ``fedcola_tpu_torch``, as the benchmark drives it:
its configuration from the cell's flags, its data in its own
``FederatedData`` type, its server from ``create_server``, the benchmark's
weights in place of its initial ones, and what its rounds and
evaluations report.  The only module of the benchmark that imports the
program."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.inputs import DatasetArrays
from portbench.tree import leaves


def flags_of(cell, device: str, out_dir: str) -> List[str]:
    """The program's command line: the traffic's line, then the
    architecture's flags for the configuration (its model, widths,
    precision), the device and the output paths."""
    return list(cell.traffic["flags"]) + list(
        cell.arch.program_flags(cell.config)) + [
        "--device", device, "--result_path", out_dir, "--log_path", out_dir]


def federated_data(datasets: List[DatasetArrays], modalities: List[str]):
    """The arrays and split as the program's ``FederatedData``: one train
    ``TaskDataset`` shared by a dataset's client shards, its test set the
    server's evaluation set; a retrieval set keeps one image per 5 caption
    rows (``_image_store`` / ``_image_row``, the layout of a materialised
    COCO)."""
    from fedcola_tpu_torch.data.datasets import TaskDataset
    from fedcola_tpu_torch.data.loaders import FederatedData
    from fedcola_tpu_torch.data.pipeline import ClientShard
    from fedcola_tpu_torch.federation.aggregate import ClientMeta

    def task_dataset(d: DatasetArrays, part: Dict[str, np.ndarray]):
        if d.task == "cls":
            n = len(part["targets"])
            return TaskDataset(name=d.name, task="cls", modality=d.modality,
                               num_classes=d.classes, n=n,
                               images=part.get("images"),
                               texts=part.get("texts"),
                               targets=part["targets"])
        rows = len(part["texts"])
        store = part["image_store"]
        return TaskDataset(
            name=d.name, task="rtv", modality=d.modality, num_classes=None,
            n=rows, image_size=store.shape[1], texts=part["texts"],
            targets=part["texts"], image_ids=part["image_row"],
            ann_ids=np.arange(rows), _image_store=store,
            _image_row=part["image_row"])

    out = FederatedData()
    cid = 0
    for i, d in enumerate(datasets):
        train = task_dataset(d, d.train)
        out.server_eval[d.name] = task_dataset(d, d.test)
        for shard in d.shards:
            out.client_shards.append(ClientShard(dataset=train,
                                                 indices=shard))
            out.client_meta[cid] = ClientMeta(
                id=cid, dataset=d.name, modality=modalities[i], task=d.task,
                n_train=len(shard))
            cid += 1
    return out


def create(cell, datasets, weights: Dict[str, dict], device: str,
           out_dir: str):
    """The program's server on the benchmark's data and weights, after a
    check that its models are the configuration's architecture (the
    attributes and values of ``program_check``) and its parameter trees
    the reference's layout."""
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.federation.server import create_server

    cfg = parse_args(flags_of(cell, device, out_dir))
    server = create_server(cfg, federated_data(datasets, cfg.modalities))
    want = dict(cell.arch.program_check(cell.config))
    for ds, mcfg in server.model_cfgs.items():
        lacks = sorted(k for k in want if not hasattr(mcfg, k))
        got = {k: getattr(mcfg, k, None) for k in want}
        if lacks or got != want:
            raise RuntimeError(
                f"{ds}: the program's model ({type(mcfg).__name__}) is not "
                f"architecture {cell.architecture!r} as configured: "
                f"it lacks {lacks}; it has {got}, the configuration "
                f"{want}")
        mine = {p: tuple(t.shape) for p, t in leaves(weights[ds])}
        theirs = {p: tuple(t.shape) for p, t in leaves(server.global_params[ds])}
        if mine != theirs:
            raise RuntimeError(f"{ds}: the program's parameter layout "
                               f"differs from the reference's: "
                               f"{sorted(set(mine.items()) ^ set(theirs.items()))[:6]}")
        server.global_params[ds] = weights[ds]
    return server


def client_losses(server, r: int) -> Dict[int, float]:
    return {int(c): float(v["loss"])
            for c, v in server.results[r]["clients_updated"].items()}


def eval_results(server, r: int, datasets: List[DatasetArrays]) -> dict:
    """The central evaluation of round ``r`` in the reference's shape."""
    out = {}
    for d in datasets:
        res = server.results[r][f"server_evaluated_{d.name}"]
        if d.task == "cls":
            out[d.name] = {"loss": float(res["loss"]),
                           "acc1": float(res["metrics"]["acc1"])}
            continue
        out[d.name] = {
            fold: {dr: {m: float(res[f"{d.name} {fold}_{dr}_{m}"])
                        for m in ("recall_1", "recall_5", "recall_10",
                                  "meanr")}
                   for dr in ("i2t", "t2i")} for fold in ("5k", "1k")}
    return out


def snapshot(server) -> Dict[str, dict]:
    """A copy of the global models."""
    return {ds: _clone(t) for ds, t in server.global_params.items()}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def round_record(server, r: int) -> dict:
    """The program's own clocks of round ``r`` (host clock after a
    synchronize): the round, its sections, the central evaluation."""
    res = server.results[r]
    return {"round_seconds": res.get("round_seconds"),
            "sections": dict(res.get("round_sections", {})),
            "eval_seconds": res.get("eval_seconds")}


def launches() -> Dict[str, int]:
    from fedcola_tpu_torch.ops import kernels
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
