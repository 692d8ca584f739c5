"""Image-text retrieval evaluator (reference ``COCOEvaluator``,
src/metrics/eval_coco.py:90-465); port of ``fedcola_tpu/eval/retrieval.py``.

* features come from the MAT with ``feat_out=True`` over the test set in
  a shuffled order (the reference's shuffle=True eval loader), images are
  deduped by image id keeping first-seen order, and caption features are
  re-sorted so each image's captions are contiguous;
* with the test set staged on the device (``resident``), every batch is a
  device gather and the features stay there; a deduplicated image store
  splits the towers: the image tower runs once per unique image, the text
  tower once per caption row (``FEDCOLA_EVAL_UNIQUE_IMAGES=0`` runs the
  joint per-row forward instead).  The JAX package's
  ``FEDCOLA_EVAL_CHUNK_STEPS`` is not carried: it only groups batches into
  one jitted call there and changes no number, and eager PyTorch has no
  call to group;
* ``evaluate_recall`` computes the [n_q, n_g] similarities, ranks them by a
  double (stable) argsort and takes the best rank among each query's
  positives, on the features' device;
* ``evaluate_n_fold`` runs 5 positional crossfolds of 1k images with the
  matching caption block per fold.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fedcola_tpu_torch.data.datasets import TaskDataset
from fedcola_tpu_torch.models.mat import DTYPES, MATConfig, mat_apply
from fedcola_tpu_torch.parallel.client_update import (GroupSpec, _take,
                                                      eval_batch,
                                                      eval_forward,
                                                      preprocess_images)
from fedcola_tpu_torch.utils.profiling import readback, span


def extract_features(cfg: MATConfig, spec: GroupSpec, params,
                     dataset: TaskDataset, batch_size: int = 512,
                     rng: Optional[np.random.RandomState] = None,
                     resident: Optional[Dict[str, torch.Tensor]] = None,
                     plan=None):
    """Returns aligned (image_features [n_img, D], caption_features
    [n_cap, D], image_classes, caption_classes) as float32 device tensors
    and numpy class vectors.  ``resident``: the test set's staged arrays,
    from which batches gather on the device; dedup and alignment need only
    the image ids, known on the host, so they are device gathers of the
    features either way.

    A deduplicated store (path-backed COCO / Flickr) splits the towers on
    the resident plane: the text tower runs per caption row and the image
    tower once per unique ``img_store`` row instead of once per caption,
    the same features (the eval forward is per sample) for a fifth of the
    image tower's work at five captions an image.  ``plan``: a mesh splits
    every batch over its ranks and all-gathers the features
    (``MeshPlan.eval_rows``), so every rank holds them all."""
    device = next(iter(params["norm"].values())).device
    order = np.arange(dataset.n)
    if rng is not None:
        rng.shuffle(order)
    ids = np.asarray(dataset.image_ids)[order]
    img_rows, image_classes, sorted_idx = _dedup_align(ids)
    if (resident is not None and "img_store" in resident
            and os.environ.get("FEDCOLA_EVAL_UNIQUE_IMAGES", "1") == "1"):
        dtype = DTYPES[cfg.compute_dtype]
        rows = lambda key, i: _take(  # noqa: E731
            resident[key], torch.from_numpy(i).to(device))
        ft_all, = _run_batches(
            lambda i: _tower(cfg, spec, params, spec.txt_slot,
                             rows("txt", i)),
            order, batch_size, plan)
        fi_all, = _run_batches(
            lambda i: _tower(cfg, spec, params, spec.img_slot,
                             preprocess_images(rows("img_store", i), spec,
                                               dtype)),
            np.arange(resident["img_store"].shape[0]), batch_size, plan)
        # fi_all is by store row: take each first-seen caption's store row
        img_rows = np.asarray(dataset._image_row, np.int64)[order[img_rows]]
    else:
        fi_all, ft_all = _run_batches(
            lambda i: eval_forward(cfg, spec, params, eval_batch(
                spec, i, device, dataset, resident)),
            order, batch_size, plan)
    take = lambda f, rows: f.index_select(  # noqa: E731
        0, torch.from_numpy(rows).to(device))
    return (take(fi_all, img_rows), take(ft_all, sorted_idx),
            image_classes, ids[sorted_idx])


def _run_batches(fwd: Callable, indices: np.ndarray,
                 batch_size: int, plan=None) -> tuple:
    """``fwd`` (row indices -> a feature tensor or a tuple of them) over
    ``indices`` in batches; the float32 features, concatenated on the
    device."""
    outs = None
    for start in range(0, len(indices), batch_size):
        i = indices[start:start + batch_size]
        f = fwd(i) if plan is None else plan.eval_rows(fwd, i)
        parts = f if isinstance(f, tuple) else (f,)
        if outs is None:
            outs = tuple([] for _ in parts)
        for o, p in zip(outs, parts):
            o.append(p.float())
    return tuple(torch.cat(o) for o in outs)


def _tower(cfg: MATConfig, spec: GroupSpec, params, slot: int, x):
    """One tower's eval features: the MAT with only input ``slot`` set."""
    ins = [None] * len(cfg.modalities)
    ins[slot] = x
    return mat_apply(cfg, params, ins, feat_out=True)[slot]


def _dedup_align(ids: np.ndarray):
    """First-seen image dedup + caption alignment from the extraction-order
    image-id vector (eval_coco.py:205-221).  Returns ``(img_rows,
    image_classes, sorted_idx)``."""
    first_pos: Dict[int, int] = {}
    img_rows = []
    image_classes = []
    for j, iid in enumerate(ids.tolist()):
        if iid not in first_pos:
            first_pos[iid] = len(img_rows)
            img_rows.append(j)
            image_classes.append(iid)
    keys = np.fromiter((first_pos[i] for i in ids.tolist()), np.int64,
                       len(ids))
    sorted_idx = np.argsort(keys, kind="stable")
    return (np.asarray(img_rows, np.int64), np.asarray(image_classes),
            sorted_idx)


def _best_positive_ranks(q: torch.Tensor, g: torch.Tensor,
                         q_cls: torch.Tensor, g_cls: torch.Tensor) -> torch.Tensor:
    """For each query: the smallest rank among its positive gallery items
    under descending similarity."""
    sims = q @ g.T
    order = torch.argsort(-sims, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    pos = q_cls[:, None] == g_cls[None, :]
    big = torch.iinfo(torch.int64).max
    return torch.where(pos, ranks, torch.full_like(ranks, big)).min(1).values


def evaluate_recall(q_features, g_features, q_classes,
                    g_classes) -> Dict[str, float]:
    q = torch.as_tensor(q_features).float()
    g = torch.as_tensor(g_features).float().to(q.device)
    best = _best_positive_ranks(
        q, g, torch.as_tensor(np.asarray(q_classes), device=q.device),
        torch.as_tensor(np.asarray(g_classes), device=q.device))
    with readback():
        best = best.cpu().numpy()
    scores = {
        "recall_1": float(np.mean(best < 1)),
        "recall_5": float(np.mean(best < 5)),
        "recall_10": float(np.mean(best < 10)),
    }
    scores["rsum"] = scores["recall_1"] + scores["recall_5"] + scores["recall_10"]
    scores["medr"] = float(np.floor(np.median(best)) + 1)
    scores["meanr"] = float(np.mean(best) + 1)
    return scores


def evaluate_n_fold(image_features, caption_features, image_classes,
                    caption_classes, n_crossfolds: int = 5,
                    n_images_per_fold: int = 1000) -> Dict[str, Dict[str, float]]:
    """Positional crossfolds (eval_coco.py:353-407); caption fold bounds
    follow the image fold through the grouped caption order."""
    pos_of = {c: i for i, c in enumerate(image_classes.tolist())}
    cap_pos = np.fromiter((pos_of[c] for c in caption_classes.tolist()),
                          np.int64, len(caption_classes))
    folds = {"i2t": [], "t2i": []}
    for k in range(n_crossfolds):
        a, b = k * n_images_per_fold, (k + 1) * n_images_per_fold
        ca = int(np.searchsorted(cap_pos, a, "left"))
        cb = int(np.searchsorted(cap_pos, b, "left"))
        isl, csl = slice(a, b), slice(ca, cb)
        if (len(image_features[isl]) == 0
                or len(caption_features[csl]) == 0):
            continue
        folds["i2t"].append(evaluate_recall(
            image_features[isl], caption_features[csl],
            image_classes[isl], caption_classes[csl]))
        folds["t2i"].append(evaluate_recall(
            caption_features[csl], image_features[isl],
            caption_classes[csl], image_classes[isl]))
    out = {}
    for d in ("i2t", "t2i"):
        keys = folds[d][0].keys()
        out[d] = {k: float(np.mean([f[k] for f in folds[d]])) for k in keys}
    return out


def evaluate(cfg: MATConfig, spec: GroupSpec, params, dataset: TaskDataset,
             batch_size: int = 512, n_crossfolds: int = 5,
             rng: Optional[np.random.RandomState] = None,
             resident: Optional[Dict[str, torch.Tensor]] = None,
             plan=None) -> Dict:
    """The features (span ``.forward``), then the ranking's recalls over
    the crossfolds and the whole set (``.rank``)."""
    with span(".forward"):
        imf, capf, imc, capc = extract_features(
            cfg, spec, params, dataset, batch_size, rng, resident, plan)
    scores: Dict = {}
    with span(".rank"):
        if n_crossfolds > 0 and len(imf) >= n_crossfolds * 1000:
            scores["n_fold"] = evaluate_n_fold(imf, capf, imc, capc,
                                               n_crossfolds)
        elif n_crossfolds > 0:
            nipf = max(len(imf) // n_crossfolds, 1)
            scores["n_fold"] = evaluate_n_fold(imf, capf, imc, capc,
                                               n_crossfolds, nipf)
        scores["i2t"] = evaluate_recall(imf, capf, imc, capc)
        scores["t2i"] = evaluate_recall(capf, imf, capc, imc)
    for key in ("rsum", "medr", "meanr"):
        scores[key] = scores["i2t"][key] + scores["t2i"][key]
    return scores
