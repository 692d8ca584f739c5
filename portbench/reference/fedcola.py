"""FedCola's round and central evaluation, plainly (reference
fedavgserver.py ``update`` / ``_central_evaluate``, fedavgclient.py).

A round samples each dataset's clients, trains each sampled client alone
from its dataset's global model (E epochs of its shard, each reshuffled,
batches of B, the last one partial; AdamW with torch's defaults and
weight decay 0), folds a uni-modal client's aux into its upload, then
aggregates each global model leaf by leaf: a client weighs in by its shard
size where the leaf's scope admits it (the leaves the architecture shares
under ``--shared_param attn``: clients whose modality overlaps the
model's; every other leaf: the model's own clients), over the sizes of
all overlapping clients (compensation), as the reference's streaming
update ``g += (w - g) * c`` over sorted client ids.  Then each uni-modal
model's aux takes the other modality's new model (the architecture's
``exchange_aux``), and the learning rate decays.  The model is the
cell's architecture's (``portbench/arch/``), handed in.

The shuffle stream is ``numpy.random.RandomState(seed + 1)``, consumed
dataset by dataset, client by client, epoch by epoch, as the reference's
loaders draw it; the evaluation order of a retrieval set is
``RandomState(seed + round)``'s permutation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.inputs import DatasetArrays, client_index, flag, \
    sample_round
from portbench.reference.precision import Products
from portbench.tree import get, leaves, put

# the model's input slots (reference mome.py): image 0, text 1
SLOTS = {"img": 0, "txt": 1}


@dataclass(frozen=True)
class Line:
    """The settings of the line that the reference follows."""
    seed: int
    epochs: int
    batch: int
    lr: float
    lr_decay: float
    lr_decay_step: int
    fraction: float
    compensation: bool
    with_aux: bool
    shared: str
    scope: str
    eval_batch: int

    @classmethod
    def from_flags(cls, flags: List[str]) -> "Line":
        for name, ok in (("--algorithm", "fedavg"), ("--optimizer", "AdamW"),
                         ("--equal_sampled", True),
                         ("--colearn_param", "none")):
            if flag(flags, name) != ok:
                raise ValueError(f"the reference follows {name} {ok} only")
        if flag(flags, "--weight_decay", "0") not in ("0", "0.0"):
            raise ValueError("the reference follows weight decay 0 only")
        shared = flag(flags, "--shared_param", "none")
        scope = flag(flags, "--share_scope", "dataset")
        comp = bool(flag(flags, "--compensation", False))
        if shared not in ("none", "attn") or scope not in ("dataset",
                                                           "modality"):
            raise ValueError("the reference follows --shared_param none|attn "
                             "under --share_scope dataset|modality only")
        if comp and scope != "modality":
            raise ValueError("--compensation: --share_scope modality only")
        return cls(seed=int(flag(flags, "--seed")),
                   epochs=int(flag(flags, "--E")),
                   batch=int(flag(flags, "--B")),
                   lr=float(flag(flags, "--lr")),
                   lr_decay=float(flag(flags, "--lr_decay", "1.0")),
                   lr_decay_step=int(flag(flags, "--lr_decay_step", "1")),
                   fraction=float(flag(flags, "--Cs")),
                   compensation=comp,
                   with_aux=bool(flag(flags, "--with_aux", False)),
                   shared=shared, scope=scope,
                   eval_batch=int(flag(flags, "--eval_batch_size", "64")))


def _overlap(a: str, b: str) -> bool:
    return a in b or b in a


class Federation:
    """The global models and the state a run carries from round to round."""

    def __init__(self, arch, line: Line, config: dict,
                 datasets: List[DatasetArrays], weights: Dict[str, dict],
                 device, products: Optional[Products] = None):
        self.arch = arch
        self.line = line
        self.data = datasets
        self.device = device
        self.mm = products or Products()
        self.specs = {d.name: arch.model_spec(config, d.modality, d.task,
                                              d.classes, line.with_aux)
                      for d in datasets}
        self.params = weights
        self.shuffle = np.random.RandomState(line.seed + 1)
        self.lr = line.lr
        self.where = client_index(datasets)
        self.first_grads: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self._arrays: Dict[str, Dict[str, torch.Tensor]] = {}

    # ----------------------------------------------------------- data --

    def _train_arrays(self, d: DatasetArrays) -> Dict[str, torch.Tensor]:
        if d.name not in self._arrays:
            self._arrays[d.name] = {k: torch.from_numpy(v).to(self.device)
                                    for k, v in d.train.items()}
        return self._arrays[d.name]

    def _batch(self, d: DatasetArrays, s, rows: np.ndarray):
        """(inputs by slot, target) of the train rows ``rows``."""
        A, a = self.arch, self._train_arrays(d)
        idx = torch.from_numpy(rows).to(self.device)
        if d.modality == "img":
            return {SLOTS["img"]: A.preprocess(s, a["images"][idx])}, \
                a["targets"][idx]
        if d.modality == "txt":
            return {SLOTS["txt"]: a["texts"][idx]}, a["targets"][idx]
        img = a["image_store"][a["image_row"][idx]]
        return {SLOTS["img"]: A.preprocess(s, img),
                SLOTS["txt"]: a["texts"][idx]}, None

    def _loss(self, d, s, p, rows):
        A = self.arch
        ins, y = self._batch(d, s, rows)
        out = A.forward(s, p, ins, self.mm)
        if d.modality == "img+txt":
            return A.contrastive(out[SLOTS["img"]], out[SLOTS["txt"]])
        return A.cross_entropy(out[SLOTS[d.modality]], y)

    # ------------------------------------------------------- training --

    def _train_client(self, d: DatasetArrays, steps: List[np.ndarray],
                      record_grad: bool):
        """One client's local update; returns (trained tree, mean loss)."""
        s = self.specs[d.name]
        flat = [(path, t.detach().clone().requires_grad_(True))
                for path, t in leaves(self.params[d.name])]
        tree: dict = {}
        for path, t in flat:
            put(tree, path, t)
        ts = [t for _, t in flat]
        m1 = [torch.zeros_like(t) for t in ts]
        m2 = [torch.zeros_like(t) for t in ts]
        loss_sum, rows_sum = 0.0, 0
        for step, rows in enumerate(steps, start=1):
            loss = self._loss(d, s, tree, rows)
            grads = torch.autograd.grad(loss, ts, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(ts, grads)]
            if record_grad and step == 1:
                self.first_grads[d.name] = {
                    sub: float(x.double().norm())
                    for (path, _), g in zip(flat, grads)
                    for sub, x in self.arch.parts(path, g)}
            with torch.no_grad():
                c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
                for t, g, a, b in zip(ts, grads, m1, m2):
                    a.mul_(0.9).add_(g, alpha=0.1)
                    b.mul_(0.999).addcmul_(g, g, value=0.001)
                    t.sub_(self.lr * (a / c1) / ((b / c2).sqrt() + 1e-8))
            loss_sum += float(loss.detach()) * len(rows)
            rows_sum += len(rows)
        trained = self.arch.fold_aux(s, tree)
        return ({k: v for k, v in _detach(trained).items()},
                loss_sum / max(rows_sum, 1))

    def run_round(self, r: int) -> Dict[int, float]:
        """Round ``r``; returns each sampled client's mean training loss."""
        ln = self.line
        sampled = sample_round(ln.seed, self.data, ln.fraction, r)
        uploads, losses = {}, {}
        for i, d in enumerate(self.data):
            mine = [c for c in sampled if self.where[c][0] == i]
            streams = []
            for c in mine:
                shard = d.shards[self.where[c][1]]
                steps = []
                for _ in range(ln.epochs):
                    order = shard.copy()
                    self.shuffle.shuffle(order)
                    steps += [order[j:j + ln.batch]
                              for j in range(0, len(order), ln.batch)]
                streams.append(steps)
            for j, (c, steps) in enumerate(zip(mine, streams)):
                record = r == 1 and j == 0
                uploads[c], losses[c] = self._train_client(d, steps, record)
        self._aggregate(sampled, uploads)
        if r % ln.lr_decay_step == 0:
            self.lr *= ln.lr_decay
        return losses

    @torch.no_grad()
    def _aggregate(self, sampled: List[int], uploads: Dict[int, dict]):
        ln, A = self.line, self.arch
        sizes = {c: len(self.data[self.where[c][0]].shards[self.where[c][1]])
                 for c in sampled}
        mod = {c: self.data[self.where[c][0]].modality for c in sampled}
        new = {}
        for pos, d in enumerate(self.data):
            g = self.params[d.name]
            out = _copy(g)
            over = sum(sizes[c] for c in sampled if _overlap(mod[c], d.modality))
            for path, leaf in leaves(g):
                if A.exchanged(path):
                    continue
                shared = (ln.shared == "attn" and ln.scope == "modality"
                          and A.shared_leaf(path))
                num = {c: (sizes[c] if (_overlap(mod[c], d.modality)
                                        if shared else
                                        self.where[c][0] == pos)
                           else 0) for c in sampled}
                denom = over if ln.compensation else sum(num.values())
                final = leaf
                for c in sampled:
                    coef = num[c] / denom if denom else 0.0
                    if coef == 0.0:
                        continue
                    try:
                        w = get(uploads[c], path)
                    except KeyError:
                        continue            # the client's model lacks it
                    final = final + (w - final) * coef
                put(out, path, final)
            new[d.name] = out
        if ln.with_aux:
            first = {}
            for d in self.data:
                first.setdefault(d.modality, d.name)
            for d in self.data:
                s = self.specs[d.name]
                if not A.has_aux(s):
                    continue
                other = "txt" if d.modality == "img" else "img"
                if other not in first:
                    continue
                A.exchange_aux(s, new[d.name], self.specs[first[other]],
                               new[first[other]])
        self.params = new

    # ----------------------------------------------------- evaluation --

    @torch.no_grad()
    def evaluate(self, r: int) -> Dict[str, dict]:
        """Central evaluation after round ``r``: per classification set
        ``{"loss", "acc1"}``, per retrieval set the recalls and ranks of
        the whole test set (``5k``) and of its five folds (``1k``)."""
        out, A = {}, self.arch
        for d in self.data:
            s, p = self.specs[d.name], self.params[d.name]
            B = self.line.eval_batch
            t = {k: torch.from_numpy(v).to(self.device)
                 for k, v in d.test.items()}
            if d.task == "cls":
                slot = SLOTS[d.modality]
                x = t["images"] if d.modality == "img" else t["texts"]
                loss, correct = 0.0, 0
                for j in range(0, len(x), B):
                    xb = x[j:j + B]
                    if d.modality == "img":
                        xb = A.preprocess(s, xb)
                    logits = A.forward(s, p, {slot: xb}, self.mm)[slot]
                    y = t["targets"][j:j + B]
                    loss += float(torch.nn.functional.cross_entropy(
                        logits, y, reduction="sum"))
                    correct += int((logits.argmax(-1) == y).sum())
                out[d.name] = {"loss": loss / len(x), "acc1": correct / len(x)}
                continue
            store = t["image_store"]
            i, x = SLOTS["img"], SLOTS["txt"]
            fi = torch.cat([A.forward(s, p, {i: A.preprocess(
                s, store[j:j + B])}, self.mm, feat_out=True)[i]
                for j in range(0, len(store), B)])
            ft = torch.cat([A.forward(s, p, {x: t["texts"][j:j + B]}, self.mm,
                                      feat_out=True)[x]
                            for j in range(0, len(t["texts"]), B)])
            out[d.name] = retrieval_scores(
                fi, ft, d.test["image_row"],
                np.random.RandomState(self.line.seed + r))
        return out


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


# ------------------------------------------------------------ retrieval --

def retrieval_scores(img_feats: torch.Tensor, cap_feats: torch.Tensor,
                     image_row: np.ndarray, rng) -> dict:
    """Recalls of a retrieval test set (reference eval_coco.py:90-465):
    captions in a shuffled order, images first-seen in it, each image's
    captions grouped after; i2t and t2i over the whole set and the mean
    over five positional folds."""
    order = np.arange(len(image_row))
    rng.shuffle(order)
    ids = image_row[order]
    first: Dict[int, int] = {}
    img_ids = []
    for iid in ids.tolist():
        if iid not in first:
            first[iid] = len(img_ids)
            img_ids.append(iid)
    keys = np.fromiter((first[i] for i in ids.tolist()), np.int64, len(ids))
    sorted_idx = np.argsort(keys, kind="stable")
    dev = img_feats.device
    imf = img_feats.index_select(0, torch.as_tensor(img_ids, device=dev))
    capf = cap_feats.index_select(0, torch.from_numpy(
        order[sorted_idx]).to(dev))
    imc = np.asarray(img_ids)
    capc = ids[sorted_idx]
    n = len(imf)
    per = 1000 if n >= 5000 else max(n // 5, 1)
    scores = {"5k": {"i2t": _recall(imf, capf, imc, capc),
                     "t2i": _recall(capf, imf, capc, imc)},
              "1k": _folds(imf, capf, imc, capc, per)}
    return scores


def _recall(q, g, qc, gc) -> dict:
    sims = q @ g.T
    order = torch.argsort(-sims, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    pos = torch.as_tensor(qc, device=q.device)[:, None] == \
        torch.as_tensor(gc, device=q.device)[None, :]
    big = torch.iinfo(torch.int64).max
    best = torch.where(pos, ranks, torch.full_like(ranks, big)).min(1) \
        .values.cpu().numpy()
    return {"recall_1": float(np.mean(best < 1)),
            "recall_5": float(np.mean(best < 5)),
            "recall_10": float(np.mean(best < 10)),
            "meanr": float(np.mean(best) + 1)}


def _folds(imf, capf, imc, capc, per: int) -> dict:
    pos_of = {c: i for i, c in enumerate(imc.tolist())}
    cap_pos = np.fromiter((pos_of[c] for c in capc.tolist()), np.int64,
                          len(capc))
    got = {"i2t": [], "t2i": []}
    for k in range(5):
        a, b = k * per, (k + 1) * per
        ca = int(np.searchsorted(cap_pos, a, "left"))
        cb = int(np.searchsorted(cap_pos, b, "left"))
        if len(imf[a:b]) == 0 or cb <= ca:
            continue
        got["i2t"].append(_recall(imf[a:b], capf[ca:cb], imc[a:b],
                                  capc[ca:cb]))
        got["t2i"].append(_recall(capf[ca:cb], imf[a:b], capc[ca:cb],
                                  imc[a:b]))
    return {d: {k: float(np.mean([f[k] for f in v])) for k in v[0]}
            for d, v in got.items()}

