"""Everything a run feeds the program, made from ``--seed`` and the traffic
file: the datasets (in-memory arrays), the client split, the per-round
client samples, and the work each round asks for.

The split and the client samples are the traffic's own: they come from
the traffic file's ``split_seed`` and the line's ``--seed`` flag, so every
``--seed`` gives the rounds the same clients, shard sizes and steps, and
changes only the pixels, tokens, class labels and weights.  The Dirichlet
split and the equal-sampled draw are the reference's rules
(src/loaders/split.py:135-166, 33-56; fedavgserver.py:282-312), written
here so that neither the inputs nor the work count depend on the program.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench.tree import put


@dataclass
class DatasetArrays:
    """One dataset's train and test arrays, as the traffic sizes them."""
    name: str
    modality: str                  # img | txt | img+txt
    task: str                      # cls | rtv
    classes: int | None
    train: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    shards: List[np.ndarray] = field(default_factory=list)


def _uint8(gen, shape, device) -> np.ndarray:
    return torch.randint(0, 256, shape, generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()


def _tokens(gen, rows, length, vocab, device) -> np.ndarray:
    ids = torch.randint(5, vocab, (rows, length), generator=gen,
                        device=device, dtype=torch.int32)
    ids[:, 0] = 2          # a [CLS] first, as every tokenised row has
    return ids.cpu().numpy()


def dirichlet_split(y: np.ndarray, classes: int, K: int, alpha: float,
                    rng: np.random.RandomState) -> List[np.ndarray]:
    """Dirichlet(alpha) per class, clients over the mean size masked out,
    redrawn until every client holds 10 rows."""
    N = len(y)
    min_size = 0
    while min_size < 10:
        parts = [[] for _ in range(K)]
        for c in range(classes):
            idx = np.where(y == c)[0]
            rng.shuffle(idx)
            p = rng.dirichlet(np.repeat(alpha, K))
            p = np.array([q * (len(b) < N / K) for q, b in zip(p, parts)])
            p = p / p.sum()
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            parts = [b + s.tolist() for b, s in zip(parts, np.split(idx, cuts))]
            min_size = min(len(b) for b in parts)
    out = []
    for b in parts:
        arr = np.array(b)
        rng.shuffle(arr)
        out.append(arr.astype(np.int64))
    return out


def caption_split(n_rows: int, K: int,
                  rng: np.random.RandomState) -> List[np.ndarray]:
    """Retrieval sets: whole images (5 caption rows each) to clients,
    0.95-0.99 of each share kept."""
    parts = np.array_split(rng.permutation(n_rows // 5), K)
    keep = rng.uniform(low=0.95, high=0.99, size=len(parts))
    parts = [p[: int(len(p) * r)] for p, r in zip(parts, keep)]
    return [(p[:, None] * 5 + np.arange(5)[None, :]).reshape(-1)
            .astype(np.int64) for p in parts]


def flag(flags: List[str], name: str, default=None):
    """The values of ``name`` in a flag list (a list for several, the
    value for one, True for a switch), or ``default``."""
    if name not in flags:
        return default
    at = flags.index(name) + 1
    vals = []
    while at < len(flags) and not flags[at].startswith("--"):
        vals.append(flags[at])
        at += 1
    return True if not vals else (vals[0] if len(vals) == 1 else vals)


def make_datasets(traffic: dict, shapes: dict, seed: int,
                  device) -> List[DatasetArrays]:
    """The datasets of the traffic mix, in its order, on the host, at the
    architecture's ``data_shapes`` (``pixels``, ``vocab``, ``text_len``).
    Pixels, tokens, test labels and a relabelling of the train classes
    come from ``seed`` (drawn on ``device``); train labels and the split
    from the traffic's ``split_seed``, the line's ``--Ks`` and
    ``--cncntrtn``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    split_rng = np.random.RandomState(int(traffic["split_seed"]))
    vocab, L = shapes["vocab"], shapes["text_len"]
    Ks = flag(traffic["flags"], "--Ks")
    Ks = [int(k) for k in (Ks if isinstance(Ks, list) else [Ks])]
    alpha = float(flag(traffic["flags"], "--cncntrtn"))
    names = list(traffic["datasets"])
    if flag(traffic["flags"], "--datasets")[:len(names)] != names \
            or len(Ks) != len(names):
        raise ValueError("the traffic's datasets are not its line's "
                         "--datasets / --Ks")
    out = []
    for i, (name, d) in enumerate(traffic["datasets"].items()):
        mod, task = d["modality"], d["task"]
        px = int(d.get("pixels", shapes["pixels"]))
        train, test = {}, {}
        if task == "cls":
            C = int(d["classes"])
            y = np.random.RandomState(
                int(traffic["split_seed"]) * 1000 + i).randint(
                    0, C, d["train"]).astype(np.int64)
            relabel = torch.randperm(C, generator=gen,
                                     device=device).cpu().numpy()
            train["targets"] = relabel[y]
            test["targets"] = torch.randint(
                0, C, (d["test"],), generator=gen,
                device=device).cpu().numpy().astype(np.int64)
            for part, n in ((train, d["train"]), (test, d["test"])):
                if mod == "img":
                    part["images"] = _uint8(gen, (n, px, px, 3), device)
                else:
                    part["texts"] = _tokens(gen, n, L, vocab, device)
            shards = dirichlet_split(y, C, Ks[i], alpha, split_rng)
        else:
            caps = int(d["captions"])
            for part, n in ((train, d["train_images"]),
                            (test, d["test_images"])):
                part["image_store"] = _uint8(gen, (n, px, px, 3), device)
                part["image_row"] = np.repeat(np.arange(n), caps)
                part["texts"] = _tokens(gen, n * caps, L, vocab, device)
            shards = caption_split(len(train["texts"]), Ks[i], split_rng)
            C = None
        out.append(DatasetArrays(name, mod, task, C, train, test, shards))
    return out


# ----------------------------------------------------------- the plan ----

def sample_round(seed: int, datasets: List[DatasetArrays], fraction: float,
                 round_idx: int) -> List[int]:
    """The equal-sampled clients of a round (global client ids, sorted):
    ``max(int(C * K_d), 1)`` of each dataset's clients, drawn from
    ``random.Random(seed * 1000003 + 2 * round)``."""
    rng = random.Random(int(seed) * 1_000_003 + int(round_idx) * 2)
    out, base = [], 0
    for d in datasets:
        ids = list(range(base, base + len(d.shards)))
        out += sorted(rng.sample(ids, max(int(fraction * len(ids)), 1)))
        base += len(d.shards)
    return sorted(out)


def client_index(datasets: List[DatasetArrays]):
    """Global client id -> (dataset position, shard position)."""
    return [(i, k) for i, d in enumerate(datasets)
            for k in range(len(d.shards))]


@dataclass
class RoundWork:
    """What one round asks of the card, from the plan alone."""
    sampled: List[int]
    rows: int                                  # valid training rows
    steps: int                                 # stacked group steps
    # per dataset: each stacked step's valid rows, summed over its clients
    step_rows: Dict[str, List[int]]
    clients: Dict[str, int]                    # sampled clients a dataset


def round_work(datasets: List[DatasetArrays], sampled: List[int],
               epochs: int, batch: int) -> RoundWork:
    where = client_index(datasets)
    rows, steps, step_rows, clients = 0, 0, {}, {}
    for i, d in enumerate(datasets):
        mine = [where[c][1] for c in sampled if where[c][0] == i]
        if not mine:
            continue
        streams = []
        for k in mine:
            n = len(d.shards[k])
            full, tail = divmod(n, batch)
            epoch = [batch] * full + ([tail] if tail else [])
            streams.append(epoch * epochs)
            rows += n * epochs
        longest = max(len(s) for s in streams)
        step_rows[d.name] = [sum(s[j] for s in streams if j < len(s))
                             for j in range(longest)]
        clients[d.name] = len(mine)
        steps += longest
    return RoundWork(sampled, rows, steps, step_rows, clients)


# -------------------------------------------------------------- weights --

def make_weights(layouts: Dict[str, list], seed: int, device, arch,
                 std: float = 0.02) -> Dict[str, dict]:
    """Each model's initial weights (float32, on ``device``) from one draw
    of ``torch.Generator(device)`` seeded by ``seed``, taken leaf by leaf in
    layout order by the kinds that draw: N(0, std) for ``normal``, 1 +
    N(0, std) for ``one`` (a LayerNorm scale), and the architecture's own
    (``arch.DRAWN``); zero for ``zero``; and a ``copy`` leaf the tensor
    the architecture's ``copy_of`` names, once the drawn leaves are in."""
    drawn = {"normal": None, "one": None, **getattr(arch, "DRAWN", {})}
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    draws = [(ds, path, shape) for ds, lay in layouts.items()
             for path, shape, kind in lay if kind in drawn]
    total = sum(math.prod(shape) for _, _, shape in draws)
    flat = torch.randn(total, generator=gen, device=device) * std
    out: Dict[str, dict] = {ds: {} for ds in layouts}
    at = 0
    for ds, lay in layouts.items():
        for path, shape, kind in lay:
            if kind in drawn:
                n = math.prod(shape)
                t = flat[at:at + n].reshape(shape).clone()
                at += n
                if kind == "one":
                    t += 1.0
                elif drawn[kind] is not None:
                    t = drawn[kind](t)
            elif kind == "zero":
                t = torch.zeros(shape, device=device)
            elif kind == "copy":
                continue
            else:
                raise ValueError(f"{'/'.join(path)}: unknown init kind "
                                 f"{kind!r}")
            put(out[ds], path, t)
        for path, shape, kind in lay:
            if kind == "copy":
                put(out[ds], path, arch.copy_of(out[ds], path).clone())
    return out
