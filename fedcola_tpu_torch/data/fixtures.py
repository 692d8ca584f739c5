"""Path-backed dataset fixtures for benches, tests, and evidence runs.

These write REAL on-disk datasets in the reference's layouts (COCO
captions json + jpegs, reference ``coco.py``; Flickr30k pipe-CSV + jpegs,
reference ``flickr30k.py:9-45``) so end-to-end runs exercise the actual
data path: file parse -> jpeg decode/materialize -> deduped-store HBM
staging -> on-device row gathers.  Captions encode their image's index
("a photo number {i} ...") so image<->caption retrieval has a learnable
target and recall@k measures real convergence, not chance.

``eval_overlap=True`` (the default) makes the test split reference the
SAME jpegs and caption codes as the first ``n_test_img`` train images:
retrieval eval then measures whether training actually aligned those
image<->caption pairs — an infrastructure-convergence target (recall
climbs from chance toward 1.0 as the towers align), NOT a generalization
measure; random noise images admit no generalizable signal.  With
``eval_overlap=False`` the test split gets fresh noise images and unseen
caption codes (timing-only: recall stays at chance).

Fixtures are content-stamped and cached across runs.  Port of
``fedcola_tpu/data/fixtures.py``: the same writers, the same RNG draws and
so the same bytes, with one difference in ``coco_fixture``: a rebuild of a
root rewrites ``coco_{train,test}_ids.npy`` (the JAX copy keeps id files
left by an earlier parameterization, so ``fetch_coco`` then reads a split
of the old size).
"""

from __future__ import annotations

import csv as _csv
import json
import os
import pickle

import numpy as np

def _vocab(n_codes: int):
    """Every caption code must be a whole vocab token: WordPiece turns
    any number it cannot fully piece together into [UNK], which would
    collapse distinct captions into one and silently destroy the
    learnable image<->caption target."""
    return (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "photo", "number",
             "caption", "of", "several", "things"]
            + [str(i) for i in range(max(n_codes, 50))])


def _write_images(rng, img_dir, names, size):
    from PIL import Image
    os.makedirs(img_dir, exist_ok=True)
    for fn in names:
        Image.fromarray(rng.randint(0, 256, (size, size, 3))
                        .astype(np.uint8)).save(os.path.join(img_dir, fn),
                                                quality=85)


def _caption(i: int, c: int) -> str:
    return f"a photo number {i} caption {c} of several things"


def coco_fixture(root: str, n_train_img: int, n_test_img: int,
                 size: int, eval_overlap: bool = True) -> str:
    """COCO-format fixture: ``annotations/captions_{train,val}2014.json``
    + ``all_images/`` jpegs + ``vocab.txt`` + ``coco_{train,test}_ids.npy``
    (the layout ``fetch_coco`` parses; reference coco.py via pycocotools).

    The id lists contain exactly the sorted annotation ids of each split
    (train aids are ``arange(5*n_train_img)``, test aids are offset by
    1e7), so ``fetch_coco`` selects the same rows with or without them —
    they exist so the CreamFL public-set loader (``fetch_coco_public``,
    reference creamflserver.py:107 ``coco_train_ids.npy[-num_pub_samples:]``)
    resolves REAL fixture captions instead of falling back to synthetic."""
    assert not eval_overlap or n_test_img <= n_train_img, (
        "eval_overlap reuses train_{i}.jpg for the test split, so it "
        f"needs n_test_img ({n_test_img}) <= n_train_img ({n_train_img})")

    def write_id_files(rebuild: bool):
        # the stamped fast path only fills in missing files (fixtures
        # stamped before these existed); a rebuild rewrites both, since
        # files of another parameterization would change the splits
        for name, ids in (
                ("coco_train_ids.npy", np.arange(5 * n_train_img,
                                                 dtype=np.int64)),
                ("coco_test_ids.npy", 10 ** 7 + np.arange(5 * n_test_img,
                                                          dtype=np.int64))):
            path = os.path.join(root, name)
            if rebuild or not os.path.exists(path):
                np.save(path, ids)

    stamp = os.path.join(
        root, f"ready_{n_train_img}_{n_test_img}_{size}_{int(eval_overlap)}")
    if os.path.exists(stamp):
        write_id_files(rebuild=False)
        return root
    # the generated files (annotations/csvs/vocab.txt) are shared per
    # root: a rebuild with different parameters overwrites them, so any
    # OTHER parameterization's stamp would now validate stale data —
    # drop all stamps before rebuilding
    import glob as _glob
    for old_stamp in _glob.glob(os.path.join(root, "ready_*")):
        os.remove(old_stamp)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    rng = np.random.RandomState(0)

    def make(split, n_img):
        overlap = split == "test" and eval_overlap
        names = [(f"train_{i}.jpg" if overlap else f"{split}_{i}.jpg")
                 for i in range(n_img)]
        if not overlap:
            _write_images(rng, os.path.join(root, "all_images"), names,
                          size)
        images, anns = [], []
        aid = 0 if split == "train" else 10 ** 7
        base = 0 if split == "train" else 10 ** 6
        code = 0 if (split == "train" or overlap) else n_train_img
        for i, fn in enumerate(names):
            images.append({"id": base + i, "file_name": fn})
            for c in range(5):
                anns.append({"id": aid, "image_id": base + i,
                             "caption": _caption(code + i, c)})
                aid += 1
        name = ("captions_train2014.json" if split == "train"
                else "captions_val2014.json")
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)

    make("train", n_train_img)
    make("test", n_test_img)
    n_codes = n_train_img + (0 if eval_overlap else n_test_img)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(_vocab(n_codes)))
    write_id_files(rebuild=True)
    open(stamp, "w").close()
    return root


def cifar100_fixture(root: str, n_train: int = 50000, n_test: int = 10000,
                     n_classes: int = 100, signal: float = 0.7) -> str:
    """CIFAR100-format fixture with a LEARNABLE class signal: writes
    ``cifar-100-python/{train,test}`` pickles (the exact layout
    ``fetch_cifar100`` parses — reference torchvisionparser.py CIFAR100
    path) where every image is ``signal * T_c + (1-signal) * noise`` for a
    fixed per-class 32x32 template ``T_c``.  A nearest-class-mean
    classifier recovers the label, so central-eval acc1 measures whether
    the img-cls train/resident-gather/eval path actually learns — the
    random-label synthetic stand-in is at chance by construction and
    cannot catch a silent bug there.

    Same caveat as the retrieval fixtures: templates are random noise, so
    this is an infrastructure-convergence target (train and test draw
    from the same per-class templates), not a generalization benchmark."""
    stamp = os.path.join(
        root, f"ready_{n_train}_{n_test}_{n_classes}_{signal:g}")
    if os.path.exists(stamp):
        return root
    import glob as _glob
    for old_stamp in _glob.glob(os.path.join(root, "ready_*")):
        os.remove(old_stamp)
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    templates = np.stack([
        np.random.RandomState(7000 + c).randint(0, 256, (32, 32, 3))
        for c in range(n_classes)]).astype(np.float32)

    def make(split, n, seed):
        rng = np.random.RandomState(seed)
        labels = rng.permutation(np.arange(n) % n_classes).astype(np.int64)
        rows = np.empty((n, 3072), np.uint8)
        for a in range(0, n, 4096):            # bound the float temporaries
            b = min(a + 4096, n)
            noise = rng.randint(0, 256, (b - a, 32, 32, 3)).astype(np.float32)
            img = np.clip(signal * templates[labels[a:b]]
                          + (1.0 - signal) * noise, 0, 255).astype(np.uint8)
            # cifar row layout: R plane, G plane, B plane (3x32x32 C-order)
            rows[a:b] = img.transpose(0, 3, 1, 2).reshape(b - a, -1)
        with open(os.path.join(d, split), "wb") as f:
            pickle.dump({b"data": rows, b"fine_labels": labels.tolist()}, f)

    make("train", n_train, 11)
    make("test", n_test, 12)
    open(stamp, "w").close()
    return root


# shared non-signal filler vocabulary for the AG_NEWS fixture
_AGNEWS_FILLER = ("the and of to in on for with news report today world "
                  "said new from over about market group first last").split()


def agnews_fixture(root: str, n_train: int = 24000, n_test: int = 4000,
                   n_classes: int = 4, n_words: int = 18,
                   p_signal: float = 0.6) -> str:
    """AG_NEWS-format fixture with a LEARNABLE class signal: writes the
    fast-ai csv layout (``{train,test}.csv``, label column 1-based, title +
    description columns — the layout ``fetch_torchtext_generic`` parses,
    reference torchtextparser.py:17-201) plus a ``vocab.txt`` so the
    ``--use_bert_tokenizer`` path tokenizes every word whole.  Each class
    draws ``p_signal`` of its words from its own 8-word signature set and
    the rest from a shared filler pool — bag-of-words separable, so
    central-eval acc1 on the txt-cls leg measures learning, not chance."""
    stamp = os.path.join(
        root, f"ready_{n_train}_{n_test}_{n_classes}_{n_words}_{p_signal:g}")
    if os.path.exists(stamp):
        return root
    import glob as _glob
    for old in _glob.glob(os.path.join(root, "ready_*")):
        os.remove(old)
    # stale torchtext encodings from a previous parameterization would
    # silently win over the rewritten csvs
    for old in _glob.glob(os.path.join(root, "tr_*.npz")) + \
            _glob.glob(os.path.join(root, "te_*.npz")):
        os.remove(old)
    os.makedirs(root, exist_ok=True)
    sig = [[f"sig{c}{k}" for k in range(8)] for c in range(n_classes)]

    def make(split, n, seed):
        rng = np.random.RandomState(seed)
        rows = []
        for i in range(n):
            c = i % n_classes
            words = [sig[c][rng.randint(8)] if rng.rand() < p_signal
                     else _AGNEWS_FILLER[rng.randint(len(_AGNEWS_FILLER))]
                     for _ in range(n_words)]
            rows.append((c + 1, " ".join(words[:5]), " ".join(words[5:])))
        rng.shuffle(rows)
        with open(os.path.join(root, f"{split}.csv"), "w", newline="",
                  encoding="utf-8") as f:
            _csv.writer(f, quoting=_csv.QUOTE_ALL).writerows(rows)

    make("train", n_train, 21)
    make("test", n_test, 22)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
                          + [w for cls in sig for w in cls]
                          + _AGNEWS_FILLER))
    open(stamp, "w").close()
    return root


def medmnist_fixture(root: str, n_train: int = 2200, n_test: int = 550,
                     n_classes: int = 11, flag: str = "organcmnist") -> str:
    """MedMNIST-format fixture with a LEARNABLE class signal: writes
    ``<flag>.npz`` with ``{train,test}_images`` (N,28,28 uint8) and
    ``{train,test}_labels`` (N,1) — the exact layout ``fetch_medmnist``
    parses (reference medmnist.py:11-70; organcmnist is what the ct/img
    modality flags map to).  Each class brightens its own 6x6 patch of a
    dim-noise image (patch position = class index on a 4-wide grid), so
    a patch-mean classifier recovers the label and central acc1 on the
    MedMNIST leg measures learning, not 1/n_classes chance."""
    assert n_classes <= 12, "patch grid holds 3 rows x 4 cols of 6x6 cells"
    stamp = os.path.join(root, f"ready_med_{n_train}_{n_test}_{n_classes}")
    if os.path.exists(stamp):
        return root
    import glob as _glob
    for old in _glob.glob(os.path.join(root, "ready_med_*")):
        os.remove(old)
    os.makedirs(root, exist_ok=True)

    def make(n, seed):
        rng = np.random.RandomState(seed)
        ys = rng.randint(0, n_classes, n)
        imgs = (rng.rand(n, 28, 28) * 60).astype(np.uint8)
        for i, y in enumerate(ys):
            r, c = divmod(int(y), 4)
            imgs[i, 2 + 6 * r:8 + 6 * r, 2 + 6 * c:8 + 6 * c] += 160
        return imgs, ys.astype(np.int64).reshape(-1, 1)

    tr_x, tr_y = make(n_train, 7)
    te_x, te_y = make(n_test, 8)
    np.savez(os.path.join(root, f"{flag}.npz"),
             train_images=tr_x, train_labels=tr_y,
             test_images=te_x, test_labels=te_y)
    open(stamp, "w").close()
    return root


def flickr_fixture(root: str, n_train_img: int, n_test_img: int,
                   size: int, eval_overlap: bool = True) -> str:
    """Flickr30k-format fixture: ``{train,test}.csv`` pipe-CSVs
    (``image_name|comment_number|comment``, 5 captions/image; test reuses
    train_{i}.jpg when ``eval_overlap``) +
    ``flickr30k_images/`` jpegs + ``vocab.txt`` (the layout
    ``fetch_flickr30k`` parses; reference flickr30k.py:9-45)."""
    assert not eval_overlap or n_test_img <= n_train_img, (
        "eval_overlap reuses train_{i}.jpg for the test split, so it "
        f"needs n_test_img ({n_test_img}) <= n_train_img ({n_train_img})")
    stamp = os.path.join(
        root, f"ready_{n_train_img}_{n_test_img}_{size}_{int(eval_overlap)}")
    if os.path.exists(stamp):
        return root
    # the generated files (annotations/csvs/vocab.txt) are shared per
    # root: a rebuild with different parameters overwrites them, so any
    # OTHER parameterization's stamp would now validate stale data —
    # drop all stamps before rebuilding
    import glob as _glob
    for old_stamp in _glob.glob(os.path.join(root, "ready_*")):
        os.remove(old_stamp)
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)

    def make(split, n_img, base, overlap=False):
        names = [(f"train_{i}.jpg" if overlap else f"{split}_{i}.jpg")
                 for i in range(n_img)]
        if not overlap:
            _write_images(rng, os.path.join(root, "flickr30k_images"),
                          names, size)
        with open(os.path.join(root, f"{split}.csv"), "w",
                  encoding="utf-8") as f:
            f.write("image_name| comment_number| comment\n")
            for i, fn in enumerate(names):
                for c in range(5):
                    f.write(f"{fn}| {c}| {_caption(base + i, c)}\n")

    make("train", n_train_img, 0)
    # train_all.csv = train.csv for the fixture (the reference's
    # --train_all concatenates extra unlabeled data)
    import shutil
    shutil.copyfile(os.path.join(root, "train.csv"),
                    os.path.join(root, "train_all.csv"))
    make("test", n_test_img, 0 if eval_overlap else n_train_img,
         overlap=eval_overlap)
    n_codes = n_train_img + (0 if eval_overlap else n_test_img)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(_vocab(n_codes)))
    open(stamp, "w").close()
    return root
