"""The port's dataset fixtures and native WordPiece encoder against the JAX
package's, on the CPU.

* Every writer of ``fedcola_tpu_torch/data/fixtures.py`` writes the same
  bytes as its JAX twin (json, csv, pickle, npz, ``vocab.txt``, jpegs), and
  the port's fetchers parse each fixture.
* ``coco_fixture`` rebuilt on a root with other sizes rewrites the id
  lists, so ``fetch_coco`` reads the new splits.  This is a deliberate
  difference: the JAX copy keeps the id files of the first build.
* ``WordPieceTokenizer.encode_batch`` on the native encoder gives exactly
  the Python encoder's ids and the JAX tokenizer's, and sends what the
  native encoder does not implement to the Python one.
"""

import os

import numpy as np
import pytest

from fedcola_tpu.data import fixtures as jfix
from fedcola_tpu.data.tokenizer import WordPieceTokenizer as JTok
from fedcola_tpu_torch.data import datasets as tds
from fedcola_tpu_torch.data import fixtures as tfix
from fedcola_tpu_torch.data.tokenizer import WordPieceTokenizer as TTok
from fedcola_tpu_torch.native import tokenizer_fast

WRITERS = [
    ("coco", dict(n_train_img=6, n_test_img=3, size=32)),
    ("coco", dict(n_train_img=4, n_test_img=2, size=24, eval_overlap=False)),
    ("flickr", dict(n_train_img=6, n_test_img=3, size=32)),
    ("flickr", dict(n_train_img=4, n_test_img=2, size=24,
                    eval_overlap=False)),
    ("cifar100", dict(n_train=300, n_test=100)),
    ("agnews", dict(n_train=200, n_test=40)),
    ("medmnist", dict(n_train=120, n_test=30)),
]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("kind,kw", WRITERS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(WRITERS)])
def test_fixture_bytes_match_jax(tmp_path, kind, kw):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jfix, f"{kind}_fixture")(jroot, **kw)
    assert getattr(tfix, f"{kind}_fixture")(troot, **kw) == troot
    jf, tf = _files(jroot), _files(troot)
    assert sorted(jf) == sorted(tf)
    assert len(jf) >= 2
    for name in jf:
        assert jf[name] == tf[name], name


def test_port_fetchers_parse_every_fixture(tmp_path):
    coco = tfix.coco_fixture(str(tmp_path / "coco"), 6, 3, 32)
    flickr = tfix.flickr_fixture(str(tmp_path / "flickr"), 6, 3, 32)
    cifar = tfix.cifar100_fixture(str(tmp_path / "cifar"), 300, 100)
    agnews = tfix.agnews_fixture(str(tmp_path / "ag"), 200, 40)
    med = tfix.medmnist_fixture(str(tmp_path / "med"), 120, 30)
    for name, root, n_train, n_test in (("Coco", coco, 30, 15),
                                        ("Flickr30k", flickr, 30, 15)):
        tok = TTok.from_vocab_file(os.path.join(root, "vocab.txt"))
        for train, n in ((True, n_train), (False, n_test)):
            d = tds.fetch_dataset(name, root, train, tok, seq_len=12,
                                  image_size=32)
            assert d.n == n and d.texts.shape == (n, 12)
            # every caption code is a whole vocab token
            assert not (d.texts == tok.unk_id).any()
            assert d.materialize_images()
            assert d._image_store.shape == (n // 5, 32, 32, 3)
            imgs = d.load_images(np.arange(d.n))
            assert imgs.shape == (n, 32, 32, 3) and imgs.dtype == np.uint8
    c = tds.fetch_dataset("CIFAR100", cifar, True)
    assert c.n == 300 and c.images.shape == (300, 32, 32, 3)
    assert sorted(np.unique(c.targets)) == list(range(100))
    tok = TTok.from_vocab_file(os.path.join(agnews, "vocab.txt"))
    a = tds.fetch_dataset("AG_NEWS", agnews, False, tok, seq_len=24,
                          use_bert_tokenizer=True)
    assert a.n == 40 and set(np.unique(a.targets)) == {0, 1, 2, 3}
    assert not (a.texts == tok.unk_id).any()
    m = tds.fetch_dataset("MedMNIST", med, True, modality_flag="img")
    assert m.n == 120 and m.images.shape == (120, 28, 28, 1)


@pytest.mark.parametrize("first,second", [((4, 2), (8, 3)), ((8, 3), (4, 2))])
def test_coco_rebuild_rewrites_id_lists(tmp_path, first, second):
    """A root rebuilt with other sizes: ``fetch_coco`` sees the new split
    sizes (the JAX copy would read the first build's id lists: a shorter
    train split after smaller -> larger, a KeyError after larger ->
    smaller)."""
    root = str(tmp_path / "coco")
    tfix.coco_fixture(root, *first, 32)
    tfix.coco_fixture(root, *second, 32)
    tok = TTok.from_vocab_file(os.path.join(root, "vocab.txt"))
    tr = tds.fetch_coco(root, True, tok, seq_len=12, image_size=32)
    te = tds.fetch_coco(root, False, tok, seq_len=12, image_size=32)
    assert (tr.n, te.n) == (5 * second[0], 5 * second[1])
    assert len(np.unique(tr.image_ids)) == second[0]
    # the stamped fast path keeps the files it finds
    ids = np.load(os.path.join(root, "coco_train_ids.npy"))
    tfix.coco_fixture(root, *second, 32)
    np.testing.assert_array_equal(
        np.load(os.path.join(root, "coco_train_ids.npy")), ids)


# ------------------------------------------------------------- tokenizer --

SAMPLES = [
    "A man riding a horse on the beach.",
    "Two dogs play, with a RED ball!",
    "patients with acute myocardial infarction (n=120) were studied.",
    "the quick brown fox jumps over the lazy dog",
    "café au lait — naïve résumé",
]


def _vocab_cases(tmp_path):
    gaps = tmp_path / "gaps.txt"
    gaps.write_text(
        "[PAD]\n[UNK]\n[CLS]\n[SEP]\n\nhello\n\nworld\n##d\nhel\n##lo\n")
    coco = tfix.coco_fixture(str(tmp_path / "coco"), 6, 3, 32)
    ag = tfix.agnews_fixture(str(tmp_path / "ag"), 40, 8)
    gap_texts = ["hello world", "hel\x7flo world", "hello worl\x7fd"]
    coco_texts = [f"a photo number {i} caption {c} of several things"
                  for i in range(6) for c in range(5)]
    with open(os.path.join(ag, "test.csv"), encoding="utf-8") as f:
        ag_texts = [line.strip() for line in f]
    return [(None, SAMPLES + gap_texts), (str(gaps), gap_texts + SAMPLES),
            (os.path.join(coco, "vocab.txt"), coco_texts + SAMPLES),
            (os.path.join(ag, "vocab.txt"), ag_texts)]


def test_native_encode_batch_matches_python_and_jax(tmp_path):
    assert tokenizer_fast.load() is not None, "g++ builds the encoder here"
    for vocab, texts in _vocab_cases(tmp_path):
        if vocab is None:
            tok, jtok = TTok.synthetic(500), JTok.synthetic(500)
        else:
            tok, jtok = TTok.from_vocab_file(vocab), JTok.from_vocab_file(vocab)
        for max_length in (8, 32):
            before = tokenizer_fast.NATIVE_ROWS
            got = tok.encode_batch(texts, max_length)
            n_ascii = sum(t.isascii() for t in texts)
            assert tokenizer_fast.NATIVE_ROWS - before == n_ascii
            py = np.stack([tok.encode(t, max_length) for t in texts])
            jx = np.stack([jtok.encode(t, max_length) for t in texts])
            np.testing.assert_array_equal(got, py)
            np.testing.assert_array_equal(got, jx)
            assert got.dtype == np.int32
    gaps = TTok.from_vocab_file(str(tmp_path / "gaps.txt"))
    ids = gaps.encode_batch(["hello world"], 8)
    assert ids[0, 1] == 5 and ids[0, 2] == 7     # line-number ids


def test_native_routes_what_it_does_not_implement_to_python():
    """Non-ASCII strings of a batch, a cased tokenizer and ``max_length <
    2`` take the Python encoder; the ids are the Python encoder's."""
    tok = TTok.synthetic(500)
    before = tokenizer_fast.NATIVE_ROWS
    got = tok.encode_batch(["naïve café", "plain text"], 16)
    assert tokenizer_fast.NATIVE_ROWS - before == 1
    np.testing.assert_array_equal(
        got, np.stack([tok.encode(t, 16) for t in ["naïve café",
                                                   "plain text"]]))
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
             "Hello": 4, "hello": 5, "world": 6}
    cased = TTok(vocab, do_lower_case=False)
    before = tokenizer_fast.NATIVE_ROWS
    out = cased.encode_batch(["Hello world", "hello world"], 8)
    assert tokenizer_fast.NATIVE_ROWS == before
    assert out[0][1] == 4 and out[1][1] == 5
    assert not tokenizer_fast.supports(tok, 1)


def test_native_library_lands_in_build_dir():
    from fedcola_tpu_torch import native
    path = native.build_library("wordpiece.cpp")
    assert path is not None and os.path.dirname(path) == str(native.BUILD_DIR)
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    # the same source on the same host builds once
    assert native.build_library("wordpiece.cpp") == path
