"""WordPiece tokenizer, HF-BertTokenizer-compatible, zero-download.

The reference tokenizes with ``transformers.BertTokenizer`` either built
from a per-dataset ``vocab.txt`` (Flickr30k: 7732 tokens, MedicalAbstracts:
20264; data.py:182-188) or from the hub's ``bert-base-uncased``.  Every
call site uses ``padding='max_length', truncation=True, max_length=seq_len``
(coco.py:152, flickr30k.py:40, data.py:299-303).

This is a self-contained reimplementation of the uncased Bert tokenization
pipeline (basic tokenizer: clean -> CJK spacing -> lowercase+strip accents
-> punctuation split; then greedy longest-match-first WordPiece) so runs
never need network access.  When the ``transformers`` wheel has a cached
``bert-base-uncased`` it can be used instead; otherwise pass a vocab file.

``encode_batch`` runs the C++ batch encoder (``fedcola_tpu_torch/native``)
where it gives the same ids: default semantics, ASCII strings.  This module
is the reference implementation and the encoder for everything else.
"""

from __future__ import annotations

import logging
import unicodedata
from typing import Dict, Iterable, List, Optional

import numpy as np

from fedcola_tpu_torch.native import tokenizer_fast

logger = logging.getLogger(__name__)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """Uncased BERT tokenization: basic + WordPiece."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = vocab.get("[CLS]", 0)
        self.sep_id = vocab.get("[SEP]", 0)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get(unk_token, 0)

    # -- constructors
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def synthetic(cls, vocab_size: int = 30522) -> "WordPieceTokenizer":
        """Deterministic stand-in vocab for tests/benchmarks (no files)."""
        vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
        for i in range(5, vocab_size):
            vocab[f"tok{i}"] = i
        return cls(vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization
    def _basic_tokenize(self, text: str) -> List[str]:
        out = []
        buf = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                buf.append(" ")
                buf.append(ch)
                buf.append(" ")
            elif _is_whitespace(ch):
                buf.append(" ")
            else:
                buf.append(ch)
        for word in "".join(buf).split():
            if self.do_lower_case:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for w in self._basic_tokenize(text):
            out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str, max_length: int = 40) -> np.ndarray:
        """padding='max_length', truncation=True semantics: [CLS] toks [SEP]
        truncated to max_length (keeping the trailing [SEP]), padded with
        [PAD]."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        ids = ids + [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def encode_batch(self, texts: Iterable[str], max_length: int = 40) -> np.ndarray:
        texts = list(texts)
        if tokenizer_fast.supports(self, max_length):
            lib = tokenizer_fast.load()
            if lib is not None:
                return tokenizer_fast.encode_batch(lib, self, texts,
                                                   max_length)
        return np.stack([self.encode(t, max_length) for t in texts])


def get_tokenizer(data_path: Optional[str] = None,
                  dataset: Optional[str] = None,
                  vocab_file: Optional[str] = None,
                  vocab_size: int = 30522) -> WordPieceTokenizer:
    """Tokenizer selection mirroring data.py:173-188: per-dataset vocab.txt
    when the dataset ships one, else bert-base-uncased (from a local cache or
    a synthetic stand-in when offline)."""
    import os
    VOCABS = {"Flickr30k": "vocab.txt", "MedicalAbstracts": "vocab.txt"}
    # the model's word-embedding table is sized by VOCAB_SIZES (registry
    # builds vocab_size=VOCAB_SIZES[dataset]); any tokenizer with a
    # bigger vocab would emit out-of-range ids that XLA's clamped
    # gathers turn into silently corrupted embeddings
    from fedcola_tpu_torch.config import VOCAB_SIZES
    table_size = VOCAB_SIZES.get(dataset, vocab_size)

    def _check(tok, path):
        if tok.vocab_size > table_size:
            raise ValueError(
                f"{path} has {tok.vocab_size} tokens but the model's "
                f"word-embedding table for {dataset!r} has only "
                f"{table_size} rows — ids past the table would gather "
                f"the last row silently; pass --vocab_size "
                f"{tok.vocab_size} (or trim the vocab file)")
        return tok

    if vocab_file is not None:
        return _check(WordPieceTokenizer.from_vocab_file(vocab_file),
                      vocab_file)
    if dataset in VOCABS and data_path is not None:
        path = os.path.join(data_path, VOCABS[dataset])
        if os.path.exists(path):
            return _check(WordPieceTokenizer.from_vocab_file(path), path)
    # any dataset root that ships a vocab.txt wins over the fallbacks:
    # the reference uses bert-base-uncased for Coco (a download this
    # environment can't make), and whether a cached copy exists is
    # machine state — a run's learnability must not silently depend on
    # it when the data directory provides a vocabulary (real COCO trees
    # don't ship one, so the reference path is unchanged there)
    if data_path is not None:
        path = os.path.join(data_path, "vocab.txt")
        if os.path.exists(path):
            logger.info("[TOKENIZER] %s: using %s", dataset, path)
            return _check(WordPieceTokenizer.from_vocab_file(path), path)
    # try a locally cached bert-base-uncased vocab
    for cand in (
        os.path.expanduser("~/.cache/huggingface"),
    ):
        if os.path.isdir(cand):
            for root, _, files in os.walk(cand):
                if "vocab.txt" in files:
                    tok = WordPieceTokenizer.from_vocab_file(
                        os.path.join(root, "vocab.txt"))
                    if tok.vocab_size <= table_size:
                        return tok
                    logger.warning(
                        "[TOKENIZER] %s: dataset vocab.txt missing and the "
                        "cached bert vocab (%d tokens) exceeds the model's "
                        "%d-row embedding table — using a synthetic "
                        "stand-in instead (ids stay in range; text is NOT "
                        "meaningfully tokenized)", dataset,
                        tok.vocab_size, table_size)
                    return WordPieceTokenizer.synthetic(table_size)
    return WordPieceTokenizer.synthetic(table_size)
