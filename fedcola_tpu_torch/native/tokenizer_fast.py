"""ctypes binding of the native batch WordPiece encoder (port of
``fedcola_tpu/native/tokenizer_fast.py``).

It implements the default tokenizer semantics (lower-casing, a 100-char
word cap) on ASCII text; ``WordPieceTokenizer.encode_batch`` sends it only
such batches, and it encodes the non-ASCII strings of a batch with the
Python encoder so Unicode (NFD accent stripping, CJK spacing) stays exact.
``NATIVE_ROWS`` counts the strings the native encoder served.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Optional

import numpy as np

from fedcola_tpu_torch.native import build_library

# strings encoded by the C++ encoder in this process
NATIVE_ROWS = 0

_lib = None
_load_failed = False
_handles = {}


def load() -> Optional[ctypes.CDLL]:
    """The encoder's library, built on first use; None without a
    toolchain (the build warns once)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = build_library("wordpiece.cpp")
    if path is None:
        _load_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.wp_build.restype = ctypes.c_void_p
    lib.wp_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.restype = None
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    _lib = lib
    return lib


def supports(tok, max_length: int) -> bool:
    """Whether the native encoder gives ``tok``'s ids: default semantics
    and room for [CLS] and [SEP]."""
    return (tok.do_lower_case and tok.max_chars_per_word == 100
            and max_length >= 2)


def _vocab_handle(lib, tok) -> int:
    """Native vocab handle, cached by the content of the id -> token map
    (tokenizers with one vocab share a handle; handles live for the
    process, one per distinct vocab)."""
    key = getattr(tok, "_native_vocab_key", None)
    if key is not None and key in _handles:
        return _handles[key]
    items = sorted(tok.vocab.items(), key=lambda kv: kv[1])
    # line i of the blob is the token with id i, or empty for an id the
    # vocab file left blank (wp_build counts empty lines as ids)
    lines = [""] * ((items[-1][1] + 1) if items else 0)
    for token, idx in items:
        lines[idx] = token
    blob = "\n".join(lines).encode("utf-8")
    key = hashlib.sha256(blob).hexdigest()
    if key not in _handles:
        _handles[key] = ctypes.c_void_p(lib.wp_build(blob, len(blob)))
    tok._native_vocab_key = key
    return _handles[key]


def encode_batch(lib, tok, texts: List[str], max_length: int) -> np.ndarray:
    """``[n, max_length]`` int32 ids of ``texts`` under ``tok`` (which
    :func:`supports`); ASCII strings on the native encoder, the rest on
    ``tok.encode``."""
    global NATIVE_ROWS
    handle = _vocab_handle(lib, tok)
    out = np.empty((len(texts), max_length), np.int32)
    ascii_idx = [i for i, t in enumerate(texts) if t.isascii()]
    if ascii_idx:
        raw = [texts[i].encode("ascii") for i in ascii_idx]
        blob = b"".join(raw)
        offsets = np.zeros(len(raw) + 1, np.int64)
        np.cumsum([len(r) for r in raw], out=offsets[1:])
        sub = np.empty((len(raw), max_length), np.int32)
        lib.wp_encode_batch(handle, blob, offsets, len(raw), max_length,
                            tok.cls_id, tok.sep_id, tok.pad_id, tok.unk_id,
                            sub, min(os.cpu_count() or 1, 16))
        out[np.asarray(ascii_idx)] = sub
        NATIVE_ROWS += len(raw)
    ascii_set = set(ascii_idx)
    for i, t in enumerate(texts):
        if i not in ascii_set:
            out[i] = tok.encode(t, max_length)
    return out
