"""Logging bootstrap (reference ``set_logger``, src/__init__.py:13-42):
stream + file handlers with the same record format."""

from __future__ import annotations

import logging
import math
import numbers
import os
import sys


def json_sanitize(obj):
    """Recursively replace non-finite numbers with ``None``:
    ``json.dumps`` would otherwise emit bare ``Infinity``/``NaN`` tokens,
    which are not RFC 8259 JSON and break strict parsers (jq, most
    non-Python readers).  A client whose loss transiently overflows (bf16)
    is warned about and continues (server._train_group); its metrics
    record must stay machine-readable."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, numbers.Real) and not isinstance(obj, (bool, int)):
        return obj if math.isfinite(float(obj)) else None
    return obj


def set_logger(path: str | None = None, level=logging.INFO,
               tag: str = "") -> logging.Logger:
    """``tag`` prefixes every record (a mesh rank's ``[rank r] ``)."""
    fmt = logging.Formatter(
        f"%(asctime)s [%(levelname)s] {tag}%(message)s", "%m/%d %H:%M:%S")
    root = logging.getLogger("fedcola_tpu_torch")
    root.setLevel(level)
    # repeated calls (tests, resume re-init) must not leak the previous
    # FileHandler's fd; and records must not also propagate to the root
    # logger (a library's basicConfig would double-print every line)
    for h in root.handlers:
        h.close()
    root.handlers.clear()
    root.propagate = False
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root
