"""Native (C++) host code of the port, loaded with ``ctypes``: the batch
WordPiece encoder (``wordpiece.cpp``) that tokenizes a dataset at load
time.  Port of ``fedcola_tpu/native``.

Sources compile on first use with ``g++`` into ``build/native/`` at the
repo root, under a name that holds the source's digest and a tag of the
host's ISA and compiler, so a library is never loaded on a machine it was
not built for.  Without a toolchain the callers keep the Python encoder.
"""

from __future__ import annotations

import hashlib
import logging
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _host_tag() -> str:
    """Host/ISA fingerprint: sources build with ``-march=native``, so a
    library built on one CPU may not run on another."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.split(":", 1)[1].strip())
                    break
    except OSError:
        pass
    try:
        gxx = subprocess.run(["g++", "-dumpfullversion", "-dumpversion"],
                             capture_output=True, timeout=10, text=True)
        parts.append(gxx.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def build_library(src_name: str) -> Optional[str]:
    """Compile ``src_name`` to a shared library under ``BUILD_DIR`` unless
    it is there already; returns its path, or None (with a warning) when
    the compile fails or there is no ``g++``."""
    src = _DIR / src_name
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}.{digest}.{_host_tag()}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename into place: test workers build
    # concurrently, and a killed compile must not leave a truncated library
    # under the name that is trusted
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return str(out)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native build of %s failed (%s); using the Python "
                       "encoder", src_name, e)
        return None
