"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` (one process per source,
all started together) and link into ``build/kernels/libfedcola_kernels.so``
at the repo root, which is loaded with ``ctypes``.  The build happens on
first use and again whenever a source is newer than the library, under a
file lock (``build/kernels/build.lock``), so processes that start at once
(the ranks of a mesh) build it once and load the same file.  Each C
entry point launches a fixed sequence of the package's own kernels on the
stream it is given and returns the first CUDA error (0 when none);
:func:`launch` raises on anything else.

Every entry point but seven corresponds to one TPU kernel of the JAX
package; ``fc_opt_update`` (``csrc/opt_update.cu``, the group's optimizer
step) replaces the update the JAX package left to XLA's fusion, and
``fc_moe_gemm_fwd`` / ``fc_moe_gemm_bwd`` (``csrc/moe_gemm.cu``, the
routed experts' grouped GEMM) and ``fc_moe_{dispatch,combine}_{fwd,bwd}``
(``csrc/moe_rows.cu``, the MoE layer's row moves) have no counterpart
there.
``LAUNCHES`` counts, per entry point, the calls that went to the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from fedcola_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libfedcola_kernels.so"
SOURCES = ("attn_fwd.cu", "attn_bwd.cu", "mlp_fwd.cu", "mlp_bwd.cu",
           "flash_fwd.cu", "flash_bwd.cu", "opt_update.cu", "moe_gemm.cu",
           "moe_rows.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# launches per entry point, counted by the ops wrappers (CUDA branch only)
LAUNCHES: Dict[str, int] = {
    "attn_fwd": 0, "attn_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0,
    "attn_bwd_recompute": 0, "mlp_bwd_nores": 0,
    "flash_fwd": 0, "flash_bwd": 0,
    "mlp_fwd_rows": 0, "mlp_bwd_rows": 0,
    "mlp_ln_fwd_rows": 0, "mlp_ln_bwd_rows": 0, "opt_update": 0,
    "moe_gemm_fwd": 0, "moe_gemm_bwd": 0, "moe_dispatch_fwd": 0,
    "moe_dispatch_bwd": 0, "moe_combine_fwd": 0, "moe_combine_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fc_attn_fwd": [_I] * 6 + [_P] * 15 + [_I, _P],
    "fc_attn_bwd": [_I] * 8 + [_P] * 32,
    "fc_attn_bwd_recompute": [_I] * 8 + [_P] * 31,
    "fc_mlp_fwd": [_I] * 6 + [_P] * 14,
    "fc_mlp_bwd": [_I] * 7 + [_P] * 28,
    "fc_mlp_bwd_nores": [_I] * 7 + [_P] * 27,
    "fc_flash_fwd": [_I] * 4 + [_F] + [_P] * 5,
    "fc_flash_bwd": [_I] * 4 + [_F] + [_P] * 9,
    "fc_mlp_fwd_rows": [_I] * 5 + [_P] * 8,
    "fc_mlp_bwd_rows": [_I] * 6 + [_P] * 19,
    "fc_mlp_ln_fwd_rows": [_I] * 5 + [_P] * 13,
    "fc_mlp_ln_bwd_rows": [_I] * 6 + [_P] * 27,
    "fc_opt_update": [_I] * 4 + [_P] * 2 + [_I] + [_F] * 9 + [_I, _P],
    # test only: the Hopper GEMM mainloop alone (tests/test_torch_port_cuda.py)
    "fc_sm90_gemm_test": [_I] * 6 + [_P] * 4,
    # test only: the mainloop with the forwards' GELU / residual epilogues
    "fc_sm90_epilogue_test": [_I] * 6 + [_P] * 7,
    # test only: the tensor-core attention forward core, packed layout
    "fc_attn_fwd_core_test": [_I] * 4 + [_P] * 4,
    "fc_moe_gemm_fwd": [_I] * 5 + [_P] * 10,
    "fc_moe_gemm_bwd": [_I] * 4 + [_P] * 16,
    "fc_moe_dispatch_fwd": [_I] * 5 + [_P] * 5,
    "fc_moe_dispatch_bwd": [_I] * 4 + [_P] * 4,
    "fc_moe_combine_fwd": [_I] * 4 + [_P] * 5,
    "fc_moe_combine_bwd": [_I] * 5 + [_P] * 9,
}

# The bf16 fused route's Hopper GEMM (csrc/gemm_sm90.cuh): its row and K
# tiles, and the SMs the split weight-gradient products should fill.
SM90_BM, SM90_BK, H100_SMS = 128, 64, 132


def plan_row_splits(rows: int, out_rows: int, out_cols: int):
    """``(S, rows_per_split)`` for a weight-gradient product Aᵀ·B with an
    ``[out_rows, out_cols]`` result that reduces over a client's ``rows``
    (the MLP's dW1 = hᵀ·dpre and dW2, the attention sublayer's dWproj and
    dWqkv).  Its 128 x 128 output tiles alone leave most SMs idle, so each
    client's rows are cut into S ranges of ``rows_per_split`` rows (a
    multiple of the 64-row K tile; the last range holds the rest), enough
    that tiles x S reach two blocks per SM, at most 8 ranges and at least
    4 K tiles each.  A function of (rows, output shape) only, so the result
    never depends on the number of clients or on timing."""
    k_tiles = -(-rows // SM90_BK)
    tiles = -(-out_rows // SM90_BM) * -(-out_cols // SM90_BM)
    want = -(-2 * H100_SMS // tiles)
    per = -(-k_tiles // max(1, min(8, want, k_tiles // 4)))
    return -(-k_tiles // per), per * SM90_BK


# The per-head attention kernels (csrc/attn_core.cuh, attn_fwd_core.cuh,
# attn_bwd_core.cuh, attn_bwd.cu, flash_bwd.cu) keep a head's keys resident
# in shared memory up to N = RESIDENT_MAX_SEQ and stream them past it.  The
# streamed kernels' blocks and chunks, as the C side defines them: the
# bf16 tensor-core kernels (csrc/attn_wgmma.cuh) own 128 query (column
# pass: key) rows a block and stream chunks of 64 rows (AS_KC; the column
# pass 32, AS_QC) as 64-column TMA boxes (AS_BOX bytes at 64 rows) through
# a ring of AS_ST stages; the
# CUDA-core kernels own 64 query rows a block and load 32-key chunks
# (AT_QR, AT_KC), their column passes 32 keys (AB_KR, the fused route) or
# 64 (FB_KR, flash).
RESIDENT_MAX_SEQ = 256
AS_QB, AS_KC, AS_QC, AS_ST, AS_BOX = 128, 64, 32, 4, 64 * 64 * 2
AT_QR, AT_KC, AT_WARPS, AB_KR, AB_RC, FB_KR = 64, 32, 8, 32, 32, 64
SMEM_LIMIT = 232448     # dynamic shared memory a block may take on Hopper


def streams_keys(N: int) -> bool:
    """Whether the attention kernels take their streamed variants at
    sequence length N (``attn_streams_keys`` in ``csrc/attn_core.cuh``)."""
    return N > RESIDENT_MAX_SEQ


def attn_part_rows(N: int) -> int:
    """Rows of the Hopper attention backward's column-sum buffer an item
    takes: one, or one per 128-query block when the keys stream."""
    return -(-N // AS_QB) if streams_keys(N) else 1


def p_moves_in_tiles(N: int) -> bool:
    """Whether the streamed bf16 kernels move the saved P ``[.., N, N]`` in
    whole 64 x 64 TMA tiles (``as_p_tiles`` in ``csrc/attn_wgmma.cuh``):
    a row of P is ``2N`` bytes, and a TMA map needs row strides that are
    multiples of 16 bytes.  Otherwise P is written and read element by
    element from the fragments, chosen in C by this shape alone."""
    return N % 8 == 0


def stream_smem_bytes(hd: int) -> Dict[str, int]:
    """Dynamic shared memory of each streamed kernel at head_dim ``hd``,
    mirrored from the ``*_stream_smem`` functions of ``csrc/``: a function
    of hd alone, at every sequence length (the bf16 tensor-core kernels'
    does not depend on hd either; their largest variants, with P in TMA
    tiles, are given)."""
    bf, f = 2, 4
    core = lambda rows: rows * (hd + 1) * f         # padded f32 rows
    bars = 8 * (1 + AS_ST) + 4 * AS_ST    # mbarriers and the stage counters
    return {
        "attn_fwd_head_stream": 1024 + (2 + 2 * AS_ST + 2) * AS_BOX + bars,
        "attn_bwd_head_rows_stream": 1024 + (4 + 4 * AS_ST) * AS_BOX
        + 8 * 64 * f + bars,
        "attn_bwd_head_cols_stream": 1024 + 4 * AS_BOX
        + AS_ST * (4 * AS_QC * 64 * bf + 1024) + 2 * 8 * 64 * f + bars,
        "attn_core_fwd_stream": core(AT_QR + 2 * AT_KC) + AT_WARPS * AT_KC * f,
        "attn_bwd_rows_stream": core(2 * AT_QR + 2 * AT_KC)
        + AT_WARPS * AT_KC * f,
        "attn_bwd_cols_stream": (2 * AB_KR * hd + 2 * AB_RC * AB_KR
                                 + 2 * AB_RC * hd) * f,
        "flash_bwd_rows_stream": core(2 * AT_QR + 2 * AT_KC)
        + AT_WARPS * AT_KC * f,
        "flash_bwd_cols_stream": core(2 * FB_KR + 2 * AT_KC)
        + (3 * AT_KC + 2 * AT_WARPS * AT_KC) * f,
    }


_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of fedcola_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = [CSRC / s for s in SOURCES] + list(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes while held (``flock``; the kernel drops
    it when its holder exits, however it exits)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> float:
    """Compile every source in parallel and link the library, under the
    build lock; returns the seconds taken."""
    with _build_lock():
        return _compile()


def _compile() -> float:
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src}:\n{out}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, LIB_PATH)
    return time.time() - t0


def ensure_built() -> bool:
    """Build the library unless it is up to date, under the build lock
    (a process that waited on it finds the library built); True when this
    call built it."""
    with _build_lock():
        if not _stale():
            return False
        secs = _compile()
    logger.info("[KERNELS] built %d sources into %s in %.1fs", len(SOURCES),
                LIB_PATH, secs)
    return True


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            ensure_built()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the fused kernels take float32 or bfloat16, not {dtype}")


def launch(name: str, *args) -> None:
    """Call entry point ``fc_<name>`` on the current stream; raise if the
    launch sequence reported a CUDA error.  Under ``torch.profiler`` the
    call is the range ``fc_<name>``, which the kernels' rooflines read."""
    fn = getattr(library(), "fc_" + name)
    stream = torch.cuda.current_stream().cuda_stream
    with span(name, timed=False, device=True):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel fc_{name} failed with error {err}: "
                           f"{torch.cuda.get_device_name()}")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Wrapper-side argument check: the kernels index raw pointers."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
