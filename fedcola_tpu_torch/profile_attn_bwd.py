"""Where one call of the fused attention backward spends its device time.

    python -m fedcola_tpu_torch.profile_attn_bwd [N ...]

Traces ten calls each of ``attn_bwd`` (from the plain forward's saves) and
``attn_bwd_recompute`` with ``torch.profiler`` at mome_small's training
shape (n=2 clients, B=96, D=384, 6 heads, bfloat16), and of the flash
backward at mome_tiny's (3 heads of 64), for each N given (197 and 40 by
default; 512 is the long-text line's, where the per-head kernels stream
the keys), and prints the device time per call of every kernel they
launch: the Hopper GEMM instantiations, the per-head kernels, LayerNorm
and the column sums, and a SHA-1 digest of each entry point's outputs
(seeded inputs, no atomics: two builds that compute the same function the
same way print the same digests).  Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 10


def _inputs(n, B, N, D, dev):
    r = np.random.RandomState(N)
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (r.randn(*shape) * scale).astype(np.float32)).to(dev)
    bf = torch.bfloat16
    s = torch.from_numpy(r.choice([0.0, 1.0 / 0.9], size=(n, B))
                         .astype(np.float32)).to(dev)
    w = [f(n, D, scale=0.2) + 1.0, f(n, D, scale=0.1),
         f(n, D, 3 * D, scale=D ** -0.5).to(bf), f(n, 3 * D, scale=0.1).to(bf),
         f(n, D, D, scale=D ** -0.5).to(bf)]
    return f(n, B, N, D).to(bf), s, w, f(n, D, scale=0.1).to(bf), \
        f(n, B, N, D).to(bf)


def _flash(n, B, N, dev):
    """q, k, v, dO [n, B, 3, N, 64] in bf16 (mome_tiny's heads), seeded."""
    r = np.random.RandomState(N + 1)
    return [torch.from_numpy(r.randn(n, B, 3, N, 64).astype(np.float32))
            .to(dev).to(torch.bfloat16) for _ in range(4)]


def digest(tensors) -> str:
    """SHA-1 over the bytes of every tensor, in order."""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    from fedcola_tpu_torch.ops import flash_attention as fl
    from fedcola_tpu_torch.ops import fused_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("profile_attn_bwd measures the card: no CUDA device")
    dev = torch.device("cuda")
    n, B, D, H = 2, 96, 384, 6
    for N in [int(a) for a in (argv or sys.argv[1:])] or (197, 40):
        x, s, w, bproj, da = _inputs(n, B, N, D, dev)
        _, P, cat = fa.attn_fwd_plain(x, s, *w, bproj, H)
        q, k, v, do = _flash(n, B, N, dev)
        entries = {
            "attn_bwd": lambda: fa.attn_bwd(x, s, *w, P, cat, da, H),
            "attn_bwd_recompute": lambda: fa.attn_bwd_recompute(x, *w, da, H),
            "flash_bwd": lambda: fl.flash_bwd(q, k, v, do, 0.125)}
        for name, fn in entries.items():
            for _ in range(3):
                outs = fn()
            torch.cuda.synchronize()
            print(f"[attn_bwd] {name} N={N}: outputs sha1 {digest(outs)}")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and not e.key.startswith("fc_")]
            total = sum(e.self_device_time_total for e in kernels)
            print(f"[attn_bwd] {name} N={N}: {total / CALLS / 1e3:.4f} ms of "
                  f"kernels a call ({torch.cuda.get_device_name(0)})")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
                print(f"[attn_bwd]   {e.self_device_time_total / CALLS / 1e3:8.4f}"
                      f" ms x{e.count // CALLS:2d}  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
