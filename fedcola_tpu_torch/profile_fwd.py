"""Where one call of each fused forward spends its device time.

    python -m fedcola_tpu_torch.profile_fwd [N ...]

Traces ten calls each of the six forward variants of the fused route with
``torch.profiler`` in bfloat16 at mome_small's width (D=384, F=1536, 6
heads) for each N given (197 and 40 by default; 512 is the long-text
line's, where the per-head kernels stream the keys): ``mlp_fwd`` and
``attn_fwd`` at the training shape (n=2 clients, B=96; residual, P saved)
and at central eval's (n=1, B=500; neither), ``mlp_fwd_rows`` and
``mlp_ln_fwd_rows`` on the training batch flattened, and the flash forward
at mome_tiny's shapes (3 heads of 64; n=2, B=96 and n=1, B=500).  Prints
the device time per call of every kernel they launch: the Hopper GEMM
instantiations (the last template argument is the epilogue: 1 bias, 3
GELU, 4 residual join), the per-head kernel and LayerNorm.  Inputs are
seeded; needs a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 10


def _inputs(n, B, N, D, dev):
    r = np.random.RandomState(N + B)
    bf = torch.bfloat16
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (r.randn(*shape) * scale).astype(np.float32)).to(dev)
    s = torch.from_numpy(r.choice([0.0, 1.0 / 0.9], size=(n, B))
                         .astype(np.float32)).to(dev)
    ln = [f(n, D, scale=0.2) + 1.0, f(n, D, scale=0.1)]
    attn = [f(n, D, 3 * D, scale=D ** -0.5).to(bf),
            f(n, 3 * D, scale=0.1).to(bf), f(n, D, D, scale=D ** -0.5).to(bf),
            f(n, D, scale=0.1).to(bf)]
    mlp = [f(n, D, 4 * D, scale=D ** -0.5).to(bf),
           f(n, 4 * D, scale=0.1).to(bf),
           f(n, 4 * D, D, scale=0.5 * D ** -0.5).to(bf),
           f(n, D, scale=0.1).to(bf)]
    return f(n, B, N, D).to(bf), s, ln, attn, mlp


def _flash(n, B, N, dev):
    """q, k, v [n, B, 3, N, 64] in bf16 (mome_tiny's heads), seeded."""
    r = np.random.RandomState(N + B + 1)
    return [torch.from_numpy(r.randn(n, B, 3, N, 64).astype(np.float32))
            .to(dev).to(torch.bfloat16) for _ in range(3)]


def main(argv=None) -> int:
    from fedcola_tpu_torch.ops import flash_attention as fl
    from fedcola_tpu_torch.ops import fused_attention as fa
    from fedcola_tpu_torch.ops import fused_mlp as fm
    if not torch.cuda.is_available():
        raise SystemExit("profile_fwd measures the card: no CUDA device")
    dev = torch.device("cuda")
    D, H = 384, 6
    for N in [int(a) for a in (argv or sys.argv[1:])] or (197, 40):
        x, s, ln, attn, mlp = _inputs(2, 96, N, D, dev)
        xe, _, lne, attne, mlpe = _inputs(1, 500, N, D, dev)
        xr = x.reshape(2, 96 * N, D)
        fq, fk, fv = _flash(2, 96, N, dev)
        eq, ek, ev = _flash(1, 500, N, dev)
        entries = {
            "attn_fwd": lambda: fa.attn_fwd(x, s, *ln, *attn, H, save=True),
            "attn_fwd (eval)": lambda: fa.attn_fwd(xe, None, *lne, *attne, H,
                                                   save=False),
            "mlp_fwd": lambda: fm.mlp_fwd(x, s, *ln, *mlp),
            "mlp_fwd (eval)": lambda: fm.mlp_fwd(xe, None, *lne, *mlpe),
            "mlp_fwd_rows": lambda: fm.mlp_fwd_rows(xr, *mlp),
            "mlp_ln_fwd_rows": lambda: fm.mlp_ln_fwd_rows(xr, *ln, *mlp),
            "flash_fwd": lambda: fl.flash_fwd(fq, fk, fv, 0.125),
            "flash_fwd (eval)": lambda: fl.flash_fwd(eq, ek, ev, 0.125)}
        for name, fn in entries.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
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
            print(f"[fwd] {name} N={N}: {total / CALLS / 1e3:.4f} ms of "
                  f"kernels a call ({torch.cuda.get_device_name(0)})")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
                print(f"[fwd]   {e.self_device_time_total / CALLS / 1e3:8.4f}"
                      f" ms x{e.count // CALLS:2d}  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
