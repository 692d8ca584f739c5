"""Where one FedCola round's device time goes, by kernel and by wrapper.

    python -m fedcola_tpu_torch.profile_round [--tiny | --long | --population
                                               | main.py flags]

Runs the configured experiment for one untraced warm-up round, then traces
the next round's update (train + aggregate) with ``torch.profiler`` and
prints the wall time, the summed device kernel time, the device idle share
(1 - kernel time / wall time, one stream), the device time under each
kernel wrapper (``fc_*`` ranges, one per TPU kernel of the JAX package)
and the top kernels by device time.  Without flags it runs the main path
of ``chip_smoke.py`` (``main.MAIN_PATH_FLAGS``); ``--tiny`` runs the same
line at mome_tiny width (``main.MOME_TINY_FLAGS``, the flash route);
``--long`` the long-text line (``main.MEDABS_LONG_FLAGS``, N = 512);
``--population`` the coco.sh line at its own population and length
(``main.population_flags``: whole shards for E = 5 epochs) on a COCO
fixture of 1000 path-backed 224 px images written to a temporary
directory, CIFAR100 and AG_NEWS their synthetic stand-ins, as
``chip_smoke.py`` [population] runs it.
"""

from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def main(argv=None) -> int:
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.data.fixtures import coco_fixture
    from fedcola_tpu_torch.data.loaders import load_federated_data
    from fedcola_tpu_torch.federation.server import create_server
    from fedcola_tpu_torch.main import (MAIN_PATH_FLAGS, MEDABS_LONG_FLAGS,
                                        MOME_TINY_FLAGS, population_flags)
    argv = list(argv if argv is not None else sys.argv[1:])
    named = {"--tiny": MOME_TINY_FLAGS, "--long": MEDABS_LONG_FLAGS}
    with tempfile.TemporaryDirectory(prefix="fedcola_profile_") as out:
        if argv == ["--population"]:
            argv = list(population_flags(
                coco_fixture(f"{out}/coco", 1000, 250, 224),
                f"{out}/no_cifar100", f"{out}/no_agnews"))
        elif argv == [] or (len(argv) == 1 and argv[0] in named):
            argv = list(named[argv[0]] if argv else MAIN_PATH_FLAGS)
        cfg = parse_args(argv + ["--result_path", out, "--log_path", out])
        if cfg.device != "cuda":
            raise SystemExit("profile_round measures the card: --device cuda")
        server = create_server(cfg, load_federated_data(
            cfg, np.random.RandomState(cfg.seed)))
        return _profile(server)


def _profile(server) -> int:
    server.round = 1
    server.update()
    torch.cuda.synchronize()
    server.round = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        server.update()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = prof.key_averages()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    # the fc_* ranges also appear on the device timeline (user
    # annotations spanning their kernels): count them apart, not twice
    wrappers = [e for e in on_device if e.key.startswith("fc_")]
    kernels = [e for e in on_device if not e.key.startswith("fc_")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[profile] round wall {wall:.3f}s, device kernel time "
          f"{busy:.3f}s, device idle share {1 - busy / wall:.3f}")
    in_wrappers = sum(e.device_time_total for e in wrappers) / 1e6
    in_bwd = sum(e.device_time_total for e in wrappers
                 if "_bwd" in e.key) / 1e6
    print(f"[profile] kernel wrappers {in_wrappers:.3f}s "
          f"({in_wrappers / wall:.3f} of wall); backward wrappers "
          f"{in_bwd:.3f}s ({in_bwd / busy:.3f} of device kernel time)")
    for e in sorted(wrappers, key=lambda e: -e.device_time_total):
        print(f"[profile] wrapper {e.key:12s} calls {e.count:5d} device "
              f"{e.device_time_total / 1e3:10.1f} ms "
              f"({e.device_time_total / 1e6 / wall:.3f} of wall)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        name = e.key if len(e.key) <= 90 else e.key[:87] + "..."
        print(f"[profile] kernel {e.self_device_time_total / 1e3:10.1f} ms "
              f"x{e.count:5d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
