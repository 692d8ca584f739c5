"""Server-side FL optimizers: FedAvgM, FedAdam, FedYogi, FedAdagrad (port
of ``fedcola_tpu/federation/fedopt.py``).

The reference ships these as ``src/algorithm/*`` (fedavg.py:7-55,
fedadam.py:7-62, fedyogi.py:7-63, fedadagrad.py:7-61) but its multimodal
server never calls them.  As in the JAX package they are server-delta
optimizers: each round the scoped aggregate defines the pseudo-gradient
``delta = aggregate - global`` and the server state follows the FedOpt
recurrences (Reddi et al. 2021) from zero moments:

* fedavgm:    m = b1*m + (1-b1)*delta;               g += lr * m
* fedadam:    m as above; v = b2*v + (1-b2)*delta^2;  g += lr*m/(sqrt(v)+tau)
* fedyogi:    v = v - (1-b2)*delta^2*sign(v - delta^2)
* fedadagrad: v = v + delta^2

b1 = ``--beta1`` (0, the CLI default, means no server momentum), b2 =
0.99, tau = ``--server_tau``; the server lr is ``--server_lr`` when given,
else this round's client lr before its decay.  ``fedavgm --beta1 0
--server_lr 1`` is exactly the plain aggregate.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from fedcola_tpu_torch.config import DATASET_2_MODALITY
from fedcola_tpu_torch.federation.aux import exchange_aux_weights
from fedcola_tpu_torch.federation.server import FedAvgServer
from fedcola_tpu_torch.models import naming
from fedcola_tpu_torch.models.mat import tree_map

logger = logging.getLogger(__name__)


@torch.no_grad()
def _fedopt_step(global_params, agg_params, m, v, lr: float, flavor: str,
                 b1: float, b2: float, tau: float):
    """One server step over matching trees; returns new (global, m, v)
    trees."""
    if flavor not in ("fedavgm", "fedadam", "fedyogi", "fedadagrad"):
        raise ValueError(flavor)

    def walk(g, a, m_, v_):
        if isinstance(g, dict):
            out = {k: walk(g[k], a[k], m_[k], v_[k]) for k in g}
            return tuple({k: o[i] for k, o in out.items()} for i in range(3))
        delta = a - g
        m_new = b1 * m_ + (1 - b1) * delta
        if flavor == "fedavgm":
            return g + lr * m_new, m_new, v_
        d2 = delta.square()
        if flavor == "fedadam":
            v_new = b2 * v_ + (1 - b2) * d2
        elif flavor == "fedyogi":
            v_new = v_ - (1 - b2) * d2 * torch.sign(v_ - d2)
        else:
            v_new = v_ + d2
        return g + lr * m_new / (torch.sqrt(v_new) + tau), m_new, v_new

    return walk(global_params, agg_params, m, v)


class FedOptServer(FedAvgServer):
    def __init__(self, cfg, data, writer=None, plan=None):
        super().__init__(cfg, data, writer, plan)
        self.flavor = cfg.algorithm
        self.b1 = float(cfg.beta1)
        self.b2 = 0.99
        self.tau = float(cfg.server_tau)
        self.server_m = {ds: tree_map(torch.zeros_like, p)
                         for ds, p in self.global_params.items()}
        self.server_v = {ds: tree_map(torch.zeros_like, p)
                         for ds, p in self.global_params.items()}

    def save_checkpoint(self, path: str):
        """The base checkpoint and ``__fedopt_{ds}.npz``: the server
        moments under ``m {name}`` / ``v {name}`` (a resume without them
        would restart from zero moments)."""
        super().save_checkpoint(path)
        for ds in self.global_params:
            flat = {}
            for p, name in naming.param_names(self.model_cfgs[ds]):
                for key, tree in (("m", self.server_m), ("v", self.server_v)):
                    flat[f"{key} {name}"] = naming.get_by_path(
                        tree[ds], p).float().cpu().numpy()
            np.savez(os.path.join(path, f"__fedopt_{ds}.npz"), **flat)

    def load_checkpoint(self, path: str):
        super().load_checkpoint(path)
        for ds in self.global_params:
            f = os.path.join(path, f"__fedopt_{ds}.npz")
            if not os.path.exists(f):
                continue
            with np.load(f) as z:
                for p, name in naming.param_names(self.model_cfgs[ds]):
                    has_m, has_v = f"m {name}" in z, f"v {name}" in z
                    if has_m and has_v:
                        for key, tree in (("m", self.server_m),
                                          ("v", self.server_v)):
                            old = naming.get_by_path(tree[ds], p)
                            naming.set_by_path(tree[ds], p, torch.from_numpy(
                                z[f"{key} {name}"]).to(old.device,
                                                       old.dtype))
                    elif has_m or has_v:
                        # save_checkpoint writes the pair: one alone is a
                        # damaged checkpoint
                        logger.warning(
                            "[FEDOPT] checkpoint %s has only one of the m/v "
                            "moment pair for %r (%s present): moments for "
                            "this param restart from zero", f, name,
                            "m" if has_m else "v")

    def _update(self):
        old_globals = dict(self.global_params)
        # super()._update() decays curr_lr at its end: take this round's now
        round_lr = (self.cfg.server_lr if self.cfg.server_lr is not None
                    else self.curr_lr)
        sampled = super()._update()
        if not sampled:
            return sampled
        # global_params holds the plain aggregate: step from the old globals
        for ds in self.global_params:
            (self.global_params[ds], self.server_m[ds],
             self.server_v[ds]) = _fedopt_step(
                old_globals[ds], self.global_params[ds], self.server_m[ds],
                self.server_v[ds], round_lr, self.flavor, self.b1, self.b2,
                self.tau)
        # the base round exchanged aux weights against the aggregate before
        # the step: re-sync them from the stepped kernels
        if self.cfg.with_aux:
            self.global_params = exchange_aux_weights(
                self.global_params, self.model_cfgs,
                {ds: DATASET_2_MODALITY[ds] for ds in self.global_params})
        # the base guard ran before the step rewrote the globals
        self._assert_global_finite()
        return sampled
