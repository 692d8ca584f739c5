"""Server features of the PyTorch port against the JAX package on the CPU,
from the same initial weights (``mome_test16_patch16_32``, synthetic data,
dropout 0, float32), as ``tests/test_torch_port_round.py`` runs its rounds:

* ``--fedavg_eval``: the ``server_evaluated_{ds}_fedavg`` results exist and
  equal the JAX server's (acc1 within one test sample, r@1sum within one
  image and one caption per direction, loss 1e-4 relative), and the flag
  leaves the round's weights bit for bit as they are without it;
* checkpoints: a port checkpoint holds the names and shapes of the JAX
  server's; a run stopped after round 1 and resumed equals an unbroken
  two-round run exactly (losses and every leaf);
* ``--algorithm fedsgd``: one round agrees (loss 1e-5 relative);
* ``--eval_type local`` runs under ``fedprox``, ``fediot`` and ``fedadam``
  as under fedavg (``tests/test_torch_port_local_eval.py``): the clients'
  holdout results agree with the JAX server's, and no central evaluation
  runs.
"""

import os

import numpy as np
import pytest

import jax

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as port_main
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models.mat import tree_leaves

from test_torch_port_local_eval import check_local_eval, eval_pair
from test_torch_port_round import FEDCOLA


def _flags(tmp_path, *extra, algorithm="fedavg"):
    flags = [algorithm if prev == "--algorithm" else f
             for prev, f in zip([""] + FEDCOLA, FEDCOLA)]
    return flags + list(extra) + ["--result_path", str(tmp_path / "r"),
                                  "--log_path", str(tmp_path / "l")]


def _jax_server(flags):
    cfg = jconfig.parse_args(flags + ["--no_pallas", "--mesh_shape", "1"])
    return jcreate(cfg, jload(cfg, np.random.RandomState(cfg.seed)))


def _port_server(flags, like=None):
    """The port's server; with ``like`` it starts from that JAX server's
    initial global weights."""
    cfg = tconfig.parse_args(flags + ["--device", "cpu"])
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    if like is not None:
        for ds, p in like.global_params.items():
            server.global_params[ds] = convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, p),
                cfg=server.model_cfgs[ds])
    return server


def _round(server, r=1):
    server.round = r
    server.update()
    server.evaluate([])
    return server.results[r]


def _leaves(server):
    return [leaf for ds in server.global_params
            for leaf in tree_leaves(server.global_params[ds])]


def test_fedavg_eval_matches_jax_server(tmp_path):
    flags = _flags(tmp_path, "--fedavg_eval")
    jserver = _jax_server(flags)
    tserver = _port_server(flags, like=jserver)
    plain = _port_server(_flags(tmp_path), like=jserver)
    jres, tres, pres = _round(jserver), _round(tserver), _round(plain)

    for ds in ("CIFAR100", "AG_NEWS"):
        key = f"server_evaluated_{ds}_fedavg"
        assert key in tres and key not in pres
        n = tserver.data.server_eval[ds].n
        assert abs(tres[key]["metrics"]["acc1"]
                   - jres[key]["metrics"]["acc1"]) <= 1.0 / n + 1e-9
        assert abs(tres[key]["loss"] - jres[key]["loss"]) \
            <= 1e-4 * abs(jres[key]["loss"])
    test = tserver.data.server_eval["Coco"]
    n_img = len(np.unique(test.image_ids))
    key = "server_evaluated_Coco_fedavg"
    assert set(tres[key]) == set(jres[key])
    assert abs(tres[key]["Coco r@1sum"] - jres[key]["Coco r@1sum"]) \
        <= 2.0 / n_img + 2.0 / test.n + 1e-9
    assert "fedavg_eval" in tres["round_sections"]
    # the plain-fedavg aggregate differs from the scoped one it evaluates
    # beside, and is gone after the round: the weights are those of a run
    # without the flag
    assert tres["server_evaluated_CIFAR100"] == pres["server_evaluated_CIFAR100"]
    for a, b in zip(_leaves(tserver), _leaves(plain)):
        assert a.equal(b)


def test_checkpoint_names_and_shapes_match_jax_server(tmp_path):
    flags = _flags(tmp_path)
    jserver = _jax_server(flags)
    tserver = _port_server(flags, like=jserver)
    jserver.round = tserver.round = 3
    jserver.save_checkpoint(str(tmp_path / "j"))
    tserver.save_checkpoint(str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    for ds in tserver.global_params:
        jz = np.load(tmp_path / "j" / f"{ds}.npz")
        tz = np.load(tmp_path / "t" / f"{ds}.npz")
        assert set(tz.files) == set(jz.files)
        for name in jz.files:
            assert tz[name].shape == jz[name].shape, name
            np.testing.assert_array_equal(tz[name], jz[name], err_msg=name)
    jr = np.load(tmp_path / "j" / "__rng__.npz")
    tr = np.load(tmp_path / "t" / "__rng__.npz")
    assert set(tr.files) - {"torch_gen", "torch_gen_device"} == \
        set(jr.files) - {"jax_key"}
    # and it loads back: round, lr, weights, both random streams
    other = _port_server(flags)
    other.shuffle_rng.rand(7)
    other.load_checkpoint(str(tmp_path / "t"))
    assert other.round == 3 and other.curr_lr == tserver.curr_lr
    for a, b in zip(_leaves(other), _leaves(tserver)):
        assert a.equal(b)
    assert other.shuffle_rng.rand() == tserver.shuffle_rng.rand()
    assert other.gen.get_state().equal(tserver.gen.get_state())


def test_resumed_run_equals_unbroken_run(tmp_path):
    """Through the port's entry point: ``--R 1 --checkpoint_every 1``, then
    the same command with ``--R 2`` finds the checkpoint and runs round 2
    only; DropPath is on, so the generator's state matters too."""
    def run(sub, R, *extra):
        flags = _flags(tmp_path / sub, "--device", "cpu", *extra)
        flags = [str(R) if prev == "--R" else f
                 for prev, f in zip([""] + flags, flags)]
        flags = ["0.2" if prev == "--dropout" else f
                 for prev, f in zip([""] + flags, flags)]
        return port_main.main(flags)

    whole = run("whole", 2)
    first = run("parts", 1, "--checkpoint_every", "1")
    assert sorted(first.results) == [1]
    ckpt = tmp_path / "parts" / "r" / "FedCola" / "ckpt"
    assert (ckpt / "__rng__.npz").exists()
    resumed = run("parts", 2, "--checkpoint_every", "1")
    assert sorted(resumed.results) == [2]
    for r, server in ((1, first), (2, resumed)):
        assert server.results[r]["clients_updated_summary"] == \
            whole.results[r]["clients_updated_summary"]
    assert resumed.curr_lr == whole.curr_lr
    for a, b in zip(_leaves(resumed), _leaves(whole)):
        assert a.equal(b)
    # finalize always writes the final weights
    final = np.load(tmp_path / "whole" / "r" / "FedCola" / "CIFAR100.npz")
    assert int(final["__round__"]) == 2


def test_fedsgd_round_matches_jax_server(tmp_path):
    flags = _flags(tmp_path, algorithm="fedsgd")
    jserver = _jax_server(flags)
    tserver = _port_server(flags, like=jserver)
    assert tserver.cfg.E == 1
    jres, tres = _round(jserver), _round(tserver)
    jl = jres["clients_updated_summary"]["loss"]["avg"]
    tl = tres["clients_updated_summary"]["loss"]["avg"]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    n = tserver.data.server_eval["CIFAR100"].n
    assert abs(tres["server_evaluated_CIFAR100"]["metrics"]["acc1"]
               - jres["server_evaluated_CIFAR100"]["metrics"]["acc1"]) \
        <= 1.0 / n + 1e-9


@pytest.mark.parametrize("algorithm", ["fedprox", "fediot", "fedadam"])
def test_local_eval_matches_jax_server_under_algorithm(tmp_path, algorithm):
    """Per-client local evaluation runs under every server class, from the
    port's trained weights, as the JAX server's does."""
    tserver, jserver, tcalls, jcalls = eval_pair(tmp_path, "local",
                                                 algorithm)
    assert type(tserver).__name__ == type(jserver).__name__
    check_local_eval(tserver, jserver, tcalls, jcalls)
    assert not any(k.startswith("server_evaluated_")
                   for k in tserver.results[1])
