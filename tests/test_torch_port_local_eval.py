"""Per-client local evaluation (``--eval_type local|both``) of the PyTorch
port against the JAX package on the CPU.

The port trains one round of ``test_torch_port_round.FEDCOLA`` with
``--test_size 0.2`` (each client keeps a fifth of its rows as a holdout);
the JAX server takes the port's trained global weights, and both evaluate
the same eval cohort:

* ``clients_evaluated_out``: loss avg / std / cohort figures within 1e-4
  relative, each client's loss within 1e-4 relative and its acc1 within one
  holdout sample;
* the batched path (the train set resident, every client of a dataset in
  one pass a step) against the client-by-client path (budget 0) within
  1e-6;
* ``DispatchWindow``, which both eval loops read back through, drains as
  the JAX package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu.utils import dispatch as jdispatch
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models.mat import tree_map
from fedcola_tpu_torch.utils import dispatch as tdispatch

from test_torch_port_round import FEDCOLA

LOSS_RTOL = 1e-4


def local_flags(tmp_path, eval_type, algorithm="fedavg"):
    """``FEDCOLA`` with ``--algorithm``, ``--eval_type`` and ``--test_size
    0.2``."""
    swap = {"--algorithm": algorithm, "--eval_type": eval_type,
            "--test_size": "0.2"}
    flags = [swap.get(prev, f) for prev, f in zip([""] + FEDCOLA, FEDCOLA)]
    return flags + ["--result_path", str(tmp_path / "r"),
                    "--log_path", str(tmp_path / "l")]


def record_summaries(server):
    """Record the per-client values every summary of ``server`` is made
    from, as ``(values, sizes)`` pairs in call order."""
    calls = []
    summarize = server.summarize_losses

    def recorder(values, sizes):
        calls.append((list(values), list(sizes)))
        return summarize(values, sizes)

    server.summarize_losses = recorder
    return calls


def port_server(flags, like=None):
    """The port's server on the CPU; with ``like`` (a port server) it
    starts from that server's global weights."""
    cfg = tconfig.parse_args(flags + ["--device", "cpu"])
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    if like is not None:
        server.global_params = {ds: tree_map(lambda a: a.clone(), p)
                                for ds, p in like.global_params.items()}
    return server


def eval_pair(tmp_path, eval_type, algorithm="fedavg", *extra):
    """One round of the port, then both servers' evaluation of round 1
    from the port's trained weights.  Returns ``(port, jax, port calls,
    jax calls)``."""
    flags = local_flags(tmp_path, eval_type, algorithm) + list(extra)
    tserver = port_server(flags)
    tserver.round = 1
    tserver.update()
    jcfg = jconfig.parse_args(flags + ["--no_pallas", "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    for ds, p in tserver.global_params.items():
        jserver.global_params[ds] = jax.tree_util.tree_map(
            jnp.asarray, convert.params_to_numpy(p))
    jserver.round = 1
    tcalls, jcalls = record_summaries(tserver), record_summaries(jserver)
    tserver.evaluate([])
    jserver.evaluate([])
    return tserver, jserver, tcalls, jcalls


def check_local_eval(tserver, jserver, tcalls, jcalls):
    """The port's ``clients_evaluated_out`` against the JAX server's."""
    tres = tserver.results[1]["clients_evaluated_out"]
    jres = jserver.results[1]["clients_evaluated_out"]
    assert set(tres) == set(jres) == {"loss", "acc1"}
    for k, v in jres["loss"].items():
        assert abs(tres["loss"][k] - v) <= LOSS_RTOL * abs(v) + 1e-7, \
            (k, tres["loss"][k], v)
    # loss, then acc1: per client, in the same client order
    assert len(tcalls) == len(jcalls) == 2
    (tl, tn), (jl, jn) = tcalls[0], jcalls[0]
    assert tn == jn and len(tn) == tserver.data.K
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=1e-7)
    (ta, tan), (ja, jan) = tcalls[1], jcalls[1]
    assert tan == jan
    for a, b, n in zip(ta, ja, tan):
        assert abs(a - b) <= 1.0 / n + 1e-9, (a, b, n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return eval_pair(tmp_path_factory.mktemp("local"), "both")


def test_local_eval_matches_jax_server(both):
    tserver, jserver, tcalls, jcalls = both
    check_local_eval(tserver, jserver, tcalls, jcalls)
    # --eval_type both: the central evaluation ran too, after the local
    for server in (tserver, jserver):
        assert {"server_evaluated_CIFAR100", "server_evaluated_AG_NEWS",
                "server_evaluated_Coco"} <= set(server.results[1])
    assert tserver.results[1]["local_eval_seconds"] > 0
    # every dataset's train set was staged, so every group ran batched
    for ds in ("CIFAR100", "AG_NEWS", "Coco"):
        assert tserver._resident_cache[ds] is not None


def test_batched_local_eval_matches_serial(both, tmp_path, monkeypatch):
    tserver, _, tcalls, _ = both
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", "0")
    serial = port_server(local_flags(tmp_path, "local"), like=tserver)
    serial.round = 1
    calls = record_summaries(serial)
    serial.evaluate([])
    assert all(v is None for v in serial._resident_cache.values())
    want = tserver.results[1]["clients_evaluated_out"]
    got = serial.results[1]["clients_evaluated_out"]
    assert set(got) == set(want)
    for m in want:
        for k, v in want[m].items():
            assert got[m][k] == pytest.approx(v, rel=1e-6, abs=1e-9), (m, k)
    for (a, an), (b, bn) in zip(calls, tcalls):
        assert an == bn
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    # --eval_type local: no central evaluation
    assert not any(k.startswith("server_evaluated_")
                   for k in serial.results[1])


def test_creamfl_local_eval_matches_jax_server(tmp_path):
    """CreamFL's server evaluates its clients' holdouts as FedAvg's does
    (its round trains the public passes and the distillation too)."""
    tserver, jserver, tcalls, jcalls = eval_pair(
        tmp_path, "local", "creamfl", "--num_pub_samples", "20",
        "--pub_batch_size", "8")
    assert type(tserver).__name__ == type(jserver).__name__ == \
        "CreamflServer"
    check_local_eval(tserver, jserver, tcalls, jcalls)


def test_dispatch_window_drains_as_jax():
    """The same pushes drain the same items at the same points: FIFO, the
    oldest once ``EVAL_INFLIGHT`` are queued, the rest on ``flush``."""
    logs = {}
    for name, mod in (("jax", jdispatch), ("port", tdispatch)):
        log = logs[name] = []
        window = mod.DispatchWindow(lambda a, b: log.append((a, b)))
        for i in range(11):
            window.push(i, -i)
            log.append(("pushed", i))
        window.flush()
    assert logs["port"] == logs["jax"]
    assert logs["port"][:9] == [("pushed", i) for i in range(7)] + \
        [(0, 0), ("pushed", 7)]
