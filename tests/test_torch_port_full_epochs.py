"""The scripts/coco.sh FedCola line at its own population and local length
(``main.POPULATION_FLAGS``: ``--Ks 12 12 8 --Cs 0.25``, whole shards for E
epochs, no ``--debug``): the PyTorch port against the JAX package on the
CPU at ``mome_test16_patch16_32`` (32 px, dropout 0, float32), on
path-backed fixtures, cut to ``--B 8 --train_chunk_steps 4 --E 3 --R 3``.

* Before training, the shape the line gives: in every group of round 1 the
  sampled clients take different numbers of steps an epoch, some client
  takes more than ``--train_chunk_steps`` steps an epoch (several chunks a
  round), and some shard is not a multiple of B (a partial last batch).
* Three rounds through the JAX server and the port, the port starting from
  the JAX weights: every round's average training loss and every client's
  own loss within 1e-5 relative, central acc1 and COCO r@1sum equal.
* The port's resident and host-fed data planes give the same bits.
* ``GroupFeeder`` against the JAX feeder on ragged shards for E = 3: the
  same ``idx`` / ``valid`` / ``step_valid`` (and gathered rows) bit for bit
  through ``round_index_chunks``, ``round_chunks`` and ``epoch_chunks``.
"""

import numpy as np
import pytest
import torch

import jax

from fedcola_tpu import config as jconfig
from fedcola_tpu.data import datasets as jdatasets
from fedcola_tpu.data import pipeline as jpipeline
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.data import datasets as tdatasets
from fedcola_tpu_torch.data import fixtures
from fedcola_tpu_torch.data import pipeline as tpipeline
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.data.sampling import sample_clients
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert

R, E, B, CHUNK = 3, 3, 8, 4
CUTS = {"--model_name": "mome_test16_patch16_32", "--resize": "32",
        "--B": str(B), "--E": str(E), "--R": str(R),
        "--eval_batch_size": "128", "--device": None, "--seq_len": "12",
        "--vocab_size": "120", "--compute_dtype": "float32",
        "--dropout": "0", "--train_chunk_steps": str(CHUNK)}
# test_torch_port_fixture_line.py's fixture sizes, but for 44 COCO train
# images: with 40, every COCO client holds 4 images (20 rows), so no
# sampled COCO pair could differ in its steps
COCO, CIFAR, AGNEWS = (44, 12, 32), (800, 200), (400, 100)
PORT_ONLY = ("eval_seconds", "local_eval_seconds", "mesh", "round_counters")
TIMES = ("round_seconds", "round_sections")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side.  At test width every op is
    small, and with the cores shared (xdist workers, the JAX side's own
    pool) more threads only wait on each other: beside one busy process
    these files ran about three times faster so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flags(tmp_path_factory):
    """``POPULATION_FLAGS`` on the fixture roots at test size (less the
    device flags)."""
    d = tmp_path_factory.mktemp("full_epochs")
    return list(tmain.cut(tmain.population_flags(
        fixtures.coco_fixture(str(d / "coco"), *COCO),
        fixtures.cifar100_fixture(str(d / "cifar"), *CIFAR),
        fixtures.agnews_fixture(str(d / "agnews"), *AGNEWS)), CUTS))


def _groups(server, r):
    """Round ``r``'s sampled clients by dataset, as ``update`` draws them."""
    cfg = server.cfg
    sampled = sample_clients(
        server.sampler, server.client_dataset_of, server.client_modality_of,
        cfg.client_datasets, server.Cs, cfg.C, cfg.equal_sampled, r)
    return {ds: [i for i in sampled if server.clients[i].dataset == ds]
            for ds in cfg.client_datasets}


def _close(got, want, what):
    assert abs(got - want) <= 1e-5 * abs(want), (what, got, want)


def _untimed(res):
    """A round's results without the port's own keys and the timings."""
    return {k: v for k, v in res.items() if k not in PORT_ONLY + TIMES}


def test_full_epochs_match_jax_server(flags, tmp_path, monkeypatch):
    out = ["--result_path", str(tmp_path / "j"), "--log_path",
           str(tmp_path / "l")]
    jcfg = jconfig.parse_args(flags + out + ["--no_pallas",
                                             "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    servers = {}
    for plane in ("resident", "host"):
        out[1] = str(tmp_path / plane)
        tcfg = tconfig.parse_args(flags + out + ["--device", "cpu"])
        servers[plane] = tcreate(
            tcfg, tload(tcfg, np.random.RandomState(tcfg.seed)))
        for ds, p in jserver.global_params.items():
            servers[plane].global_params[ds] = convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, p),
                cfg=servers[plane].model_cfgs[ds])
    tserver = servers["resident"]
    assert not tcfg.debug and tcfg.E == E and tcfg.Ks == [12, 12, 8]

    # the shape this test exists for
    shards = tserver.data.client_shards
    steps = {ds: [-(-shards[i].n // B) for i in ids]
             for ds, ids in _groups(tserver, 1).items()}
    assert [len(s) for s in steps.values()] == [3, 3, 2], steps
    for ds, s in steps.items():
        assert len(set(s)) > 1, (ds, s)       # ragged across the group
    assert max(max(s) for s in steps.values()) > CHUNK, steps
    assert any(shards[i].n % B for ids in _groups(tserver, 1).values()
               for i in ids)

    for r in range(1, R + 1):
        for s in (jserver, tserver):
            s.round = r
            s.update()
            s.evaluate([])
        jr, tr = jserver.results[r], tserver.results[r]
        _close(tr["clients_updated_summary"]["loss"]["avg"],
               jr["clients_updated_summary"]["loss"]["avg"], (r, "avg"))
        assert sorted(tr["clients_updated"]) == sorted(jr["clients_updated"])
        for c, m in jr["clients_updated"].items():
            _close(tr["clients_updated"][c]["loss"], m["loss"], (r, c))
            assert tr["clients_updated"][c]["acc1"] == m["acc1"], (r, c)
        for ds in ("CIFAR100", "AG_NEWS"):
            key = f"server_evaluated_{ds}"
            assert tr[key]["metrics"]["acc1"] == jr[key]["metrics"]["acc1"]
        assert (tr["server_evaluated_Coco"]["Coco r@1sum"]
                == jr["server_evaluated_Coco"]["Coco r@1sum"]), r

    # the host-fed plane: every batch gathered on the host, the same bits
    host = servers["host"]
    monkeypatch.setenv("FEDCOLA_RESIDENT_BUDGET", "0")
    for r in range(1, R + 1):
        host.round = r
        host.update()
        host.evaluate([])
        assert _untimed(host.results[r]) == _untimed(tserver.results[r]), r
    assert all(v is None for v in host._resident_cache.values())
    assert all(v is not None for v in tserver._resident_cache.values())
    for ds, p in tserver.global_params.items():
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(host.global_params[ds])):
            assert a.equal(b), ds


def _feeders(modality, seed):
    """The same ragged shards (13, 45, 21 and 8 rows) in a dataset of each
    package, and a feeder of each over them."""
    r = np.random.RandomState(0)
    n = 96
    kw = dict(name="ragged", task="cls", modality=modality, num_classes=5,
              n=n, targets=r.randint(0, 5, n).astype(np.int64))
    if modality == "img":
        kw["images"] = r.randint(0, 256, (n, 4, 4, 3)).astype(np.uint8)
    else:
        kw["texts"] = r.randint(0, 50, (n, 6)).astype(np.int32)
    perm = r.permutation(n)
    bounds = np.cumsum([0, 13, 45, 21, 8])
    feeders = []
    for pkg_ds, pkg_pipe in ((jdatasets, jpipeline), (tdatasets, tpipeline)):
        ds = pkg_ds.TaskDataset(**kw)
        shards = [pkg_pipe.ClientShard(dataset=ds, indices=perm[a:b].copy())
                  for a, b in zip(bounds[:-1], bounds[1:])]
        feeders.append(pkg_pipe.GroupFeeder(
            shards, B, modality, chunk_steps=CHUNK,
            rng=np.random.RandomState(seed)))
    return feeders


@pytest.mark.parametrize("modality", ["img", "txt"])
@pytest.mark.parametrize("stream", ["round_index_chunks", "round_chunks",
                                    "epoch_chunks"])
def test_group_feeder_matches_jax_feeder(stream, modality):
    jfeed, tfeed = _feeders(modality, seed=7)
    assert list(tfeed.steps_per_client) == [2, 6, 3, 1]
    if stream == "epoch_chunks":
        # one reshuffle an epoch; its last chunk of 2 steps is bucketed
        # to 2, below --train_chunk_steps
        jchunks = [c for _ in range(E) for c in jfeed.epoch_chunks()]
        tchunks = [c for _ in range(E) for c in tfeed.epoch_chunks()]
    else:
        jchunks = list(getattr(jfeed, stream)(E))
        tchunks = list(getattr(tfeed, stream)(E))
    assert len(tchunks) == len(jchunks) > 1
    for j, t in zip(jchunks, tchunks):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the shape the streams exist for: partial batches, padded steps
    last = tchunks[-1]
    assert not last["step_valid"].all() and not last["valid"].all()
    if stream == "round_index_chunks":
        # client 1's 18 steps in 5 chunks of 4, the others padded
        assert len(tchunks) == 5
        assert last["step_valid"].sum(1).tolist() == [0, 2, 0, 0]
    if stream == "epoch_chunks":
        assert [c["step_valid"].shape[1] for c in tchunks] == [4, 2] * E
