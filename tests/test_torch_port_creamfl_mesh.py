"""CreamFL under the port's device mesh (``federation/creamfl.py`` on
``parallel/mesh.py``) on the CPU: gloo ranks on ``FEDCOLA_VIRTUAL_DEVICES``
virtual devices, the CreamFL line of ``test_torch_port_creamfl.py``
(``mome_test16_patch16_32``, float32, dropout 0, synthetic data and public
set, ``--Ks 2 2 2 --Cs 1 --B 8 --num_pub_samples 20 --pub_batch_size 8``:
the last public batch is ragged; the img+txt public pass on) under the SGD
flags of ``test_torch_port_mesh.py``, two rounds, through ``python -m
fedcola_tpu_torch.main``.

* Three meshes against the port's 1-rank run, all from the JAX server's
  initial weights: ``clients4`` (each group of two padded to four, so two
  ranks hold only padding), ``clients2xdata2`` (4 of the 8 public rows a
  rank) and ``clients2xmodel2`` (the public steps and the extraction on
  the model ranks' shards): round and holdout losses within 1e-4
  relative, acc1 and r@1sum equal, every leaf within rtol 2e-5 / atol
  2e-6.  One exception: the key third of the distilled model's
  ``qkv_bias`` has a zero gradient in exact arithmetic (softmax over keys
  ignores it), so the distillation's AdamW steps it on rounding noise,
  which a reassociated sum changes; it is held within twice the sum of
  ``--p_lr`` over the distillation steps it took.
* ``clients4`` against the JAX ``CreamflServer`` single-device run at
  ``test_torch_port_creamfl.py``'s round tolerances.
* At ``--dropout 0.1`` the ``clients`` mesh, as two ``--dist_*``
  processes of two devices each, equals its 1-rank run bit for bit: the
  public draws do not depend on the layout.
* The route's log line on the model axis, the results' per-rank record,
  a rank's rows of a public batch, and padding clients that never step.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models.mat import tree_leaves
from fedcola_tpu_torch.parallel.mesh import MeshPlan, free_port

from test_torch_port_creamfl import N_PUB_BATCHES, P_LR, _flags
from test_torch_port_mesh import (DATASETS, MESHES, SGD, REPO, _evals,
                                  _jax_leaves, _local_loss, _loss,
                                  _npz_leaves)

R = 2
EMBED_DIM = 16               # mome_test16
# the distillation's AdamW steps: a pass over the public set a round
KEY_BIAS_BOUND = 2 * R * N_PUB_BATCHES * P_LR


def _line(d):
    return _flags(d) + SGD


def _cli(d, extra, devices=4, dist=None):
    cmd = [sys.executable, "-m", "fedcola_tpu_torch.main", *_line(d),
           *extra, "--device", "cpu"]
    if dist is not None:
        port, pid = dist
        cmd += ["--dist_coordinator", f"127.0.0.1:{port}",
                "--dist_num_processes", "2", "--dist_process_id", str(pid)]
    # a thread a rank: the four runs' sixteen ranks share the host
    return subprocess.Popen(
        cmd, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS=str(devices),
                                FEDCOLA_VIRTUAL_DEVICES=str(devices)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _results(d):
    res = json.load(open(d / "r" / "FedCola.json"))
    return {r: res[str(r)] for r in range(1, R + 1)}, res.get("mesh")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Results and final weights of the JAX single-device run, the port's
    1-rank run and its three meshes, all from the JAX initial weights (a
    round-0 port checkpoint, which the entry point resumes from); and of
    the port's 1-rank and ``clients`` mesh runs at ``--dropout 0.1`` from
    the seed's weights.  The mesh runs start first, in subprocesses, so
    that they overlap the in-process ones."""
    root = tmp_path_factory.mktemp("creamfl_mesh")
    jcfg = jconfig.parse_args(_line(root / "jax")
                              + ["--no_pallas", "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    tcfg = tconfig.parse_args(_line(root / "one") + ["--device", "cpu"])
    tserver = tcreate(tcfg, tload(tcfg, np.random.RandomState(tcfg.seed)))
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])
    tserver.save_checkpoint(str(root / "one" / "r" / "FedCola" / "ckpt"))
    procs = {}
    for tag, mesh in MESHES.items():
        shutil.copytree(root / "one" / "r", root / tag / "r")
        procs[tag] = [_cli(root / tag, mesh)]
    port = free_port()
    procs["drop_clients4"] = [
        _cli(root / "drop_clients4", ["--dropout", "0.1", "--mesh_shape",
                                      "4"], 2, (port, pid))
        for pid in range(2)]
    for r in range(1, R + 1):
        jserver.round = r
        jserver.update()
        jserver.evaluate([])
    out = {"jax": ({r: jserver.results[r] for r in range(1, R + 1)},
                   _jax_leaves(jserver))}
    for tag, extra in (("one", []), ("drop_one", ["--dropout", "0.1"])):
        server = tmain.main(_line(root / tag) + extra + ["--device", "cpu"])
        out[tag] = ({r: server.results[r] for r in range(1, R + 1)},
                    _npz_leaves(root / tag))
    for tag, ps in procs.items():
        logs = [p.communicate(timeout=300)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0, f"{tag} failed:\n{log[-4000:]}"
        res, mesh = _results(root / tag)
        out[tag] = (res, _npz_leaves(root / tag))
        out[tag + "_mesh"] = mesh
        out[tag + "_log"] = logs[0]
    return out


def _assert_leaves_close(leaves, ref, rtol, atol, key_bound):
    """Every leaf within ``rtol`` / ``atol``; the key third of the
    distilled (Coco) model's ``qkv_bias`` within ``key_bound``."""
    assert set(leaves) == set(ref)
    D = EMBED_DIM
    for k in ref:
        got, want = leaves[k], ref[k]
        if k[0] == "Coco" and k[1].endswith("qkv.bias"):
            key = np.abs(got[..., D:2 * D] - want[..., D:2 * D]).max()
            assert key <= key_bound, (k, key)
            got = np.concatenate([got[..., :D], got[..., 2 * D:]], -1)
            want = np.concatenate([want[..., :D], want[..., 2 * D:]], -1)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=str(k))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_creamfl_mesh_matches_one_rank(runs, mesh):
    ores, oleaves = runs["one"]
    res, leaves = runs[mesh]
    for r in range(1, R + 1):
        assert abs(_loss(res, r) - _loss(ores, r)) \
            <= 1e-4 * abs(_loss(ores, r)), (r, _loss(res, r), _loss(ores, r))
        assert abs(_local_loss(res, r) - _local_loss(ores, r)) \
            <= 1e-4 * abs(_local_loss(ores, r))
        assert _evals(res, r) == _evals(ores, r), r
        # the top-level sections (the undotted span names), the round's
        # central evaluation among them
        assert {k for k in res[r]["round_sections"] if "." not in k} == \
            {"pub_logit", "train", "aggregate", "distill", "eval"}
    _assert_leaves_close(leaves, oleaves, 2e-5, 2e-6, KEY_BIAS_BOUND)


def test_creamfl_clients_mesh_matches_jax_single_device(runs):
    """``clients4`` against the JAX server: the training loss within 1e-5
    relative a round, every leaf within 1e-4 * max(1, max|ref|)."""
    jres, jleaves = runs["jax"]
    res, leaves = runs["clients4"]
    for r in range(1, R + 1):
        assert abs(_loss(res, r) - _loss(jres, r)) \
            <= 1e-5 * abs(_loss(jres, r)), (r, _loss(res, r), _loss(jres, r))
        assert abs(_local_loss(res, r) - _local_loss(jres, r)) \
            <= 1e-5 * abs(_local_loss(jres, r))
    assert set(leaves) == set(jleaves)
    D = EMBED_DIM
    for k, ref in jleaves.items():
        got = leaves[k]
        if k[0] == "Coco" and k[1].endswith("qkv.bias"):
            key = np.abs(got[..., D:2 * D] - ref[..., D:2 * D]).max()
            assert key <= KEY_BIAS_BOUND, (k, key)
            got = np.concatenate([got[..., :D], got[..., 2 * D:]], -1)
            ref = np.concatenate([ref[..., :D], ref[..., 2 * D:]], -1)
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), (k, err)


def test_creamfl_clients_mesh_with_dropout_is_bit_for_bit(runs):
    """At ``--dropout 0.1`` two ``--dist_*`` processes of a 4-rank
    ``clients`` mesh train the 1-rank run's weights bit for bit (on the CPU
    one client alone gives the bits of the stack), with its training
    losses and central results; without the draws the run is another one.
    The clients' holdout loss is the one figure a mesh computes otherwise:
    its eval rows split over the four ranks, a forward over a quarter of
    the rows rounds its products apart in the last bits."""
    ores, oleaves = runs["drop_one"]
    res, leaves = runs["drop_clients4"]
    for r in range(1, R + 1):
        assert _loss(res, r) == _loss(ores, r), r
        assert _evals(res, r) == _evals(ores, r), r
        assert abs(_local_loss(res, r) - _local_loss(ores, r)) \
            <= 1e-6 * abs(_local_loss(ores, r)), r
    assert set(leaves) == set(oleaves)
    for k in oleaves:
        np.testing.assert_array_equal(leaves[k], oleaves[k], err_msg=str(k))
    nres, _ = runs["one"]
    assert all(_loss(nres, r) != _loss(ores, r) for r in range(1, R + 1))


def test_creamfl_mesh_logs_its_route(runs):
    """Each run names CreamFL's layout; on the model axis the public steps
    and the extraction run on shards (mome_test16: 2 heads, hidden 64 and
    120 words divide the axis)."""
    assert "4 of 8 public rows a rank" in runs["clients2xdata2_log"]
    assert "client blocks; the public features are all-gathered" \
        in runs["clients4_log"]
    log = runs["clients2xmodel2_log"]
    assert "[MESH] CreamFL: the public steps and the feature extraction " \
        "run each group's client blocks" in log
    assert "on the rank's shards of the model axis" in log
    for ds in DATASETS:
        assert f"[MESH] model axis 2, {ds}: attention by head (1 of 2 a " \
            "rank), MLP hidden 32 of 64 a rank" in log


def test_creamfl_mesh_records_its_ranks(runs):
    for tag, shape in (("clients4", {"clients": 4}),
                       ("clients2xdata2", {"clients": 2, "data": 2}),
                       ("clients2xmodel2", {"clients": 2, "model": 2}),
                       ("drop_clients4", {"clients": 4})):
        m = runs[tag + "_mesh"]
        assert m["mesh"] == shape and m["backend"] == "gloo"
        assert [s["rank"] for s in m["ranks"]] == [0, 1, 2, 3]
        # every rank staged the public set beside the task data
        assert len({s["staged_bytes"] for s in m["ranks"]}) == 1
        assert all(len(s["round_seconds"]) == R for s in m["ranks"])


def test_rank_rows_of_a_public_batch():
    """A public batch is the same for every client: a data rank takes its
    rows of it when they divide the axis, else the whole batch."""
    x = torch.arange(8 * 3).reshape(8, 3)
    for rank in range(4):
        p = MeshPlan((2, 2), ("clients", "data"), rank=rank)
        half = rank % 2
        assert torch.equal(p.batch_block(x), x[4 * half:4 * half + 4])
        assert torch.equal(p.batch_block(x[:5]), x[:5])
    assert torch.equal(MeshPlan().batch_block(x), x)
    assert torch.equal(MeshPlan((4,), ("clients",), rank=3).batch_block(x),
                       x)


@pytest.mark.parametrize("rank", [0, 2])
def test_padding_clients_never_step_in_a_public_pass(tmp_path, rank):
    """On a 4-rank ``clients`` mesh a group of two leaves ranks 2 and 3
    with a padding client each: its public pass moves neither its weights
    nor its optimizer state, while rank 0's client steps once a batch."""
    cfg = tconfig.parse_args(_line(tmp_path) + ["--device", "cpu"])
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    server._generate_public_logit()
    ds = "AG_NEWS"
    ids = [i for i in range(server.data.K)
           if server.client_dataset_of[i] == ds]
    assert len(ids) == 2
    server.plan = MeshPlan((4,), ("clients",), rank=rank)
    g = server._open_group(ds, ids)
    before = [t.detach().clone() for t in tree_leaves(g.stacked)]
    server._public_epoch(g)
    after = tree_leaves(g.stacked)
    steps = {int(t.max()) for t in tree_leaves(g.opt_state["t"])}
    moved = any(not torch.equal(a, b) for a, b in zip(after, before))
    if rank == 0:
        assert moved and steps == {0, N_PUB_BATCHES}   # heads frozen
    else:
        assert not moved and steps == {0}
