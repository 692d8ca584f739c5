"""The port's device mesh (``fedcola_tpu_torch/parallel/mesh.py``) on the
CPU: gloo ranks on ``FEDCOLA_VIRTUAL_DEVICES`` virtual devices, the
``scripts/coco.sh`` FedCola line at ``mome_test16_patch16_32`` (float32,
dropout 0, SGD, ``--eval_type both --test_size 0.2``), two rounds.

* Against the JAX package: from the JAX server's initial weights (a
  round-0 port checkpoint, which the entry point resumes from), a 4-rank
  ``clients`` mesh, a 2 x 2 ``clients x data`` mesh and a 2 x 2 ``clients
  x model`` mesh (Megatron tensor parallelism) run through
  ``python -m fedcola_tpu_torch.main`` match the in-process JAX
  single-device run: round losses and the clients' holdout losses within
  1e-5 relative, acc1 (central and holdout) and r@1sum equal, every leaf
  within atol 1e-4 / rtol 1e-3.
* Layout invariance in the port: the 1-rank run and every mesh run agree
  on every leaf at rtol 2e-5 / atol 2e-6 (``tests/test_mesh.py``'s
  tolerance under SGD), losses within 1e-4, acc1 equal.
* The same at ``--dropout 0.1`` with ``--crop`` / ``--randhf`` (the draws
  do not depend on the layout): the 4-rank run equals the 1-rank run bit
  for bit, the 2 x 2 runs within 2e-5 / 2e-6.
* FedProx on the 2 x 2 ``clients x model`` mesh against its 1-rank run at
  rtol 2e-5 / atol 2e-6.
* ``--wandb`` under a mesh: only rank 0 writes (a stub ``wandb`` on the
  ranks' path records its calls).
* ``MeshPlan``'s rules (``tests/test_mesh.py``), the ``model`` axis and
  CreamFL under a mesh accepted, the ``model`` axis's rank layout, the
  refusal of a mesh configuration without a joined plan, the rank's block
  of a chunk and of a draw.
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
from fedcola_tpu_torch.parallel.mesh import MeshPlan, RankDraws, plan_launch

from test_torch_port_round import FEDCOLA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ("CIFAR100", "AG_NEWS", "Coco")
# SGD, and the clients' holdout evaluation beside the central one
SGD = ["--optimizer", "SGD", "--lr", "1e-2", "--eval_type", "both",
       "--test_size", "0.2"]
MESHES = {"clients4": ["--mesh_shape", "4"],
          "clients2xdata2": ["--mesh_shape", "2", "2",
                             "--mesh_axes", "clients", "data"],
          "clients2xmodel2": ["--mesh_shape", "2", "2",
                              "--mesh_axes", "clients", "model"]}
# the line under FedProx at the largest mu of the FedProx paper's grid: the
# proximal term's gradient of the replicated leaves whose gradients the
# model ranks sum must count once
PROX = ["--algorithm", "fedprox", "--mu", "1"]

WANDB_STUB = '''
import json, os
_LOG = os.path.join(os.environ["WANDB_STUB_DIR"], f"calls_{os.getpid()}.jsonl")
def _rec(_call, *a, **k):
    with open(_LOG, "a") as f:
        f.write(json.dumps({"call": _call, "args": [str(x) for x in a],
                            "kwargs": {n: str(v) for n, v in k.items()}})
                + "\\n")
def init(*a, **k): _rec("init", *a, **k)
def log(*a, **k): _rec("log", *a, **k)
def finish(*a, **k): _rec("finish", *a, **k)
'''


def _out(d):
    return ["--result_path", str(d / "r"), "--log_path", str(d / "l")]


def _write_round0_checkpoint(jserver, d):
    """The JAX server's initial weights as a round-0 port checkpoint under
    ``d``'s result path, where the entry point resumes from it."""
    cfg = tconfig.parse_args(FEDCOLA + SGD + _out(d) + ["--device", "cpu"])
    tserver = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p),
            cfg=tserver.model_cfgs[ds])
    tserver.save_checkpoint(str(d / "r" / "FedCola" / "ckpt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Results and final weights of the JAX single-device run and of the
    port's 1-rank, 4-rank and 2 x 2 runs, all from the JAX initial
    weights.  The mesh runs go through the CLI in subprocesses, started
    before the JAX run so that they overlap it."""
    root = tmp_path_factory.mktemp("mesh")
    jcfg = jconfig.parse_args(FEDCOLA + SGD + _out(root / "jax")
                              + ["--no_pallas", "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    _write_round0_checkpoint(jserver, root / "one")
    stub = root / "stub"
    (stub / "wandb").mkdir(parents=True)
    (stub / "wandb" / "__init__.py").write_text(WANDB_STUB)
    procs = {}
    for tag, mesh in MESHES.items():
        shutil.copytree(root / "one" / "r", root / tag / "r")
        env = dict(os.environ, FEDCOLA_VIRTUAL_DEVICES="4",
                   PYTHONPATH=os.pathsep.join([str(stub), REPO]),
                   WANDB_STUB_DIR=str(stub))
        extra = ["--wandb"] if tag == "clients4" else []
        procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "fedcola_tpu_torch.main", *FEDCOLA, *SGD,
             *mesh, *extra, "--device", "cpu", *_out(root / tag)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    procs["prox_clients2xmodel2"] = subprocess.Popen(
        [sys.executable, "-m", "fedcola_tpu_torch.main", *FEDCOLA, *SGD,
         *PROX, *MESHES["clients2xmodel2"], "--device", "cpu",
         *_out(root / "prox_clients2xmodel2")],
        cwd=REPO, env=dict(os.environ, FEDCOLA_VIRTUAL_DEVICES="4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for r in (1, 2):
        jserver.round = r
        jserver.update()
        jserver.evaluate([])
    one = tmain.main(FEDCOLA + SGD + ["--device", "cpu"] + _out(root / "one"))
    out = {"jax": ({r: jserver.results[r] for r in (1, 2)},
                   _jax_leaves(jserver)),
           "one": ({r: one.results[r] for r in (1, 2)},
                   _npz_leaves(root / "one"))}
    prox = tmain.main(FEDCOLA + SGD + PROX + ["--device", "cpu"]
                      + _out(root / "prox_one"))
    out["prox_one"] = ({r: prox.results[r] for r in (1, 2)},
                       _npz_leaves(root / "prox_one"))
    for tag, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, f"{tag} failed:\n{log[-4000:]}"
        res = json.load(open(root / tag / "r" / "FedCola.json"))
        out[tag] = ({r: res[str(r)] for r in (1, 2)},
                    _npz_leaves(root / tag))
        out[tag + "_mesh"] = res["mesh"]
    out["root"] = root
    return out


def _jax_leaves(server):
    """The JAX server's final weights under the reference names."""
    from fedcola_tpu.models import naming
    return {(ds, name): np.asarray(naming.get_by_path(
                server.global_params[ds], p))
            for ds in DATASETS
            for p, name in naming.param_names(server.model_cfgs[ds])}


def _npz_leaves(d):
    """The final weights a run's ``finalize`` wrote (rank 0)."""
    out = {}
    for ds in DATASETS:
        with np.load(d / "r" / "FedCola" / f"{ds}.npz") as z:
            assert int(z["__round__"]) == 2
            out.update({(ds, k): z[k] for k in z.files
                        if not k.startswith("__")})
    return out


def _loss(res, r):
    return res[r]["clients_updated_summary"]["loss"]["avg"]


def _evals(res, r):
    return ([res[r][f"server_evaluated_{ds}"]["metrics"]["acc1"]
             for ds in ("CIFAR100", "AG_NEWS")]
            + [res[r]["server_evaluated_Coco"]["Coco r@1sum"]]
            + [res[r]["clients_evaluated_out"]["acc1"]["avg"]])


def _local_loss(res, r):
    return res[r]["clients_evaluated_out"]["loss"]["avg"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_run_matches_jax_single_device(runs, mesh):
    jres, jleaves = runs["jax"]
    res, leaves = runs[mesh]
    for r in (1, 2):
        assert abs(_loss(res, r) - _loss(jres, r)) \
            <= 1e-5 * abs(_loss(jres, r)), (r, _loss(res, r), _loss(jres, r))
        assert _evals(res, r) == _evals(jres, r), r
        assert abs(_local_loss(res, r) - _local_loss(jres, r)) \
            <= 1e-5 * abs(_local_loss(jres, r))
    assert set(leaves) == set(jleaves)
    for k in jleaves:
        np.testing.assert_allclose(leaves[k], jleaves[k], atol=1e-4,
                                   rtol=1e-3, err_msg=str(k))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_run_matches_one_rank(runs, mesh):
    ores, oleaves = runs["one"]
    res, leaves = runs[mesh]
    for r in (1, 2):
        assert abs(_loss(res, r) - _loss(ores, r)) < 1e-4
        assert abs(_local_loss(res, r) - _local_loss(ores, r)) < 1e-4
        assert _evals(res, r) == _evals(ores, r), r
    for k in oleaves:
        np.testing.assert_allclose(leaves[k], oleaves[k], rtol=2e-5,
                                   atol=2e-6, err_msg=str(k))


def test_fedprox_model_axis_run_matches_one_rank(runs):
    """FedProx on a 2 x 2 ``clients x model`` mesh equals its 1-rank run
    at the mesh tolerance."""
    ores, oleaves = runs["prox_one"]
    res, leaves = runs["prox_clients2xmodel2"]
    for r in (1, 2):
        assert abs(_loss(res, r) - _loss(ores, r)) < 1e-4
        assert abs(_local_loss(res, r) - _local_loss(ores, r)) < 1e-4
        assert _evals(res, r) == _evals(ores, r), r
    assert set(leaves) == set(oleaves)
    for k in oleaves:
        np.testing.assert_allclose(leaves[k], oleaves[k], rtol=2e-5,
                                   atol=2e-6, err_msg=str(k))


# DropPath / dropout at 0.1 (the [main] line's) and the resident plane's
# device augmentation: every rank draws the whole group's tensors and keeps
# its block, so the draws do not depend on the layout
DRAWS = ["--dropout", "0.1", "--crop", "32", "--randhf", "0.5"]


@pytest.fixture(scope="module")
def draw_runs(tmp_path_factory):
    """Results and final weights of the port's 1-rank, 4-rank and 2 x 2
    runs with ``DRAWS`` (and of the 1-rank run without them), from the
    seed's initial weights."""
    root = tmp_path_factory.mktemp("mesh_draws")
    procs = {}
    for tag, mesh in MESHES.items():
        env = dict(os.environ, FEDCOLA_VIRTUAL_DEVICES="4")
        procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "fedcola_tpu_torch.main", *FEDCOLA, *SGD,
             *DRAWS, *mesh, "--device", "cpu", *_out(root / tag)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for tag, extra in (("one", DRAWS), ("no_draws", [])):
        server = tmain.main(FEDCOLA + SGD + extra + ["--device", "cpu"]
                            + _out(root / tag))
        out[tag] = ({r: server.results[r] for r in (1, 2)},
                    _npz_leaves(root / tag))
    for tag, p in procs.items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, f"{tag} failed:\n{log[-4000:]}"
        res = json.load(open(root / tag / "r" / "FedCola.json"))
        out[tag] = ({r: res[str(r)] for r in (1, 2)},
                    _npz_leaves(root / tag))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_run_with_dropout_and_augmentation_matches_one_rank(draw_runs,
                                                                 mesh):
    """At ``--dropout 0.1`` with ``--crop`` / ``--randhf`` the 4-rank and
    2 x 2 runs equal the 1-rank run: the clients mesh bit for bit (on the
    CPU one client alone gives the bits of the stack), the data and model
    meshes within their reassociated sums (rtol 2e-5 / atol 2e-6)."""
    ores, oleaves = draw_runs["one"]
    res, leaves = draw_runs[mesh]
    for r in (1, 2):
        assert _evals(res, r) == _evals(ores, r), r
        if mesh == "clients4":
            assert _loss(res, r) == _loss(ores, r), r
            assert _local_loss(res, r) == _local_loss(ores, r), r
        assert abs(_loss(res, r) - _loss(ores, r)) \
            <= 2e-5 * abs(_loss(ores, r)), (r, _loss(res, r), _loss(ores, r))
        assert abs(_local_loss(res, r) - _local_loss(ores, r)) \
            <= 2e-5 * abs(_local_loss(ores, r))
    for k in oleaves:
        if mesh == "clients4":
            np.testing.assert_array_equal(leaves[k], oleaves[k],
                                          err_msg=str(k))
        np.testing.assert_allclose(leaves[k], oleaves[k], rtol=2e-5,
                                   atol=2e-6, err_msg=str(k))
    # the draws were taken: without them the run is another one
    nres, _ = draw_runs["no_draws"]
    assert all(_loss(nres, r) != _loss(ores, r) for r in (1, 2))


def test_mesh_run_records_its_ranks(runs):
    """The results JSON of a mesh run names its layout and backend and
    holds each rank's figures; every rank staged the datasets."""
    for tag, shape in (("clients4", {"clients": 4}),
                       ("clients2xdata2", {"clients": 2, "data": 2}),
                       ("clients2xmodel2", {"clients": 2, "model": 2})):
        m = runs[tag + "_mesh"]
        assert m["mesh"] == shape and m["backend"] == "gloo"
        assert [s["rank"] for s in m["ranks"]] == [0, 1, 2, 3]
        for s in m["ranks"]:
            assert s["device"] == "cpu" and s["staged_bytes"] > 0
            assert len(s["round_seconds"]) == 2


def test_wandb_under_a_mesh_writes_on_rank_0_only(runs):
    """The 4-rank run had ``--wandb`` and a stub ``wandb`` on its path:
    one process called it, as root ``main.py`` does, and the metrics JSONL
    holds each logged payload once."""
    stub = runs["root"] / "stub"
    logs = sorted(stub.glob("calls_*.jsonl"))
    assert len(logs) == 1
    calls = [json.loads(line) for line in open(logs[0])]
    assert calls[0] == {"call": "init", "args": [], "kwargs": {
        "project": "fedcola_tpu", "name": "FedCola", "config": "None"}}
    assert calls[-1]["call"] == "finish"
    logged = [c for c in calls if c["call"] == "log"]
    lines = open(runs["root"] / "clients4" / "r"
                 / "FedCola_metrics.jsonl").read().splitlines()
    assert len(lines) == len(logged) > 0
    assert [json.loads(l)["round"] for l in lines] == \
        [int(c["kwargs"]["step"]) for c in logged]


# --------------------------------------------------------------- plan ----

def test_meshplan_validation():
    """``tests/test_mesh.py``'s rules of ``MeshPlan.build``."""
    with pytest.raises(ValueError, match="include 'clients'"):
        MeshPlan.build([8], ["data"], n_visible=8)
    with pytest.raises(ValueError, match="does not match"):
        MeshPlan.build([4, 2], ["clients", "data", "extra"], n_visible=8)
    with pytest.raises(ValueError, match="needs 64 devices but only 8"):
        MeshPlan.build([64], ["clients"], n_visible=8)
    with pytest.raises(ValueError, match="requires --mesh_shape"):
        MeshPlan.build(None, ["clients", "data"], n_visible=8)
    # default axes fill in for multi-dimensional shapes
    p = MeshPlan.build([4, 2], n_visible=8)
    assert p.mesh_dict == {"clients": 4, "data": 2}
    assert (p.n_devices, p.clients_axis, p.data_axis, p.model_axis) == \
        (8, 4, 2, 1)
    assert MeshPlan.build([1], n_visible=8).shape is None
    # no --mesh_shape: a 1-D clients mesh over every visible device
    assert MeshPlan.build(None, ["clients"], n_visible=3).mesh_dict == \
        {"clients": 3}
    assert MeshPlan.build(None, ["clients"], n_visible=1).shape is None


def test_model_axis_and_creamfl_under_a_mesh_are_refused(monkeypatch):
    """Neither is refused any longer: the ``model`` axis builds, and so
    does CreamFL under a mesh (its runs:
    ``tests/test_torch_port_creamfl_mesh.py``).  The name is the one the
    test had when both were refused."""
    assert MeshPlan.build([2, 2], ["clients", "model"],
                          n_visible=4).model_axis == 2
    assert MeshPlan.build([2, 2, 2], n_visible=8).mesh_dict == \
        {"clients": 2, "data": 2, "model": 2}
    monkeypatch.setenv("FEDCOLA_VIRTUAL_DEVICES", "2")
    cfg = tconfig.parse_args(["--algorithm", "creamfl", "--device", "cpu",
                              "--mesh_shape", "2"])
    launch = plan_launch(cfg, "cpu")
    assert launch.plan.mesh_dict == {"clients": 2} and launch.local == 2
    # no --mesh_shape over two visible devices: a clients mesh, as FedAvg's
    cfg = tconfig.parse_args(["--algorithm", "creamfl", "--device", "cpu"])
    assert plan_launch(cfg, "cpu").plan.mesh_dict == {"clients": 2}
    # one visible device: no mesh, CreamFL runs as before
    monkeypatch.setenv("FEDCOLA_VIRTUAL_DEVICES", "1")
    assert plan_launch(tconfig.parse_args(["--algorithm", "creamfl",
                                           "--device", "cpu"]), "cpu") is None


def test_launch_layouts(monkeypatch):
    """One host: a rank per mesh device.  ``--dist_*``: each process owns
    its visible devices and the mesh must span them all."""
    monkeypatch.setenv("FEDCOLA_VIRTUAL_DEVICES", "2")
    one = plan_launch(tconfig.parse_args(["--device", "cpu"]), "cpu")
    assert one.world == 2 and one.local == 2 and one.first_rank == 0
    dist = ["--device", "cpu", "--dist_coordinator", "127.0.0.1:1234",
            "--dist_num_processes", "2", "--dist_process_id", "1"]
    second = plan_launch(tconfig.parse_args(dist + ["--mesh_shape", "2",
                                                    "2"]), "cpu")
    assert second.plan.mesh_dict == {"clients": 2, "data": 2}
    assert (second.first_rank, second.local) == (2, 2)
    assert second.init_method == "tcp://127.0.0.1:1234"
    with pytest.raises(ValueError, match="must span every process"):
        plan_launch(tconfig.parse_args(dist + ["--mesh_shape", "2"]), "cpu")


def test_server_refuses_a_mesh_without_a_joined_plan():
    cfg = tconfig.parse_args(FEDCOLA + ["--device", "cpu",
                                        "--mesh_shape", "2"])
    with pytest.raises(ValueError, match="fedcola_tpu_torch.main"):
        tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))


def test_rank_blocks_of_a_chunk():
    """A rank's clients of the padded stack (padding: zero rows, no step)
    and, on a data axis, its half of every batch."""
    n, S, B = 3, 2, 4
    chunk = {"idx": np.arange(n * S * B, dtype=np.int32).reshape(n, S, B),
             "valid": np.ones((n, S, B), bool),
             "step_valid": np.ones((n, S), bool)}
    plan = MeshPlan((2, 2), ("clients", "data"), rank=3)
    assert plan.pad_clients(n) == 4 and plan.client_rows(n) == slice(2, 4)
    assert plan.batch_rows(B) == slice(2, 4)
    assert not plan.splits_batch(5) and plan.batch_rows(5) == slice(0, 5)
    local = plan.local_chunk(chunk)
    np.testing.assert_array_equal(local["idx"][0], chunk["idx"][2][:, 2:])
    assert not local["step_valid"][1].any() and not local["valid"][1].any()
    assert local["step_valid"].shape == (2, S)
    assert MeshPlan((3,), ("clients",)).pad_eval_batch(7) == 9


def test_three_axis_rank_layout():
    """``rank = (ci * d + di) * m + mi``, as ``np.reshape`` lays out
    ``[c, d, m]``: a rank's clients block, batch rows and model index; the
    model ranks of one block and rows keep the same draws."""
    from fedcola_tpu_torch.models.mat import MATConfig
    cfg = MATConfig(embed_dim=16, num_heads=2, vocab_size=40)
    n, B = 3, 4
    for rank in range(8):
        p = MeshPlan((2, 2, 2), ("clients", "data", "model"), rank=rank)
        ci, di, mi = np.unravel_index(rank, (2, 2, 2))
        assert p.client_rows(n) == slice(2 * ci, 2 * ci + 2)
        assert p.batch_rows(B) == slice(2 * di, 2 * di + 2)
        tp = p.tensor_parallel(cfg)
        assert (tp.size, tp.index) == (2, mi)
        d = p.draws(torch.Generator().manual_seed(7), n, B)
        peer = MeshPlan(p.shape, p.axes, rank=rank ^ 1)   # other model index
        e = peer.draws(torch.Generator().manual_seed(7), n, B)
        assert torch.equal(d.rand((2, 2, 5), "cpu"), e.rand((2, 2, 5), "cpu"))
    assert MeshPlan((2, 2), ("clients", "data")).tensor_parallel(cfg) is None


def test_rank_draws_are_blocks_of_the_whole_draw():
    """Each rank's draws are its block of what one process draws from the
    same generator; the stream advances alike on every rank."""
    n, B = 3, 4
    whole = torch.rand((n, B, 5), generator=torch.Generator().manual_seed(7))
    plan = MeshPlan((2, 2), ("clients", "data"))
    for rank in range(4):
        p = MeshPlan(plan.shape, plan.axes, rank=rank)
        gen = torch.Generator().manual_seed(7)
        d = p.draws(gen, n, B)
        assert isinstance(d, RankDraws)
        rows, cols = p.client_rows(n), p.batch_rows(B)
        got = d.rand((rows.stop - rows.start, 2, 5), "cpu")
        want = torch.cat([whole, torch.zeros((1, B, 5))])[rows, cols]
        assert torch.equal(got, want)
        assert gen.get_state().equal(_state_after(n * B * 5))
    # without a mesh, the whole draw: the bits torch.rand gives
    d = MeshPlan().draws(torch.Generator().manual_seed(7), n, B)
    assert isinstance(d, RankDraws)
    assert torch.equal(d.rand((n, B, 5), "cpu"), whole)


def _state_after(k):
    g = torch.Generator().manual_seed(7)
    torch.rand(k, generator=g)
    return g.get_state()


def test_check_replicated_fails_on_diverged_ranks(monkeypatch):
    """Every rank aggregates the same gathered uploads; a rank whose copy
    of a global model differs by one bit stops the run."""
    from fedcola_tpu_torch.parallel import mesh
    plan = MeshPlan((2,), ("clients",), rank=0,
                    groups=mesh._Groups(None, None, None, "gloo", "", "cpu"))
    tree = {"a": torch.ones(3), "b": {"c": torch.arange(4.0)}}
    digest = torch.stack([mesh._bit_sum(torch.ones(3)),
                          sum(mesh._bit_sum(t) for t in (torch.arange(4.0),))])
    other = digest.clone()
    monkeypatch.setattr(mesh, "all_gather",
                        lambda x, group, dim=0: torch.cat([x, other[None]]))
    plan.check_replicated({"X": tree["a"], "Y": tree["b"]})
    other[1] += 1
    with pytest.raises(RuntimeError, match=r"different copies of \['Y'\]"):
        plan.check_replicated({"X": tree["a"], "Y": tree["b"]})

