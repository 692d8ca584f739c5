"""Multi-process runs of the port (``--dist_coordinator`` /
``--dist_num_processes`` / ``--dist_process_id``), the dry run and entry
of ``fedcola_tpu_torch/graft_entry.py``, ``--wandb``, and the kernel build
lock, on the CPU.

* Two ``--dist_*`` processes of two virtual devices each
  (``FEDCOLA_VIRTUAL_DEVICES=2``, gloo) run the same tiny FedAvg
  experiment as one process of four, on the default 1-D ``clients`` mesh
  and on a 2 x 2 ``clients x data`` mesh, and a FedAdam run on the 2 x 2
  mesh: final weights within rtol 5e-3 / atol 2e-3, round losses within
  1e-4 (``tests/test_multiprocess.py``'s tolerances, AdamW).
* A resume where the processes see checkpoints of different rounds fails
  in every process.
* ``dryrun_multichip(4, device="cpu")`` runs one resident group update on
  a 2 x 2 mesh of virtual CPU devices (the card is its default), and
  ``dryrun_multichip(8, device="cpu")`` on the JAX dry run's 2 x 2 x 2
  ``clients x data x model`` mesh; ``entry(device="cpu")`` runs the flagship
  forward through the plain kernels, with the output shapes of the JAX
  ``entry()``.
* ``--wandb`` without wandb writes the same metrics JSONL as a run
  without it; with a stub ``wandb`` it is called as root ``main.py``
  calls it.
* The kernel build lock: of two builds that start together, one compiles
  and the other finds the library built.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_multiprocess.py's experiment at the port's test-size model,
# two local steps a client (--debug)
FLAGS = [
    "--exp_name", "mp", "--multi-task", "--seed", "5",
    "--datasets", "MedicalAbstracts", "MedicalAbstracts",
    "--modalities", "txt", "txt", "--Ks", "4", "--Cs", "1.0",
    "--test_size", "-1", "--split_type", "iid",
    "--model_name", "mome_test16_patch16_32", "--algorithm", "fedavg",
    "--eval_type", "global", "--eval_every", "2", "--R", "2", "--E", "1",
    "--B", "8", "--optimizer", "AdamW", "--lr", "1e-3",
    "--seq_len", "12", "--vocab_size", "80", "--dropout", "0",
    "--compute_dtype", "float32", "--equal_sampled", "--synthetic_data",
    "--debug", "--device", "cpu"]
CASES = {
    "clients4": [],
    "clients2xdata2": ["--mesh_shape", "2", "2",
                       "--mesh_axes", "clients", "data"],
    "fedadam_clients2xdata2": ["--algorithm", "fedadam", "--mesh_shape",
                               "2", "2", "--mesh_axes", "clients", "data"],
}


def _cli(out, extra=(), devices=2, dist=None):
    """``python -m fedcola_tpu_torch.main`` on FLAGS, started; ``dist``:
    ``(port, process_id)`` of a two-process run."""
    cmd = [sys.executable, "-m", "fedcola_tpu_torch.main", *FLAGS, *extra,
           "--result_path", f"{out}/result", "--log_path", f"{out}/log"]
    if dist is not None:
        port, pid = dist
        cmd += ["--dist_coordinator", f"127.0.0.1:{port}",
                "--dist_num_processes", "2", "--dist_process_id", str(pid)]
    env = dict(os.environ, FEDCOLA_VIRTUAL_DEVICES=str(devices))
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs, timeout=300):
    """Every process's (returncode, output); a process still running when
    another failed is killed (it would wait on its peer)."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    return [(p.wait(), p.communicate()[0]) for p in procs]


@pytest.fixture(scope="module")
def case_runs(tmp_path_factory):
    """Each case as two processes x 2 devices and as one process x 4, the
    three commands of a case started together."""
    root = tmp_path_factory.mktemp("multiprocess")
    done = {}
    for tag, extra in CASES.items():
        port = free_port()
        mp, sp = root / tag / "mp", root / tag / "sp"
        procs = [_cli(mp, extra, 2, (port, pid)) for pid in range(2)]
        procs.append(_cli(sp, extra, 4))
        for i, (rc, log) in enumerate(_finish(procs)):
            assert rc == 0, f"{tag} process {i} failed:\n{log[-4000:]}"
        done[tag] = (mp / "result", sp / "result")
    return done


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_one(case_runs, case):
    mp, sp = case_runs[case]
    z2 = np.load(mp / "mp" / "MedicalAbstracts.npz")
    z1 = np.load(sp / "mp" / "MedicalAbstracts.npz")
    assert set(z1.files) == set(z2.files)
    for k in z1.files:
        if not k.startswith("__"):
            np.testing.assert_allclose(z2[k], z1[k], rtol=5e-3, atol=2e-3,
                                       err_msg=k)
    r2 = json.load(open(mp / "mp.json"))
    r1 = json.load(open(sp / "mp.json"))
    assert r2["mesh"]["mesh"] == r1["mesh"]["mesh"]
    assert len(r2["mesh"]["ranks"]) == 4
    for rnd in ("1", "2"):
        l2 = r2[rnd]["clients_updated_summary"]["loss"]["avg"]
        l1 = r1[rnd]["clients_updated_summary"]["loss"]["avg"]
        assert abs(l2 - l1) < 1e-4, (rnd, l2, l1)
    e2 = r2["2"]["server_evaluated_MedicalAbstracts"]["loss"]
    e1 = r1["2"]["server_evaluated_MedicalAbstracts"]["loss"]
    assert abs(e2 - e1) < 1e-4


def test_resume_with_mismatched_rounds_fails(tmp_path):
    """Process 0 finds a checkpoint at round 1, process 1 none (a
    result path the other cannot see): both stop with the mismatch."""
    cfg = tconfig.parse_args(FLAGS)
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    server.round = 1
    server.save_checkpoint(str(tmp_path / "a" / "result" / "mp" / "ckpt"))
    port = free_port()
    procs = [_cli(tmp_path / d, (), 1, (port, pid))
             for pid, d in enumerate(("a", "b"))]
    for rc, log in _finish(procs):
        assert rc != 0
        assert "mesh resume mismatch" in log, log[-3000:]


# ------------------------------------------------------- graft entry ----

def test_dryrun_multichip_on_four_virtual_devices(capfd):
    from fedcola_tpu_torch.graft_entry import dryrun_multichip
    result = dryrun_multichip(4, device="cpu")
    assert result["mesh"] == {"clients": 2, "data": 2}
    assert result["backend"] == "gloo" and np.isfinite(result["loss"])
    assert sorted(result["launches"]) == [0, 1, 2, 3]
    assert "dryrun_multichip OK: mesh={'clients': 2, 'data': 2} on cpu" in \
        capfd.readouterr().out
    # the card is the default: without one it refuses rather than fall
    # back to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)


def test_dryrun_multichip_on_eight_virtual_devices_adds_the_model_axis(
        capfd):
    from fedcola_tpu_torch.graft_entry import dryrun_multichip
    result = dryrun_multichip(8, device="cpu")
    assert result["mesh"] == {"clients": 2, "data": 2, "model": 2}
    assert result["backend"] == "gloo" and np.isfinite(result["loss"])
    assert sorted(result["launches"]) == list(range(8))
    assert "mesh={'clients': 2, 'data': 2, 'model': 2} on cpu" in \
        capfd.readouterr().out


def test_entry_runs_on_the_cpu_with_the_jax_shapes():
    import jax
    import torch

    from fedcola_tpu_torch.graft_entry import entry
    sys.path.insert(0, REPO)
    import __graft_entry__ as jentry

    fn, args = entry(device="cpu")
    fi, ft = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.eval_shape(jfn, *jargs)
    assert [tuple(f.shape) for f in (fi, ft)] == \
        [tuple(w.shape) for w in want]
    for f in (fi, ft):
        assert torch.isfinite(f).all()
        np.testing.assert_allclose(f.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


# ------------------------------------------------------------- wandb ----

def _tiny_run(tmp_path, *extra):
    flags = list(FLAGS)
    flags[flags.index("--R") + 1] = "1"
    flags[flags.index("--eval_every") + 1] = "1"
    tmain.main(flags + list(extra) + ["--result_path", str(tmp_path / "r"),
                                      "--log_path", str(tmp_path / "l")])
    return (tmp_path / "r" / "mp_metrics.jsonl").read_bytes()


def test_wandb_absent_writes_the_same_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    plain = _tiny_run(tmp_path / "plain")
    flagged = _tiny_run(tmp_path / "flagged", "--wandb")
    assert plain and flagged == plain


def test_wandb_stub_is_called_as_root_main_calls_it(tmp_path,
                                                         monkeypatch):
    calls = []

    class Stub:
        def init(self, **kw):
            calls.append(("init", kw))

        def log(self, payload, step):
            calls.append(("log", dict(payload), step))

        def finish(self):
            calls.append(("finish",))

    monkeypatch.setitem(sys.modules, "wandb", Stub())
    jsonl = [json.loads(line) for line in
             _tiny_run(tmp_path, "--wandb").decode().splitlines()]
    assert calls[0] == ("init", {"project": "fedcola_tpu", "name": "mp",
                                 "config": None})
    assert calls[-1] == ("finish",)
    logged = [c for c in calls if c[0] == "log"]
    assert [{"round": step, **payload} for _, payload, step in logged] == \
        jsonl


# ------------------------------------------------------ kernel build ----

def test_kernel_build_lock_builds_once(tmp_path, monkeypatch):
    """Two builds at once (threads hold separate lock descriptors, as
    processes do): one compiles while the other waits, then finds the
    library up to date."""
    lib = tmp_path / "libfedcola_kernels.so"
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "LIB_PATH", lib)
    compiles = []

    def fake_compile():
        compiles.append(threading.get_ident())
        time.sleep(0.3)
        lib.write_bytes(b"built")
        return 0.3

    monkeypatch.setattr(kernels, "_compile", fake_compile)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(kernels.ensure_built()))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(results) == [False, True] and len(compiles) == 1
    assert (tmp_path / "build.lock").exists()
