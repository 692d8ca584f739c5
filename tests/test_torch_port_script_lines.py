"""The other script lines at full local length (whole shards, ``--E 2
--R 2``, no ``--debug``): the PyTorch port against the JAX server on the
CPU, both starting from the JAX weights, at ``mome_test16_patch16_32``
(float32, dropout 0; the MedMNIST lines are at their script's own size,
``mome_test_patch16_32``).

* ``scripts/flickr.sh`` (``main.FLICKR_FLAGS``: Flickr30k trains the
  img+txt clients, Coco only names the server's eval model, ``--C 0.25``)
  on ``flickr_fixture`` / ``coco_fixture`` roots;
* ``scripts/evidence_medmnist.sh``, both legs: ``--modalities ct ct`` on
  the full train set, and ``--reduce_samples -1
  --reduce_samples_cls_scale 0.5``, which loads half of it;
* ``scripts/evidence_medabstracts.sh`` (``--eval_metrics acc1 f1``) on CSVs
  written here.

Each round's results dicts hold the same keys (but for the port's own
``eval_seconds``) and the same values: losses within 1e-5 relative, every
metric equal.
"""

import numpy as np
import pytest

import jax

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.data import fixtures
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert

from test_torch_port_full_epochs import _untimed, one_torch_thread  # noqa: F401
from test_torch_port_long_seq import _write_medabstracts

R = 2
LENGTH = {"--E": "2", "--R": str(R)}
MEDMNIST_TRAIN, MEDMNIST_TEST = 440, 110

# scripts/evidence_medmnist.sh:26-32 (COMMON)
MEDMNIST = [
    "--multi-task", "--seed", "5", "--datasets", "MedMNIST", "MedMNIST",
    "--modalities", "ct", "ct", "--Ks", "4", "--Cs", "1.0",
    "--test_size", "-1", "--split_type", "iid",
    "--model_name", "mome_test_patch16_32", "--algorithm", "fedavg",
    "--eval_type", "global", "--eval_every", "2", "--R", "4", "--E", "1",
    "--B", "16", "--optimizer", "AdamW", "--lr", "1e-3", "--resize", "32",
    "--compute_dtype", "float32", "--equal_sampled"]
# scripts/evidence_medabstracts.sh:22-31
MEDABSTRACTS = [
    "--exp_name", "FedAVG_med", "--algorithm", "fedavg",
    "--shared_param", "none", "--share_scope", "dataset",
    "--colearn_param", "none", "--seed", "1", "--multi-task",
    "--datasets", "MedicalAbstracts", "MedicalAbstracts",
    "--modalities", "txt", "txt", "--Ks", "12", "--test_size", "-1",
    "--split_type", "diri", "--cncntrtn", "0.5",
    "--model_name", "mome_small_patch16", "--seq_len", "40",
    "--eval_type", "global", "--eval_every", "5",
    "--eval_metrics", "acc1", "f1", "--R", "10", "--C", "0.25", "--E", "5",
    "--B", "96", "--beta1", "0", "--optimizer", "AdamW", "--lr", "1e-4",
    "--lr_decay", "0.99", "--lr_decay_step", "1",
    "--criterion", "CrossEntropyLoss", "--equal_sampled",
    "--eval_batch_size", "512"]
# the test size of the mome_small lines
SMALL = {"--model_name": "mome_test16_patch16_32", "--B": "8",
         "--eval_batch_size": "128"}


def _flickr(d):
    return list(tmain.cut(tmain.flickr_flags(
        fixtures.flickr_fixture(str(d / "flickr"), 44, 12, 32),
        fixtures.coco_fixture(str(d / "coco"), 20, 12, 32),
        fixtures.cifar100_fixture(str(d / "cifar"), 800, 200),
        fixtures.agnews_fixture(str(d / "agnews"), 400, 100)),
        {**SMALL, **LENGTH, "--resize": "32", "--device": None,
         "--seq_len": "12", "--vocab_size": "120",
         "--compute_dtype": "float32", "--dropout": "0"}))


def _medmnist(d, *extra):
    root = fixtures.medmnist_fixture(str(d / "medmnist"), MEDMNIST_TRAIN,
                                     MEDMNIST_TEST)
    return list(tmain.cut(MEDMNIST, LENGTH)) + [
        "--data_paths", root, root, "--dropout", "0", *extra]


def _medabstracts(d):
    root = d / "medabstract"
    root.mkdir()
    _write_medabstracts(root, 300, 60, 50, seed=0)
    return list(tmain.cut(MEDABSTRACTS, {**SMALL, **LENGTH})) + [
        "--data_paths", str(root), str(root), "--dropout", "0",
        "--compute_dtype", "float32"]


LINES = {
    "flickr": _flickr,
    "medmnist_ct": _medmnist,
    "medmnist_cls_scale": lambda d: _medmnist(
        d, "--reduce_samples", "-1", "--reduce_samples_cls_scale", "0.5"),
    "medabstracts": _medabstracts,
}


def _assert_results(got, want, avg, path=()):
    """``got`` equals ``want``: the same keys, losses within 1e-5 relative
    (a spread of the clients' losses within 1e-5 of their average
    ``avg``), every other number equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_results(got[k], want[k], avg, path + (k,))
    elif "loss" in path and isinstance(want, float):
        scale = avg if path[-1].endswith("std") else want
        assert abs(got - want) <= 1e-5 * abs(scale), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("line", sorted(LINES))
def test_script_line_matches_jax_server(line, tmp_path):
    flags = LINES[line](tmp_path)
    assert "--debug" not in flags and "--synthetic_data" not in flags
    out = ["--result_path", str(tmp_path / "j"), "--log_path",
           str(tmp_path / "l")]
    jcfg = jconfig.parse_args(flags + out + ["--no_pallas",
                                             "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    out[1] = str(tmp_path / "t")
    tcfg = tconfig.parse_args(flags + out + ["--device", "cpu"])
    tdata = tload(tcfg, np.random.RandomState(tcfg.seed))
    tserver = tcreate(tcfg, tdata)
    assert tcfg.E == 2 and not tcfg.debug
    n_train = {ds: tdata.client_shards[i].dataset.n
               for i, ds in enumerate(tserver.client_dataset_of)}
    if line == "flickr":
        assert tcfg.client_datasets == ["CIFAR100", "AG_NEWS", "Flickr30k"]
        assert tcfg.B == 8 and tcfg.Cs == [0.25] * 3
        assert n_train["Flickr30k"] == 5 * 44
    elif line.startswith("medmnist"):
        half = line == "medmnist_cls_scale"
        assert n_train["MedMNIST"] == MEDMNIST_TRAIN // (2 if half else 1)
        assert tdata.client_meta[0].modality == "ct"
    else:
        assert tcfg.eval_metrics == ["acc1", "f1"]
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])

    for r in range(1, R + 1):
        for s in (jserver, tserver):
            s.round = r
            s.update()
            s.evaluate([])
        want = _untimed(jserver.results[r])
        _assert_results(_untimed(tserver.results[r]), want,
                        want["clients_updated_summary"]["loss"]["avg"])
        evals = [k for k in want if k.startswith("server_evaluated_")]
        assert evals, want.keys()
    if line == "medabstracts":
        metrics = want["server_evaluated_MedicalAbstracts"]["metrics"]
        assert set(metrics) == {"acc1", "f1"}
