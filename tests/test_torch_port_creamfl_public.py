"""The CreamFL line on a real-format public set: ``--pub_data_dir`` /
``--pub_anno_path`` on a COCO fixture written by ``data/fixtures.py``
(the public set the reference's ``get_pub_loader`` reads: the last
``--num_pub_samples`` ids of ``coco_train_ids.npy``, their captions and
jpegs), the client data path-backed on the same fixture roots as
``test_torch_port_fixture_line.py``.  The port against the JAX
``CreamflServer`` on the CPU from the same weights, one device, two rounds
(``mome_test16_patch16_32``, float32, dropout 0, ``--Ks 2 2 2 --Cs 1
--num_pub_samples 20 --pub_batch_size 8``: the last public batch is
ragged):

* both servers load the same public rows, pixels and token ids, and the
  port logs no ``=== SYNTHETIC DATA ===`` banner;
* the training loss within 1e-5 relative a round, every global leaf within
  1e-4 * max(1, max|ref|), the key third of each ``qkv_bias`` within twice
  the learning rates of the AdamW steps it took (``test_torch_port_creamfl``
  explains why).
"""

import logging

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

from test_torch_port_creamfl import LR, N_PUB_BATCHES, P_LR, _assert_trees

R = 2
CUTS = {"--model_name": "mome_test16_patch16_32", "--resize": "32",
        "--B": "8", "--lr": str(LR), "--eval_batch_size": "128",
        "--dropout": "0", "--R": str(R), "--exp_name": "CreamFL",
        "--algorithm": "creamfl", "--Cs": "1.0"}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def flags(tmp_path_factory):
    """The CreamFL line on the fixture roots, its public set the COCO
    fixture's train split."""
    d = tmp_path_factory.mktemp("creamfl_public")
    coco = fixtures.coco_fixture(str(d / "coco"), 40, 12, 32)
    cifar = fixtures.cifar100_fixture(str(d / "cifar"), 800, 200)
    agnews = fixtures.agnews_fixture(str(d / "agnews"), 400, 100)
    flags = [f for f in tmain.fixture_flags(coco, cifar, agnews)
             if f != "--pretrained"]
    for flag, value in CUTS.items():
        flags[flags.index(flag) + 1] = value
    at = flags.index("--shared_param")
    flags[at:at + 9] = ["--shared_param", "none", "--share_scope",
                        "dataset", "--colearn_param", "none"]
    at = flags.index("--Ks")
    flags[at + 1:at + 4] = ["2", "2", "2"]
    at = flags.index("--device")
    del flags[at:at + 2]
    return d, flags + [
        "--seq_len", "12", "--vocab_size", "120", "--compute_dtype",
        "float32", "--train_chunk_steps", "4", "--num_pub_samples", "20",
        "--pub_batch_size", "8", "--pub_data_dir", f"{coco}/all_images",
        "--pub_anno_path", f"{coco}/annotations/captions_train2014.json",
        "--result_path", str(d / "r"), "--log_path", str(d / "l")]


def test_path_backed_public_set_matches_jax_server(flags):
    d, flags = flags
    assert "--synthetic_data" not in flags
    jcfg = jconfig.parse_args(flags + ["--no_pallas", "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    tcfg = tconfig.parse_args(flags + ["--device", "cpu"])
    records = _Records()
    log = logging.getLogger("fedcola_tpu_torch")
    level = log.level
    log.addHandler(records)
    log.setLevel(logging.INFO)
    try:
        tserver = tcreate(tcfg, tload(tcfg, np.random.RandomState(tcfg.seed)))
    finally:
        log.removeHandler(records)
        log.setLevel(level)
    assert not any("SYNTHETIC DATA" in m for m in records.messages)
    assert "[CREAMFL] public set: 20 samples in 3 batches" in records.messages

    # the same public rows: the last 20 train captions (4 images)
    batches = tserver._pub_host
    assert [b["n_valid"] for b in batches] == [8, 8, 4]
    for b, jb in zip(batches, jserver._pub_batch_list()):
        np.testing.assert_array_equal(b["img"], jb["img"])
        np.testing.assert_array_equal(b["txt"], jb["txt"])
        np.testing.assert_array_equal(b["didx"], jb["didx"])
    assert batches[0]["img"].shape == (8, 32, 32, 3)
    assert len({b["img"][i].tobytes() for b in batches
                for i in range(b["n_valid"])}) == 4

    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])
    for r in range(1, R + 1):
        for s in (jserver, tserver):
            s.round = r
            s.update()
        jl = jserver.results[r]["clients_updated_summary"]["loss"]["avg"]
        tl = tserver.results[r]["clients_updated_summary"]["loss"]["avg"]
        assert abs(tl - jl) <= 1e-5 * abs(jl), (r, tl, jl)
    # per round and client: E=1 epoch of (at most two --debug task steps
    # and one public pass); then the distillation
    bound = 2 * R * ((2 + N_PUB_BATCHES) * LR + N_PUB_BATCHES * P_LR)
    for ds in tserver.global_params:
        _assert_trees(tserver.global_params[ds], jserver.global_params[ds],
                      tserver.model_cfgs[ds], bound, ds)
