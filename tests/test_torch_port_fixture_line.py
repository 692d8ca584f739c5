"""The scripts/coco.sh FedCola line with its own data flags
(``--pretrained``, ``--use_bert_tokenizer``, path-backed ``--data_paths``)
on path-backed fixtures: the PyTorch port against the JAX package on the
CPU at ``mome_test_patch16_32`` (32 px, dropout 0, float32).

* Three rounds through both servers from the same weights: the image
  towers hold the local checkpoint at init, per-round training losses
  agree to 1e-5 relative, central acc1 and COCO r@1sum are equal, the
  loss falls, and ``finalize`` writes ``<ds>.pt`` files with the JAX
  server's keys (bit for bit on the same weights).
* ``python -m fedcola_tpu_torch.main --device cpu`` on the same line with
  ``--profile_every 1``: a ``<ds>.pt`` per dataset, a Chrome trace that
  parses as JSON, ids from the native encoder.
"""

import json
import os

import numpy as np
import pytest
import torch

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
from fedcola_tpu_torch.models.pretrained import write_timm_vit_checkpoint
from fedcola_tpu_torch.native import tokenizer_fast

DATASETS = ("CIFAR100", "AG_NEWS", "Coco")
CUTS = {"--model_name": "mome_test_patch16_32", "--resize": "32",
        "--B": "16", "--lr": "1e-3", "--eval_batch_size": "128",
        "--dropout": "0", "--R": "3"}


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    """The fixture roots, the checkpoint and the line's flags (less the
    device flags), at test size."""
    d = tmp_path_factory.mktemp("fixture_line")
    coco = fixtures.coco_fixture(str(d / "coco"), 40, 12, 32)
    cifar = fixtures.cifar100_fixture(str(d / "cifar"), 800, 200)
    agnews = fixtures.agnews_fixture(str(d / "agnews"), 400, 100)
    ckpt = write_timm_vit_checkpoint(str(d / "vit.npz"), 8, 2, img_size=32,
                                     seed=5)
    flags = list(tmain.fixture_flags(coco, cifar, agnews))
    for flag, value in CUTS.items():
        flags[flags.index(flag) + 1] = value
    # two clients a group, the same ones every round, so that the rounds'
    # average losses are over the same clients
    at = flags.index("--Ks")
    flags[at + 1:at + 4] = ["2", "2", "2"]
    flags[flags.index("--Cs") + 1] = "1.0"
    at = flags.index("--device")
    del flags[at:at + 2]
    flags += ["--seq_len", "12", "--vocab_size", "120",
              "--compute_dtype", "float32", "--train_chunk_steps", "4"]
    return d, ckpt, flags


@pytest.fixture()
def pretrain_env(line, monkeypatch):
    monkeypatch.setenv("FEDCOLA_PRETRAIN_VIT_TEST_PATCH16_32", line[1])


def _tower(params):
    return params["blk"]["0"]["qkv_kernel"]


def test_fixture_line_matches_jax_server(line, pretrain_env, tmp_path):
    d, ckpt, flags = line
    assert "--synthetic_data" not in flags and "--pretrained" in flags
    out = ["--result_path", str(tmp_path / "j"), "--log_path",
           str(tmp_path / "l")]
    jcfg = jconfig.parse_args(flags + out + ["--no_pallas",
                                             "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    out[1] = str(tmp_path / "t")
    tcfg = tconfig.parse_args(flags + out + ["--device", "cpu"])
    before = tokenizer_fast.NATIVE_ROWS
    tdata = tload(tcfg, np.random.RandomState(tcfg.seed))
    # AG_NEWS and Coco captions, train and test, on the native encoder
    assert tokenizer_fast.NATIVE_ROWS - before == 400 + 100 + 5 * (40 + 12)
    assert tdata.server_eval["Coco"].image_paths is not None
    tserver = tcreate(tcfg, tdata)

    with np.load(ckpt) as z:
        qkv = np.stack([z[f"blocks.{j}.attn.qkv.weight"].T for j in range(2)])
    for ds in ("CIFAR100", "Coco"):
        np.testing.assert_array_equal(_tower(tserver.global_params[ds]), qkv)
        np.testing.assert_array_equal(
            np.asarray(_tower(jserver.global_params[ds])), qkv)
    aux = tserver.global_params["CIFAR100"]["aux"]["qkv_aux"]
    np.testing.assert_array_equal(aux.numpy(), qkv)
    # the heads and the text tower are random: start from the JAX weights
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])

    losses = []
    for r in (1, 2, 3):
        for s in (jserver, tserver):
            s.round = r
            s.update()
            s.evaluate([])
        jr, tr = jserver.results[r], tserver.results[r]
        jl = jr["clients_updated_summary"]["loss"]["avg"]
        tl = tr["clients_updated_summary"]["loss"]["avg"]
        assert abs(tl - jl) <= 1e-5 * abs(jl), (r, tl, jl)
        losses.append(tl)
        for ds in ("CIFAR100", "AG_NEWS"):
            key = f"server_evaluated_{ds}"
            assert tr[key]["metrics"]["acc1"] == jr[key]["metrics"]["acc1"]
        assert (tr["server_evaluated_Coco"]["Coco r@1sum"]
                == jr["server_evaluated_Coco"]["Coco r@1sum"])
    assert losses[2] < losses[0], losses
    for ds in ("CIFAR100", "Coco"):
        assert not np.array_equal(_tower(tserver.global_params[ds]).numpy(),
                                  qkv)

    jserver.finalize()
    tserver.finalize()
    tdir = os.path.join(tcfg.result_path, tcfg.exp_name)
    jdir = os.path.join(jcfg.result_path, jcfg.exp_name)
    for ds in DATASETS:
        got = torch.load(os.path.join(tdir, f"{ds}.pt"), weights_only=True)
        want = torch.load(os.path.join(jdir, f"{ds}.pt"), weights_only=True)
        assert sorted(got) == sorted(want), ds
        for k in want:     # three rounds of training apart
            torch.testing.assert_close(got[k], want[k], atol=1e-4, rtol=1e-3)
    # on the same weights the two exports agree bit for bit
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])
    tserver.finalize()
    for ds in DATASETS:
        got = torch.load(os.path.join(tdir, f"{ds}.pt"), weights_only=True)
        want = torch.load(os.path.join(jdir, f"{ds}.pt"), weights_only=True)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (ds, k)


def test_fixture_line_cli_writes_pt_and_trace(line, pretrain_env, tmp_path):
    _, _, flags = line
    out = tmp_path / "run"
    server = tmain.main(flags + [
        "--device", "cpu", "--R", "1", "--profile_every", "1",
        "--result_path", str(out / "r"), "--log_path", str(out / "l")])
    ckpt_dir = out / "r" / "FedCola"
    for ds in DATASETS:
        sd = torch.load(ckpt_dir / f"{ds}.pt", weights_only=True)
        assert all(v.dtype == torch.float32 for v in sd.values())
    assert "norm.weight" in sd and "embeddings.0.embed.proj.weight" in sd
    with open(out / "l" / "trace_round0001" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert np.isfinite(
        server.results[1]["clients_updated_summary"]["loss"]["avg"])
