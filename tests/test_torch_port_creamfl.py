"""The port's CreamFL server against the JAX ``CreamflServer`` on the CPU,
from the same initial weights (``mome_test16_patch16_32``, synthetic
data and public set, dropout 0, float32; the JAX side ``--no_pallas
--mesh_shape 1``), ``--Ks 2 2 2 --Cs 1 --B 8 --num_pub_samples 20
--pub_batch_size 8``: the last public batch is ragged (20 = 8 + 8 + 4).

* the global public features ``g_img`` / ``g_txt`` (1e-4);
* one public epoch of the img, the txt and the img+txt group from the
  round's start: the first step's per-client loss (1e-5 relative), the
  parameters and the AdamW state after the epoch (1e-4 * max(1,
  max|ref|); the step counters exactly: the cls heads must not age);
* ``_contrastive_weighted`` (1e-5) and the distillation over the public
  set (parameters, 1e-4 scaled);
* one whole round: the training loss within 1e-5 relative, every global
  leaf within 1e-4 scaled.

The key third of each ``qkv_bias`` has a zero gradient in exact
arithmetic (softmax over keys ignores it), so AdamW steps it on either
package's rounding noise, up to ``lr`` a step of either sign: it is held
within twice the sum of the learning rates of the AdamW steps it took.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.creamfl import CreamflServer as JaxCreamfl
from fedcola_tpu.federation.server import _broadcast_stack
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu.models import naming as jnaming
from fedcola_tpu.parallel.client_update import init_group_opt_states
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.creamfl import CreamflServer
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models.mat import tree_leaves

from test_torch_port_round import FEDCOLA

LR, P_LR = 1e-3, 1e-4          # FEDCOLA's --lr, the default --p_lr
N_PUB_BATCHES = 3


def _flags(tmp_path):
    flags = [("creamfl" if prev == "--algorithm" else f)
             for prev, f in zip([""] + FEDCOLA, FEDCOLA)]
    at = flags.index("--shared_param")
    flags[at:at + 9] = ["--shared_param", "none", "--share_scope",
                        "dataset", "--colearn_param", "none"]
    return flags + ["--Ks", "2", "2", "2", "--Cs", "1", "--B", "8",
                    "--num_pub_samples", "20", "--pub_batch_size", "8",
                    "--result_path", str(tmp_path / "r"),
                    "--log_path", str(tmp_path / "l")]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    flags = _flags(tmp_path_factory.mktemp("creamfl"))
    jcfg = jconfig.parse_args(flags + ["--no_pallas", "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    tcfg = tconfig.parse_args(flags + ["--device", "cpu"])
    tserver = tcreate(tcfg, tload(tcfg, np.random.RandomState(tcfg.seed)))
    assert isinstance(tserver, CreamflServer)
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])
    batches = list(tserver._pub_batches())
    assert len(batches) == N_PUB_BATCHES
    assert [b["n_valid"] for b in batches] == [8, 8, 4]
    return jserver, tserver


def _to_torch(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, ref, what, key_bias_bound, embed_dim=16):
    """``got`` (torch) against ``ref`` (JAX) within 1e-4 * max(1,
    max|ref|); the key third of a ``qkv_bias`` within
    ``key_bias_bound``."""
    got, ref = got.detach().numpy(), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    if what.endswith("qkv_bias"):
        D = embed_dim
        key = np.abs(got[..., D:2 * D] - ref[..., D:2 * D]).max()
        assert key <= key_bias_bound, (what, key)
        got = np.concatenate([got[..., :D], got[..., 2 * D:]], -1)
        ref = np.concatenate([ref[..., :D], ref[..., 2 * D:]], -1)
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * scale, (what, err)


def _assert_trees(tree, jtree, cfg, key_bias_bound, what=""):
    for path, name in jnaming.param_names(cfg):
        _assert_close(jnaming.get_by_path(tree, path),
                      jnaming.get_by_path(jtree, path), f"{what} {name} "
                      f"{'/'.join(path)}", key_bias_bound)


def test_public_features_match_jax(servers):
    jserver, tserver = servers
    jserver._generate_public_logit()
    tserver._generate_public_logit()
    assert tserver.g_img.shape == (20, 16)
    for got, ref in ((tserver.g_img, jserver.g_img),
                     (tserver.g_txt, jserver.g_txt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ds", ["CIFAR100", "AG_NEWS", "Coco"])
def test_public_epoch_matches_jax(servers, ds):
    jserver, tserver = servers
    jserver._generate_public_logit()
    tserver.g_img, tserver.g_txt = (_to_torch(jserver.g_img),
                                    _to_torch(jserver.g_txt))
    ids = [i for i in range(tserver.data.K)
           if tserver.client_dataset_of[i] == ds][:2]
    n = len(ids)
    # JAX: the vmapped public step over every public batch
    pub_fn = jserver._build_pub_update(ds, jserver._frozen_token(ds))
    gp = jserver.global_params[ds]
    stacked = _broadcast_stack(gp, n)
    state = init_group_opt_states(jserver.opt_spec, stacked)
    jlosses = []
    for b in jserver._pub_batches():
        stacked, state, loss = pub_fn(
            stacked, state, gp, b, jserver.g_img, jserver.g_txt,
            jax.random.split(jax.random.PRNGKey(0), n),
            jnp.float32(jserver.curr_lr))
        jlosses.append(np.asarray(loss))
    # the port: the same epoch on a freshly opened group
    g = tserver._open_group(ds, ids)
    first = tserver._pub_loss(g, next(tserver._pub_batches()))
    np.testing.assert_allclose(first.detach().numpy(), jlosses[0],
                               rtol=1e-5, atol=1e-7)
    tserver._public_epoch(g)
    mcfg = tserver.model_cfgs[ds]
    bound = 2 * N_PUB_BATCHES * LR
    _assert_trees(g.stacked, stacked, mcfg, bound, "params")
    for k in ("m", "v"):
        _assert_trees(g.opt_state[k], state[k], mcfg, bound, k)
    for path, name in jnaming.param_names(mcfg):
        np.testing.assert_array_equal(
            jnaming.get_by_path(g.opt_state["t"], path).numpy(),
            np.asarray(jnaming.get_by_path(state["t"], path)), err_msg=name)
    for i, task in enumerate(mcfg.tasks):     # frozen: never stepped
        if task == "cls":
            assert not jnaming.get_by_path(
                g.opt_state["t"], ("head", str(i), "kernel")).any()


def test_contrastive_weighted_matches_jax():
    r = np.random.RandomState(0)
    vecs = r.randn(3, 20, 16).astype(np.float32)
    other = r.randn(20, 16).astype(np.float32)
    ref = np.asarray(JaxCreamfl._contrastive_weighted(jnp.asarray(vecs),
                                                      jnp.asarray(other)))
    got = CreamflServer._contrastive_weighted(torch.from_numpy(vecs),
                                              torch.from_numpy(other))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_distill_matches_jax(servers):
    jserver, tserver = servers
    ds = tserver.mm_dataset
    r = np.random.RandomState(1)
    img_vec, txt_vec = (r.randn(20, 16).astype(np.float32) for _ in range(2))
    j_start, t_start = jserver.global_params[ds], tserver.global_params[ds]
    try:
        jserver._distill(jnp.asarray(img_vec), jnp.asarray(txt_vec))
        tserver._distill(torch.from_numpy(img_vec),
                         torch.from_numpy(txt_vec))
        _assert_trees(tserver.global_params[ds], jserver.global_params[ds],
                      tserver.model_cfgs[ds], 2 * N_PUB_BATCHES * P_LR)
        # and it moved the model beyond that tolerance
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(tserver.global_params[ds]), tree_leaves(t_start)))
        assert moved > 1e-4
    finally:
        jserver.global_params[ds] = j_start
        tserver.global_params[ds] = t_start


def test_creamfl_round_matches_jax_server(servers):
    jserver, tserver = servers
    for server in (jserver, tserver):
        server.round = 1
        server.update()
    jl = jserver.results[1]["clients_updated_summary"]["loss"]["avg"]
    tl = tserver.results[1]["clients_updated_summary"]["loss"]["avg"]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    # the top-level sections (the undotted span names)
    assert {k for k in tserver.results[1]["round_sections"]
            if "." not in k} == {"pub_logit", "train", "aggregate",
                                 "distill"}
    # per client: E=1 epoch of (at most two --debug task steps and one
    # public pass); then the distillation
    bound = 2 * ((2 + N_PUB_BATCHES) * LR + N_PUB_BATCHES * P_LR)
    for ds in tserver.global_params:
        _assert_trees(tserver.global_params[ds], jserver.global_params[ds],
                      tserver.model_cfgs[ds], bound, ds)
