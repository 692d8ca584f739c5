"""The port's losses, FedProx term, ``seq_feat_out`` and the FedProx /
FedIoT / FedOpt servers against the JAX package on the CPU.

* every new loss against the JAX function, with and without ``valid``, and
  client-stacked against the JAX function per client: 1e-6 relative;
* ``fedprox_term`` on a client-stacked tree, value and gradient against
  ``jax.grad`` per client, with one client at zero distance (its gradient
  is finite and 0);
* ``seq_feat_out``: the sequence features and the gradient of a token-sum
  MSE against JAX ``mat_apply(seq_feat_out=True)``, 1e-4;
* one round of fedprox (``--mu 0.01``), fediot and the four FedOpt flavors
  (``--beta1 0.9 --server_lr 0.1``) through both servers from the same
  weights (``mome_test16_patch16_32``, synthetic data, dropout 0, float32;
  the JAX side ``--no_pallas --mesh_shape 1``): the training loss within
  1e-5 relative, every global leaf and the FedOpt moments within
  1e-4 * max(1, max|ref|).  These rounds train with SGD: the key third of
  each ``qkv_bias`` has a zero gradient in exact arithmetic (softmax over
  keys ignores it), and AdamW turns either package's rounding noise there
  into steps of up to ``lr`` of either sign;
* a fedadam run (AdamW) stopped after round 1 and resumed equals the
  unbroken run exactly;
* ``create_server`` returns the port's class for every algorithm name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu.models import mat as jmat
from fedcola_tpu.models import naming as jnaming
from fedcola_tpu.ops import losses as jlosses
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as port_main
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation import creamfl as tcreamfl
from fedcola_tpu_torch.federation import fedopt as tfedopt
from fedcola_tpu_torch.federation import server as tserver_mod
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models import mat as tmat
from fedcola_tpu_torch.models.mat import tree_leaves
from fedcola_tpu_torch.ops import losses as tlosses
from fedcola_tpu_torch.parallel import client_update as tcu

from test_torch_port_model import _configs, _flat, _inputs
from test_torch_port_round import FEDCOLA

LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
FEDOPT = ("fedavgm", "fedadam", "fedyogi", "fedadagrad")


# ---------------------------------------------------------------- losses --

def _loss_cases(r):
    """Two clients' inputs of each loss, ``[2, B, ...]``."""
    B, C, L, V, D = 6, 5, 7, 11, 8
    cls = r.randn(2, B, C).astype(np.float32) * 3
    seq = r.randn(2, B, L, V).astype(np.float32) * 2
    toks = r.randint(0, V, (2, B, L)).astype(np.int32)
    toks[0, 0] = 1                  # a row of special tokens only
    emb = r.randn(2, 2, B, D).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    seg = r.randn(2, B, C, 3, 4).astype(np.float32)
    seg_y = r.randint(0, C, (2, B, 3, 4)).astype(np.int32)
    probs = r.rand(2, B, C, 3).astype(np.float32)
    return {
        "painless_bce": (cls, r.randint(0, C, (2, B)).astype(np.int32)),
        "painless_bce_multilabel": (
            cls, (r.rand(2, B, C) > 0.5).astype(np.float32)),
        "seq2seq_ce": (seq, toks),
        "mc_soft_contrastive": (emb[:, 0], emb[:, 1]),
        "dice_loss": (probs, (r.rand(2, B, C, 3) > 0.5).astype(np.float32)),
        "seg_loss": (seg, seg_y),
        "seg_loss_target_channel": (seg, seg_y[:, :, None]),
    }


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["painless_bce", "painless_bce_multilabel",
                                  "seq2seq_ce", "mc_soft_contrastive",
                                  "dice_loss", "seg_loss",
                                  "seg_loss_target_channel"])
def test_new_losses_match_jax(case, masked):
    a, b = _loss_cases(np.random.RandomState(0))[case]
    name = case.replace("_multilabel", "").replace("_target_channel", "")
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 1, 1]], bool)
    jv = [jnp.asarray(v) if masked else None for v in valid]
    refs = [float(jfn(jnp.asarray(a[c]), jnp.asarray(b[c]), jv[c]))
            for c in range(2)]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tv = torch.from_numpy(valid) if masked else None
    for c in range(2):              # one client: the JAX layout
        got = tfn(ta[c], tb[c], None if tv is None else tv[c])
        np.testing.assert_allclose(float(got), refs[c], **LOSS_TOL)
    # client-stacked, as the group update calls it (the group update
    # always passes a mask)
    if name == "seg_loss":
        got = tcu._cls_criterion("SegLoss")(
            ta, tb, tv if masked else torch.ones(2, 6, dtype=torch.bool))
    elif name == "dice_loss":
        return                      # [B, ...] maps only, as in JAX
    else:
        got = tfn(ta, tb, tv)
    np.testing.assert_allclose(got.numpy(), refs, **LOSS_TOL)


def test_criterion_lookups_cover_the_jax_tables():
    from fedcola_tpu.parallel import client_update as jcu
    for name in ("CrossEntropyLoss", "PainlessBCEWithLogitsLoss",
                 "BCEWithLogitsLoss", "SegLoss"):
        jcu._cls_criterion(name)
        tcu._cls_criterion(name)
    for name in ("ContrastiveLoss", "MCSoftContrastiveLoss"):
        assert tcu._mm_criterion(name).__name__ == \
            jcu._mm_criterion(name).__name__


# ---------------------------------------------------------------- fedprox --

def test_fedprox_term_value_and_grad_match_jax_including_zero_distance():
    jcfg, tcfg = _configs("img_cls")        # blk, aux, emb, head, norm
    r = np.random.RandomState(0)
    g = jax.tree_util.tree_map(
        np.asarray, jmat.init_mat(jcfg, jax.random.PRNGKey(0)))
    flat = _flat(g)
    moved = {p: a + (r.randn(*a.shape) * 0.1).astype(np.float32)
             for p, a in flat.items()}
    # client 0 sits on the global model; client 1 moved every leaf but
    # the aux scales, which stay at zero distance leaf by leaf
    stacked = {}
    for p, a in flat.items():
        b = a if p[-1].endswith("_scale") else moved[p]
        node = stacked
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = np.stack([a, b])
    mu = 0.01

    def jterm(p):
        return jlosses.fedprox_term(p, g, mu)

    jval = jax.vmap(jterm)(stacked)
    jgrad = jax.vmap(jax.grad(jterm))(stacked)

    tp = tmat.tree_map(lambda a: a.requires_grad_(True),
                       convert.params_from_jax(stacked))
    tg = convert.params_from_jax(g)
    tval = tlosses.fedprox_term(tp, tg, mu)
    assert tval.shape == (2,)
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               rtol=1e-6, atol=1e-9)
    assert float(tval[0].detach()) == 0.0
    tf = _flat(tp)
    paths = sorted(tf)
    grads = torch.autograd.grad(tval.sum(), [tf[p] for p in paths])
    jf = _flat(jgrad)
    for p, gr in zip(paths, grads):
        assert torch.isfinite(gr).all(), p
        assert not gr[0].any(), p        # the subgradient 0, not NaN
        np.testing.assert_allclose(gr.numpy(), np.asarray(jf[p]),
                                   rtol=1e-5, atol=1e-8, err_msg=str(p))


# ---------------------------------------------------------- seq_feat_out --

@pytest.mark.parametrize("case", ["img_txt_feat", "img_txt_feat_fused"])
def test_seq_feat_out_and_token_sum_mse_grad_match_jax(case):
    """The fused case runs the residual kernels' plain versions with a dout
    on every token of the last layer."""
    jcfg, tcfg = _configs(case)
    r = np.random.RandomState(1)
    jparams = jmat.init_mat(jcfg, jax.random.PRNGKey(2))
    ins = _inputs(jcfg, r)
    tgt = [r.randn(3, jcfg.embed_dim).astype(np.float32) for _ in range(2)]

    def jloss(p):
        outs = jmat.mat_apply(jcfg, p, [jnp.asarray(a) for a in ins],
                              train=True, rng=jax.random.PRNGKey(1),
                              seq_feat_out=True)
        return sum(jnp.mean(jnp.square(jnp.sum(outs[i], 1) - tgt[i]))
                   for i in (0, 1)), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = tmat.tree_map(
        lambda t: t.requires_grad_(True),
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg=tcfg))
    touts = tmat.mat_apply(tcfg, tparams, [torch.from_numpy(a) for a in ins],
                           train=True, gen=torch.Generator().manual_seed(0),
                           seq_feat_out=True)
    loss = sum((touts[i].sum(1) - torch.from_numpy(tgt[i])).square().mean()
               for i in (0, 1))
    for i, n_tok in ((0, jcfg.num_patches + 1), (1, 10)):
        assert touts[i].shape == (3, n_tok, jcfg.embed_dim)
        assert touts[i].dtype == torch.float32
        np.testing.assert_allclose(touts[i].detach().numpy(),
                                   np.asarray(jouts[i]), atol=1e-4, rtol=1e-4)
    tf = _flat(tparams)
    paths = sorted(tf)
    grads = torch.autograd.grad(loss, [tf[p] for p in paths])
    jf = _flat(jgrads)
    assert sorted(jf) == paths
    for p, gr in zip(paths, grads):
        np.testing.assert_allclose(gr.numpy(), np.asarray(jf[p]), atol=1e-4,
                                   rtol=1e-4, err_msg=str(p))


# ---------------------------------------------------------------- rounds --

_SHARING = ("--shared_param", "--share_scope", "--colearn_param",
            "--compensation", "--with_aux", "--aux_trained")


SGD = ("--optimizer", "SGD", "--lr", "0.05")


def _flags(tmp_path, algorithm, *extra, sharing=True):
    """The FedCola test line with another algorithm; ``sharing=False``
    drops its sharing flags (coco.sh's baselines set their own)."""
    flags = [algorithm if prev == "--algorithm" else f
             for prev, f in zip([""] + FEDCOLA, FEDCOLA)]
    if not sharing:
        at = flags.index("--shared_param")
        flags[at:at + 9] = []
        assert not set(flags) & set(_SHARING)
    return flags + list(extra) + ["--result_path", str(tmp_path / "r"),
                                  "--log_path", str(tmp_path / "l")]


def _port_server(flags, weights=None):
    """The port's server; ``weights``: initial global trees of numpy
    arrays."""
    cfg = tconfig.parse_args(flags + ["--device", "cpu"])
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    for ds, p in (weights or {}).items():
        server.global_params[ds] = convert.params_from_jax(
            p, cfg=server.model_cfgs[ds])
    return server


def _servers(flags, jax_algorithm=None):
    """The JAX server (optionally built under another algorithm name), the
    port's from the JAX server's initial weights, and those weights."""
    jflags = flags + ["--no_pallas", "--mesh_shape", "1"]
    if jax_algorithm:
        jflags = [jax_algorithm if prev == "--algorithm" else f
                  for prev, f in zip([""] + jflags, jflags)]
    jcfg = jconfig.parse_args(jflags)
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    weights = {ds: jax.tree_util.tree_map(np.asarray, p)
               for ds, p in jserver.global_params.items()}
    return jserver, _port_server(flags, weights), weights


def _round(server):
    server.round = 1
    server.update()
    return server.results[1]["clients_updated_summary"]["loss"]["avg"]


def _assert_trees_close(ttrees, jtrees, model_cfgs, what):
    for ds, t in ttrees.items():
        for path, name in jnaming.param_names(model_cfgs[ds]):
            ref = np.asarray(jnaming.get_by_path(jtrees[ds], path))
            got = jnaming.get_by_path(t, path).numpy()
            err = np.abs(got - ref).max()
            assert err <= 1e-4 * max(1.0, np.abs(ref).max()), \
                (what, ds, name, err)


def _assert_round_matches(jserver, tserver):
    jl, tl = _round(jserver), _round(tserver)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    _assert_trees_close(tserver.global_params, jserver.global_params,
                        tserver.model_cfgs, "global")


def test_fedprox_round_matches_jax_server(tmp_path):
    flags = _flags(tmp_path, "fedprox", "--shared_param", "none",
                   "--share_scope", "dataset", *SGD, sharing=False)
    jserver, tserver, weights = _servers(flags + ["--mu", "0.01"])
    assert isinstance(tserver, tserver_mod.FedProxServer)
    assert tserver._group_spec("CIFAR100").mu == 0.01
    _assert_round_matches(jserver, tserver)
    # the term moves the compared loss far beyond its tolerance
    without = _round(_port_server(flags + ["--mu", "0"], weights))
    jl = jserver.results[1]["clients_updated_summary"]["loss"]["avg"]
    assert abs(without - jl) > 1e-4 * abs(jl)


def test_fediot_round_matches_jax_server(tmp_path):
    jserver, tserver, _ = _servers(_flags(tmp_path, "fediot", *SGD,
                                          sharing=False))
    assert isinstance(tserver, tserver_mod.FedIoTServer)
    assert (tserver.cfg.shared_param, tserver.cfg.share_scope) == \
        ("blocks", "modality_exact")
    _assert_round_matches(jserver, tserver)


@pytest.fixture(scope="module")
def fedopt_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("fedopt")


@pytest.mark.parametrize("flavor", FEDOPT)
def test_fedopt_round_matches_jax_server(fedopt_tmp, flavor):
    """The JAX server is built as fedadam and given the flavor: its group
    programs key on the algorithm name, so they compile once for all
    four."""
    flags = _flags(fedopt_tmp / flavor, flavor, "--beta1", "0.9",
                   "--server_lr", "0.1", *SGD)
    jserver, tserver, _ = _servers(flags, jax_algorithm="fedadam")
    jserver.flavor = flavor
    assert isinstance(tserver, tfedopt.FedOptServer)
    _assert_round_matches(jserver, tserver)
    _assert_trees_close(tserver.server_m, jserver.server_m,
                        tserver.model_cfgs, "m")
    _assert_trees_close(tserver.server_v, jserver.server_v,
                        tserver.model_cfgs, "v")


def test_fedadam_resumed_run_equals_unbroken_run(tmp_path):
    """Through the port's entry point: ``--R 1 --checkpoint_every 1``, then
    ``--R 2`` resumes; the moments come back from ``__fedopt_{ds}.npz``."""
    def run(sub, R, *extra):
        flags = _flags(tmp_path / sub, "fedadam", "--beta1", "0.9",
                       "--server_lr", "0.1", "--device", "cpu", *extra)
        flags = [str(R) if prev == "--R" else f
                 for prev, f in zip([""] + flags, flags)]
        return port_main.main(flags)

    whole = run("whole", 2)
    run("parts", 1, "--checkpoint_every", "1")
    ckpt = tmp_path / "parts" / "r" / "FedCola" / "ckpt"
    assert (ckpt / "__fedopt_Coco.npz").exists()
    resumed = run("parts", 2, "--checkpoint_every", "1")
    assert sorted(resumed.results) == [2]
    assert resumed.results[2]["clients_updated_summary"] == \
        whole.results[2]["clients_updated_summary"]
    for ds in whole.global_params:
        for tree in ("global_params", "server_m", "server_v"):
            for a, b in zip(tree_leaves(getattr(resumed, tree)[ds]),
                            tree_leaves(getattr(whole, tree)[ds])):
                assert a.equal(b), (tree, ds)


@pytest.mark.parametrize("algorithm, cls", [
    ("fedprox", tserver_mod.FedProxServer),
    ("fediot", tserver_mod.FedIoTServer),
    ("fedavgm", tfedopt.FedOptServer), ("fedadam", tfedopt.FedOptServer),
    ("fedyogi", tfedopt.FedOptServer), ("fedadagrad", tfedopt.FedOptServer),
    ("creamfl", tcreamfl.CreamflServer)])
def test_create_server_builds_each_algorithm(tmp_path, algorithm, cls):
    cfg = tconfig.parse_args(_flags(tmp_path, algorithm, "--device", "cpu",
                                    "--num_pub_samples", "10",
                                    sharing=algorithm in FEDOPT))
    server = tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
    assert type(server) is cls and server.cfg.algorithm == algorithm


def test_unknown_algorithm_is_refused_by_name(tmp_path):
    cfg = tconfig.parse_args(_flags(tmp_path, "fedfoo", "--device", "cpu"))
    with pytest.raises(ValueError, match="fedfoo"):
        tcreate(cfg, tload(cfg, np.random.RandomState(cfg.seed)))
