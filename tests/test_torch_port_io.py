"""Reference-format state dicts, the pretrained ViT import and
``init_weights``: the PyTorch port against the JAX package on the CPU.

* ``to_torch_state_dict`` gives the JAX export's keys and bits for an
  image model with aux weights, a text model, an image+text model and a
  colearn-attn one; ``from_torch_state_dict`` inverts it, and a partial
  dict loads only its complete groups, as the JAX import does.
* ``write_timm_vit_checkpoint`` writes the JAX writer's arrays, and
  ``load_pretrained_vit`` builds the JAX package's tree bit for bit, the
  aux kernels re-synced to the loaded ones; a missing or unmappable
  checkpoint warns and keeps the random init.
* ``init_weights`` redraws and zeroes the leaves the JAX version does,
  with each ``init_type``'s spread.
"""

import logging
import math

import numpy as np
import pytest
import torch

import jax

from fedcola_tpu import config as jconfig
from fedcola_tpu.models import mat as jmat
from fedcola_tpu.models import pretrained as jpre
from fedcola_tpu.models import torch_io as jio
from fedcola_tpu.models.registry import build_mat_config as jbuild
from fedcola_tpu.utils.init import init_weights as jinit
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models import pretrained as tpre
from fedcola_tpu_torch.models import torch_io as tio
from fedcola_tpu_torch.models.mat import tree_leaves
from fedcola_tpu_torch.models.registry import build_mat_config as tbuild
from fedcola_tpu_torch.utils.init import init_weights as tinit

MODEL = "mome_test_patch16_32"
SHAPES = {  # dataset, config overrides
    "img_aux": ("CIFAR100", dict(with_aux=True, aux_trained=True)),
    "txt": ("AG_NEWS", dict(with_aux=True)),
    "img_txt": ("Coco", dict()),
    "colearn_attn": ("Coco", dict(colearn_param="attn")),
}


def _cfgs(shape):
    ds, kw = SHAPES[shape]
    kw = dict(seq_len=8, vocab_size=60, **kw)
    return (jbuild(MODEL, jconfig.ExperimentConfig(**kw), ds),
            tbuild(MODEL, tconfig.ExperimentConfig(**kw), ds))


def _params(jcfg, tcfg, seed):
    """The same random tree in both packages; the aux scales made nonzero
    so that the export of ``cross_modal_scale`` is seen."""
    jp = jax.tree_util.tree_map(np.asarray,
                                jmat.init_mat(jcfg, jax.random.PRNGKey(seed)))
    if "aux" in jp:
        r = np.random.RandomState(seed)
        jp["aux"] = {k: (r.randn(*v.shape).astype(np.float32)
                         if k.endswith("_scale") else v)
                     for k, v in jp["aux"].items()}
    return jp, convert.params_from_jax(jp, cfg=tcfg)


def _assert_trees_equal(got, want):
    """``got`` (port tree) bit for bit equal to ``want`` (numpy tree)."""
    g, w = convert.params_to_numpy(got), want
    assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(w)
    for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(w)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_state_dict_export_matches_jax(shape):
    jcfg, tcfg = _cfgs(shape)
    jp, tp = _params(jcfg, tcfg, 0)
    want = jio.to_torch_state_dict(jcfg, jp)
    got = tio.to_torch_state_dict(tcfg, tp)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "cpu" and v.dtype == torch.float32
        assert torch.equal(v, torch.from_numpy(np.array(want[k]))), k
    if shape == "img_aux":
        assert any(k.endswith("aux_weight") for k in got)
    if shape == "colearn_attn":
        # the tied text-slot attention is exported from the main slot
        assert torch.equal(got["blockses.1.0.attn.qkv.weight"],
                           got["blockses.0.0.attn.qkv.weight"])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_state_dict_import_round_trip_and_partial(shape):
    jcfg, tcfg = _cfgs(shape)
    jp, tp = _params(jcfg, tcfg, 0)
    jbase, tbase = _params(jcfg, tcfg, 1)
    sd = tio.to_torch_state_dict(tcfg, tp)
    _assert_trees_equal(tio.from_torch_state_dict(tcfg, tbase, sd), jp)
    # partial: one depth layer of a block leaf, half of the final norm and
    # (with aux) one layer's scale of one kind are missing; those groups
    # keep the base values, as in the JAX import
    drop = {"blockses.{}.1.mlp.fc1.weight".format(tcfg.main_slot),
            "norm.bias"}
    if tcfg.has_aux:
        drop.add(f"blockses.{tcfg.main_slot}.0.attn.proj.cross_modal_scale")
    part = {k: v for k, v in sd.items() if k not in drop}
    got = tio.from_torch_state_dict(tcfg, tbase, part)
    want = jio.from_torch_state_dict(
        jcfg, jbase, {k: v.numpy() for k, v in part.items()})
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
    s = str(tcfg.main_slot)
    assert torch.equal(got["blk"][s]["fc1_kernel"], tbase["blk"][s]["fc1_kernel"])
    assert torch.equal(got["norm"]["scale"], tbase["norm"]["scale"])
    assert torch.equal(got["blk"][s]["fc2_kernel"], tp["blk"][s]["fc2_kernel"])
    # the base tree is not modified
    _assert_trees_equal(tbase, jbase)


# ------------------------------------------------------------ pretrained --

@pytest.fixture()
def ckpt(tmp_path, monkeypatch):
    path = tpre.write_timm_vit_checkpoint(
        str(tmp_path / "port.npz"), embed_dim=8, depth=2, img_size=32,
        patch_size=16, seed=5)
    monkeypatch.setenv("FEDCOLA_PRETRAIN_VIT_TEST_PATCH16_32", path)
    return path


def test_checkpoint_writer_matches_jax(ckpt, tmp_path):
    jpath = jpre.write_timm_vit_checkpoint(
        str(tmp_path / "jax.npz"), embed_dim=8, depth=2, img_size=32,
        patch_size=16, seed=5)
    with np.load(ckpt) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shape", ["img_aux", "img_txt", "txt"])
def test_pretrained_import_matches_jax(ckpt, shape):
    jcfg, tcfg = _cfgs(shape)
    jp, tp = _params(jcfg, tcfg, 0)
    want = jax.tree_util.tree_map(
        np.asarray, jpre.load_pretrained_vit(jcfg, jp, "vit_test_patch16_32"))
    got = tpre.load_pretrained_vit(tcfg, tp, "vit_test_patch16_32")
    _assert_trees_equal(got, want)
    if shape == "txt":
        assert got is tp            # no image slot: nothing to import
        return
    with np.load(ckpt) as z:
        qkv = np.stack([z[f"blocks.{j}.attn.qkv.weight"].T for j in range(2)])
        np.testing.assert_array_equal(got["blk"]["0"]["qkv_kernel"].numpy(),
                                      qkv)
        np.testing.assert_array_equal(got["norm"]["scale"].numpy(),
                                      z["norm.weight"])
    if shape == "img_aux":
        for kind in tcfg.aux_layer_kinds:
            assert torch.equal(got["aux"][f"{kind}_aux"],
                               got["blk"]["0"][f"{kind}_kernel"])
    # the heads keep their random init (the reference drops 'head')
    for h in got["head"]:
        assert torch.equal(got["head"][h]["kernel"], tp["head"][h]["kernel"])


def test_pretrained_import_reads_pt_checkpoints(ckpt, tmp_path, monkeypatch):
    """A ``.pt`` state dict (tensors, under "model" as timm's training
    checkpoints hold it) imports as the ``.npz`` of the same weights."""
    jcfg, tcfg = _cfgs("img_aux")
    _, tp = _params(jcfg, tcfg, 0)
    from_npz = tpre.load_pretrained_vit(tcfg, tp, "vit_test_patch16_32")
    with np.load(ckpt) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    pt = tmp_path / "vit_test_patch16_32.pt"
    torch.save({"model": sd}, pt)
    monkeypatch.setenv("FEDCOLA_PRETRAIN_VIT_TEST_PATCH16_32", str(pt))
    from_pt = tpre.load_pretrained_vit(tcfg, tp, "vit_test_patch16_32")
    for a, b in zip(tree_leaves(from_npz), tree_leaves(from_pt)):
        assert torch.equal(a, b)


def test_missing_or_unmappable_checkpoint_keeps_random_init(
        tmp_path, monkeypatch, caplog):
    jcfg, tcfg = _cfgs("img_aux")
    _, tp = _params(jcfg, tcfg, 0)
    monkeypatch.delenv("FEDCOLA_PRETRAIN_VIT_TEST_PATCH16_32", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))      # no cache to walk
    with caplog.at_level(logging.WARNING):
        assert tpre.load_pretrained_vit(tcfg, tp, "vit_test_patch16_32") \
            is tp
    assert "not found locally" in caplog.text
    caplog.clear()
    wide = tpre.write_timm_vit_checkpoint(       # D=16 against the model's 8
        str(tmp_path / "wide.npz"), embed_dim=16, depth=2, img_size=32)
    monkeypatch.setenv("FEDCOLA_PRETRAIN_VIT_TEST_PATCH16_32", wide)
    with caplog.at_level(logging.WARNING):
        assert tpre.load_pretrained_vit(tcfg, tp, "vit_test_patch16_32") \
            is tp
    assert "could not be remapped" in caplog.text


# ---------------------------------------------------------- init_weights --

INIT_TYPES = ["normal", "xavier", "xavier_uniform", "kaiming", "truncnorm",
              "orthogonal"]


def _kind(before, after):
    if np.array_equal(before, after):
        return "kept"
    if not after.any():
        return "zeroed"
    return "drawn"


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_init_weights_touches_the_leaves_jax_does(init_type):
    jcfg, tcfg = _cfgs("img_aux")
    jp, tp = _params(jcfg, tcfg, 0)
    jout = jax.tree_util.tree_map(
        np.asarray, jinit(jp, init_type, 0.02, jax.random.PRNGKey(3)))
    tout = convert.params_to_numpy(
        tinit(tp, init_type, 0.02, torch.Generator().manual_seed(3)))
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    kinds = {}
    for (path, before), j, t in zip(paths, jax.tree_util.tree_leaves(jout),
                                    jax.tree_util.tree_leaves(tout)):
        name = "/".join(p.key for p in path)
        assert t.shape == j.shape and t.dtype == j.dtype, name
        kinds[name] = _kind(before, t)
        assert kinds[name] == _kind(before, j), name
    assert {"kept", "zeroed", "drawn"} <= set(kinds.values())
    assert kinds["blk/0/norm1_bias"] == "kept"
    assert kinds["blk/0/qkv_bias"] == "zeroed"
    assert kinds["blk/0/qkv_kernel"] == "drawn"
    assert kinds["emb/0/patch_kernel"] == "drawn"
    assert kinds["aux/qkv_aux"] == "kept"       # not a Linear module's weight


@pytest.mark.parametrize("init_type", INIT_TYPES + ["none"])
def test_init_weights_spread(init_type):
    W = 256
    gain = 0.5
    tree = {"blk": {"0": {"fc1_kernel": torch.zeros(2, W, W),
                          "fc1_bias": torch.ones(2, W)}},
            "emb": {"0": {"patch_kernel": torch.zeros(16, 16, 3, W)}}}
    out = tinit(tree, init_type, gain, torch.Generator().manual_seed(0))
    if init_type == "none":
        assert out is tree
        return
    k = out["blk"]["0"]["fc1_kernel"]
    assert not torch.equal(k[0], k[1])              # one draw per layer
    assert not out["blk"]["0"]["fc1_bias"].any()
    tn_std = 0.5 * math.sqrt(1 - 4 * 4 * math.exp(-8) / math.sqrt(2 * math.pi)
                             / math.erf(4 / math.sqrt(2)))
    want = {"normal": gain, "xavier": gain * math.sqrt(2 / (2 * W)),
            "xavier_uniform": gain * math.sqrt(6 / (2 * W)) / math.sqrt(3),
            "kaiming": math.sqrt(2 / W), "truncnorm": tn_std,
            "orthogonal": gain / math.sqrt(W)}[init_type]
    assert abs(k.std().item() - want) <= 0.05 * want, (k.std(), want)
    if init_type == "xavier_uniform":
        bound = gain * math.sqrt(6 / (2 * W))
        assert k.abs().max() <= bound and k.abs().max() > 0.99 * bound
    if init_type == "truncnorm":
        assert k.abs().max() <= 2.0
    if init_type == "orthogonal":
        q = k[0] / gain
        assert torch.allclose(q.T @ q, torch.eye(W), atol=1e-5)
    if init_type == "kaiming":
        # a conv's fans count its receptive field: [D, C, P, P] in torch
        p = out["emb"]["0"]["patch_kernel"]
        assert abs(p.std().item() - math.sqrt(2 / (3 * 256))) \
            <= 0.05 * math.sqrt(2 / (3 * 256))
