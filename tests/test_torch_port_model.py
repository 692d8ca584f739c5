"""The PyTorch port's model, losses, preprocessing, optimizer and
aggregation against the JAX package on the CPU (float32).

Model cases run the JAX XLA path of ``mat_apply`` (the CPU never takes the
Pallas kernels) against the port's forward on each of its routes: plain
ops (``use_pallas`` off), the flash route (a width off the 128 grid) and
the fused sublayers (D=128) under the 'kernel' and 'full' remat policies;
on CPU tensors the kernels' plain versions run.  Both start from identical
weights via ``models/convert.py``.  Tolerance 1e-4 (atol and rtol) unless
noted.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu.models import mat as jmat
from fedcola_tpu.ops import losses as jlosses
from fedcola_tpu.parallel import client_update as jcu
from fedcola_tpu.parallel import optim as joptim
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models import mat as tmat
from fedcola_tpu_torch.ops import flash_attention as tfa
from fedcola_tpu_torch.ops import fused_attention as tat
from fedcola_tpu_torch.ops import fused_mlp as tmlp
from fedcola_tpu_torch.ops import losses as tlosses
from fedcola_tpu_torch.parallel import client_update as tcu
from fedcola_tpu_torch.parallel import optim as toptim

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parents[1]

_BASE = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
             vocab_size=40, max_text_len=10, compute_dtype="float32",
             use_pallas=False, use_fused_mlp=False)
CASES = {
    "img_cls": dict(modalities=("img", None), tasks=("cls", None),
                    num_classes=(5, None), with_aux=True, aux_trained=True),
    "txt_cls": dict(modalities=(None, "txt"), tasks=(None, "cls"),
                    num_classes=(None, 4), with_aux=True, aux_trained=True),
    "img_txt_feat": dict(modalities=("img", "txt"), tasks=("rtv", "rtv"),
                         num_classes=(None, None), colearn_param="attn",
                         with_aux=True),
    # the flash route: a width off the 128 grid with the kernels on
    "img_cls_flash": dict(modalities=("img", None), tasks=("cls", None),
                          num_classes=(5, None), with_aux=True,
                          aux_trained=True, use_pallas=True,
                          use_fused_mlp=True),
    "img_txt_feat_flash": dict(modalities=("img", "txt"),
                               tasks=("rtv", "rtv"), num_classes=(None, None),
                               colearn_param="attn", use_pallas=True,
                               use_fused_mlp=True),
    # the fused sublayers on the 128 grid: residual-folded ('kernel') and
    # the remat pair (kernels 1e, 5, 3e, 6)
    "img_txt_feat_fused": dict(modalities=("img", "txt"),
                               tasks=("rtv", "rtv"), num_classes=(None, None),
                               colearn_param="attn", embed_dim=128,
                               use_pallas=True, use_fused_mlp=True),
    "txt_cls_fused_full": dict(modalities=(None, "txt"), tasks=(None, "cls"),
                               num_classes=(None, 4), with_aux=True,
                               aux_trained=True, embed_dim=128,
                               use_pallas=True, use_fused_mlp=True,
                               remat_policy="full"),
}


def _configs(case):
    kw = dict(_BASE, **CASES[case])
    return jmat.MATConfig(**kw), tmat.MATConfig(**kw)


def _inputs(jcfg, r):
    ins = []
    for m in jcfg.modalities:
        if m == "img":
            ins.append(r.randn(3, 32, 32, 3).astype(np.float32))
        elif m == "txt":
            ins.append(r.randint(0, 40, (3, 10)).astype(np.int32))
        else:
            ins.append(None)
    return ins


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mat_forward_and_grads_match_jax(case):
    jcfg, tcfg = _configs(case)
    r = np.random.RandomState(0)
    jparams = jmat.init_mat(jcfg, jax.random.PRNGKey(0))
    if "aux" in jparams:   # non-zero cross-modal scales exercise the fold
        jparams["aux"] = {k: (v + jnp.asarray(r.rand(*v.shape) * 0.5,
                                              jnp.float32)
                              if k.endswith("_scale") else v)
                          for k, v in jparams["aux"].items()}
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    ins = _inputs(jcfg, r)
    feat = case.startswith("img_txt_feat")
    slots = [i for i, m in enumerate(jcfg.modalities) if m is not None]
    cot = {i: r.randn(3, jcfg.embed_dim if feat else jcfg.num_classes[i])
           .astype(np.float32) for i in slots}

    def jloss(p, train):
        outs = jmat.mat_apply(jcfg, p, [None if a is None else jnp.asarray(a)
                                        for a in ins], feat_out=feat,
                              train=train, rng=jax.random.PRNGKey(1))
        return sum(jnp.sum(outs[i] * cot[i]) for i in slots), outs

    (_, jouts), jgrads = jax.value_and_grad(
        lambda p: jloss(p, True), has_aux=True)(jparams)
    _, jeval = jloss(jparams, False)

    tparams = convert.params_from_jax(np_params, cfg=tcfg)
    tparams = tmat.tree_map(lambda t: t.requires_grad_(True), tparams)
    tins = [None if a is None else torch.from_numpy(a) for a in ins]
    touts = tmat.mat_apply(tcfg, tparams, tins, feat_out=feat, train=True,
                           gen=torch.Generator().manual_seed(0))
    loss = sum((touts[i] * torch.from_numpy(cot[i])).sum() for i in slots)
    flat_t = _flat(tparams)
    paths = sorted(flat_t)
    tgrads = torch.autograd.grad(loss, [flat_t[p] for p in paths])
    with torch.no_grad():
        teval = tmat.mat_apply(tcfg, tparams, tins, feat_out=feat)

    for i in slots:
        np.testing.assert_allclose(touts[i].detach().numpy(),
                                   np.asarray(jouts[i]), err_msg=f"out{i}",
                                   **TOL)
        np.testing.assert_allclose(teval[i].numpy(), np.asarray(jeval[i]),
                                   err_msg=f"eval{i}", **TOL)
    flat_j = _flat(jgrads)
    assert sorted(flat_j) == paths
    for p, g in zip(paths, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(flat_j[p]),
                                   err_msg="/".join(p), **TOL)


def test_convert_roundtrip_and_tree_check():
    jcfg, tcfg = _configs("img_txt_feat")
    np_params = jax.tree_util.tree_map(
        np.asarray, jmat.init_mat(jcfg, jax.random.PRNGKey(3)))
    back = convert.params_to_numpy(convert.params_from_jax(np_params,
                                                           cfg=tcfg), cfg=tcfg)
    fa, fb = _flat(np_params), _flat(back)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    # the colearn-tied leaves are absent from the non-main slot
    assert "qkv_kernel" not in np_params["blk"]["1"]
    bad = dict(np_params, blk=dict(np_params["blk"]))
    bad["blk"]["1"] = dict(bad["blk"]["1"], qkv_kernel=np.zeros((2, 32, 96)))
    with pytest.raises(ValueError):
        convert.params_from_jax(bad, cfg=tcfg)


def test_preprocess_images_upsample_matches_jax():
    """32 -> 224 bilinear (F.interpolate, align_corners=False, no
    antialias) + imnorm against jax.image.resize."""
    x = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    jspec = jcu.GroupSpec(modality="img", criterion="CrossEntropyLoss",
                          resize_to=224, imnorm=True)
    tspec = tcu.GroupSpec(modality="img", criterion="CrossEntropyLoss",
                          resize_to=224, imnorm=True)
    ref = np.asarray(jcu.preprocess_images(jnp.asarray(x), jspec,
                                           jnp.float32))
    got = tcu.preprocess_images(torch.from_numpy(x), tspec,
                                torch.float32).numpy()
    assert got.shape == ref.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_losses_with_valid_masks_match_jax():
    r = np.random.RandomState(0)
    logits = r.randn(6, 7).astype(np.float32) * 3
    y = r.randint(0, 7, 6).astype(np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    img = r.randn(6, 8).astype(np.float32)
    txt = r.randn(6, 8).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else torch.from_numpy(v)
        np.testing.assert_allclose(
            float(tlosses.cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(y), tv)),
            float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                        jv)), rtol=1e-5)
        np.testing.assert_allclose(
            float(tlosses.clip_contrastive(torch.from_numpy(img),
                                           torch.from_numpy(txt), tv)),
            float(jlosses.clip_contrastive(jnp.asarray(img), jnp.asarray(txt),
                                           jv)), rtol=1e-5)
    # stacked clients: one loss per leading index
    stacked = tlosses.cross_entropy(torch.from_numpy(np.stack([logits] * 2)),
                                    torch.from_numpy(np.stack([y] * 2)),
                                    torch.from_numpy(np.stack([valid] * 2)))
    assert stacked.shape == (2,)


def test_adamw_steps_with_step_valid_and_frozen_match_jax():
    """Three AdamW steps over a 2-client stacked tree: per-client
    step_valid patterns and a frozen leaf (no update, no decay)."""
    r = np.random.RandomState(0)
    spec_kw = dict(name="AdamW", weight_decay=0.05)
    params = {"a": r.randn(2, 3, 4).astype(np.float32),
              "b": {"c": r.randn(2, 5).astype(np.float32),
                    "d": r.randn(2, 2, 2).astype(np.float32)}}
    frozen = {"a": False, "b": {"c": True, "d": False}}
    grads = [jax.tree_util.tree_map(
        lambda p: r.randn(*p.shape).astype(np.float32), params)
        for _ in range(3)]
    valid = np.array([[1, 1], [1, 0], [0, 1]], bool)
    lr = 1e-2

    tspec = toptim.OptimizerSpec(**spec_kw)
    tp = tmat.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    ts = toptim.init_opt_state(tspec, tp, 2)
    for g, v in zip(grads, valid):
        toptim.opt_update(tspec, tp, tmat.tree_map(torch.from_numpy, g), ts,
                          lr, frozen=frozen, step_valid=torch.from_numpy(v))

    jspec = joptim.OptimizerSpec(**spec_kw)
    for c in range(2):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[c]), params)
        js = joptim.init_opt_state(jspec, jp)
        for g, v in zip(grads, valid):
            jp, js = joptim.opt_update(
                jspec, jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a[c]),
                                                  g),
                js, jnp.float32(lr), frozen=frozen,
                step_valid=jnp.asarray(v[c]))
        for path, val in _flat(jp).items():
            got = _flat(tp)[path][c].numpy()
            np.testing.assert_allclose(got, np.asarray(val), atol=1e-6,
                                       rtol=1e-5, err_msg=str(path))
        for path, t in _flat(js["t"]).items():
            assert int(_flat(ts["t"])[path][c]) == int(t), path
    # the frozen leaf never moved
    np.testing.assert_array_equal(tp["b"]["c"].numpy(), params["b"]["c"])


def test_port_imports_no_jax():
    """No module of fedcola_tpu_torch, nor chip_smoke.py, imports jax or
    fedcola_tpu: by source (ast) and by sys.modules after a fresh import
    of every module in a subprocess."""
    import ast
    files = sorted((REPO / "fedcola_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]

    def banned(name):
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "fedcola_tpu")

    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(banned(n) for n in names), (f, names)
    mods = [".".join(f.relative_to(REPO).with_suffix("").parts)
            for f in files if f.name != "chip_smoke.py"]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "importlib.import_module('chip_smoke')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fedcola_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_device_cuda_without_a_card_raises():
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.config import parse_args
    assert parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--device", "cuda", "--synthetic_data"])


ROUTES = {
    # case: (config overrides, wrappers of a training step, of an eval)
    "off_grid_flash": (dict(embed_dim=48), {"flash_fwd", "flash_bwd"},
                       {"flash_fwd"}),
    "grid_kernel": (dict(), {"attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"},
                    {"attn_fwd", "mlp_fwd"}),
    "grid_save_attn": (dict(remat_policy="save_attn"),
                       {"attn_fwd", "attn_bwd_recompute", "mlp_fwd",
                        "mlp_bwd_nores"}, {"attn_fwd", "mlp_fwd"}),
    "grid_full": (dict(remat_policy="full"),
                  {"attn_fwd", "attn_bwd_recompute", "mlp_fwd",
                   "mlp_bwd_nores"}, {"attn_fwd", "mlp_fwd"}),
    "grid_short_stack": (dict(fused_attn_min_seq=8),
                         {"mlp_fwd", "mlp_bwd_nores"}, {"mlp_fwd"}),
    "no_pallas": (dict(use_pallas=False, use_fused_mlp=False), set(), set()),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_stack_routing_follows_jax(case, monkeypatch):
    """Which kernel wrappers a training step and an eval forward reach, per
    route: width off the 128 grid -> flash; 'kernel' -> rows 1-4; the remat
    policies -> rows 1e, 5, 3e, 6; a stack below fused_attn_min_seq ->
    plain attention with the fused MLP; --no_pallas -> none."""
    over, want_train, want_eval = ROUTES[case]
    seen = set()

    def record(mod, name, key=None):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.add(key(a) if key else name)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("attn_fwd", "attn_bwd", "attn_bwd_recompute"):
        record(tat, name)
    record(tmlp, "mlp_fwd")
    record(tmlp, "mlp_bwd",
           lambda a: "mlp_bwd" if a[1] is not None else "mlp_bwd_nores")
    record(tfa, "flash_fwd")
    record(tfa, "flash_bwd")

    cfg = tmat.MATConfig(**{**dict(
        modalities=("img", None), tasks=("cls", None), num_classes=(3, None),
        img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
        compute_dtype="float32", use_pallas=True, use_fused_mlp=True,
        drop_path_rate=0.1), **over})
    params = tmat.tree_map(lambda t: t.requires_grad_(True),
                           tmat.init_mat(cfg, torch.Generator().manual_seed(0)))
    img = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3)
                           .astype(np.float32))
    out = tmat.mat_apply(cfg, params, [img, None], train=True,
                         gen=torch.Generator().manual_seed(1))[0]
    out.sum().backward()
    assert seen == want_train
    seen.clear()
    with torch.no_grad():
        tmat.mat_apply(cfg, params, [img, None])
    assert seen == want_eval


def test_kernel_support_refuses_uncovered_shapes():
    """On the card, check_kernel_support passes every registered width
    (mome_tiny's D=192 on the flash route), --no_pallas, the remat policies
    and sequences past 256 tokens on both routes (300, and 2048 where the
    flash route runs the plain attention), and refuses head_dim > 64 (a
    width above 1024 at 6 heads, or 1152 at 3)."""
    base = tmat.MATConfig(embed_dim=384, use_pallas=True, use_fused_mlp=True)
    tiny = dataclasses.replace(base, embed_dim=192, num_heads=3)
    for ok in (base, tiny,
               dataclasses.replace(base, embed_dim=768, num_heads=12),
               dataclasses.replace(base, use_pallas=False),
               dataclasses.replace(base, remat_policy="save_attn"),
               dataclasses.replace(base, remat_policy="full"),
               dataclasses.replace(base, max_text_len=300),
               dataclasses.replace(tiny, max_text_len=2048)):
        tmat.check_kernel_support(ok)
    for bad in (dataclasses.replace(base, embed_dim=1152),
                dataclasses.replace(base, embed_dim=1152, num_heads=3)):
        with pytest.raises(NotImplementedError):
            tmat.check_kernel_support(bad)
