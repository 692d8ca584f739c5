"""The port's flash-attention kernels (rows 11 and 12), the recompute
attention backward (row 5) and the no-residual MLP backward (row 6)
against the JAX package's Pallas kernels (interpret mode on the CPU), and
the remat policies of the port's model against each other.

On CPU tensors the wrappers run their plain versions: these tests pin the
plain versions that ``chip_smoke.py`` holds the CUDA kernels against on the
card.  Tolerances: float32 atol 1e-5 (rtol 1e-4), bfloat16 max|d| within
2e-2 of max|ref| (both sides round at the same points; they differ in
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu.ops.flash_attention import flash_attention as jflash
from fedcola_tpu.ops.fused_attention import make_fused_attention_sublayer
from fedcola_tpu.ops.fused_mlp import fused_mlp_sublayer_items
from fedcola_tpu_torch.models import mat as tmat
from fedcola_tpu_torch.ops import flash_attention as tfa
from fedcola_tpu_torch.ops import fused_attention as tat
from fedcola_tpu_torch.ops import fused_mlp as tmlp

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, ref, dtype, name):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    else:
        d = np.abs(got - ref).max()
        assert d <= 2e-2 * np.abs(ref).max(), (name, d, np.abs(ref).max())


# ------------------------------------------------------- rows 11, 12 -------

FLASH_SHAPES = {
    "B2H2N12hd8": (2, 2, 12, 8),
    "B2H3N5hd16": (2, 3, 5, 16),
    "clients2B2H2N7hd8": (2, 2, 2, 7, 8),   # client-stacked [n, B, H, N, hd]
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_matches_pallas(shape, dtype):
    """flash_fwd / flash_bwd (plain) against ``flash_attention`` and its
    ``jax.vjp`` (the Pallas kernels in interpret mode), vmapped over the
    client axis for the stacked shape."""
    shp = FLASH_SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    r = np.random.RandomState(len(shp) + shp[-2])
    q, k, v, do = (r.randn(*shp).astype(np.float32) for _ in range(4))
    scale = shp[-1] ** -0.5
    fn = lambda q_, k_, v_: jflash(q_, k_, v_, scale)
    if len(shp) == 5:
        fn = jax.vmap(fn)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    out_j, vjp = jax.vjp(fn, jq, jk, jv)
    grads_j = vjp(jdo)

    tq, tk, tv, tdo = (_to_torch(a, tdt) for a in (q, k, v, do))
    out_t = tfa.flash_fwd(tq, tk, tv, scale)
    grads_t = tfa.flash_bwd(tq, tk, tv, tdo, scale)
    assert out_t.dtype == tdt and all(g.dtype == tdt for g in grads_t)
    _close(out_t, out_j, dtype, "o")
    for g_t, g_j, nm in zip(grads_t, grads_j, ("dq", "dk", "dv")):
        _close(g_t, g_j, dtype, nm)


def test_flash_autograd_matches_plain_backward():
    """FlashAttention's backward is flash_bwd of the saved q, k, v."""
    r = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(r.randn(2, 2, 9, 8).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, 8 ** -0.5)
    got = torch.autograd.grad(out, leaves, do)
    for g, ref in zip(got, tfa.flash_bwd(q, k, v, do, 8 ** -0.5)):
        torch.testing.assert_close(g, ref, rtol=0, atol=0)


# ------------------------------------------------------------ rows 5, 6 -----

NC, B, D, H = 2, 2, 16, 2
ATTN_W = ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")
MLP_W = ("lns", "lnb", "w1", "b1", "w2", "b2")


def _sublayer_inputs(N, names, seed):
    r = np.random.RandomState(seed)
    shapes = {"x": (NC, B, N, D), "do": (NC, B, N, D), "lns": (NC, D),
              "lnb": (NC, D), "wqkv": (NC, D, 3 * D), "bqkv": (NC, 3 * D),
              "wproj": (NC, D, D), "bproj": (NC, D), "w1": (NC, D, 4 * D),
              "b1": (NC, 4 * D), "w2": (NC, 4 * D, D), "b2": (NC, D)}
    out = {}
    for k in names:
        if k == "lns":
            a = r.rand(*shapes[k]) + 0.5
        elif k.startswith("w"):
            a = r.randn(*shapes[k]) * 0.2
        elif k.startswith("b") or k == "lnb":
            a = r.randn(*shapes[k]) * 0.1
        else:
            a = r.randn(*shapes[k])
        out[k] = a.astype(np.float32)
    return out


def _grads_both(jfn, tfn, a, wnames, dtype):
    """Forward and every gradient of a vmapped JAX sublayer and the port's
    autograd sublayer on the same inputs; LN parameters stay float32."""
    jdt, tdt = DTYPES[dtype]
    cast_j = lambda k: jnp.asarray(a[k], jnp.float32 if k.startswith("ln")
                                   else jdt)
    cast_t = lambda k: _to_torch(a[k], torch.float32 if k.startswith("ln")
                                 else tdt)
    out_j, vjp = jax.vjp(jax.vmap(jfn), cast_j("x"),
                         *[cast_j(k) for k in wnames])
    grads_j = vjp(cast_j("do"))
    leaves = [cast_t("x").requires_grad_(True)] + \
        [cast_t(k).requires_grad_(True) for k in wnames]
    out_t = tfn(*leaves)
    grads_t = torch.autograd.grad(out_t, leaves, cast_t("do"))
    _close(out_t, out_j, dtype, "out")
    for g_t, g_j, nm in zip(grads_t, grads_j, ("x",) + wnames):
        _close(g_t, g_j, dtype, "d" + nm)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [12, 5])
def test_attention_recompute_backward_matches_pallas(N, dtype):
    """Row 5: FusedAttention (kernel 1 without saves, then
    attn_bwd_recompute) against make_fused_attention_sublayer(
    save_residuals=False), whose backward is _bwd_call."""
    a = _sublayer_inputs(N, ("x", "do") + ATTN_W, seed=N)
    _grads_both(make_fused_attention_sublayer(H, save_residuals=False),
                lambda x, *w: tat.fused_attention(x, *w, H), a, ATTN_W,
                dtype)


def test_recompute_backward_keeps_p_in_f32():
    """In bf16 the recompute backward differs from kernel 2 fed with the
    bf16-saved P (the softmax gradient uses the f32 P); in f32 the two are
    the same function."""
    a = _sublayer_inputs(12, ("x", "do") + ATTN_W, seed=7)
    for dt, same in ((torch.float32, True), (torch.bfloat16, False)):
        t = {k: _to_torch(v, torch.float32 if k.startswith("ln") else dt)
             for k, v in a.items()}
        w = [t[k] for k in ATTN_W]
        _, P, cat = tat.attn_fwd_plain(t["x"], None, *w, H)
        saved = tat.attn_bwd_plain(t["x"], None, *w[:5], P, cat, t["do"], H)
        recomputed = tat.attn_bwd_recompute_plain(t["x"], *w[:5], t["do"], H)
        diffs = [(s - r).abs().max().item()
                 for s, r in zip(saved, recomputed)]
        if same:
            assert max(diffs) <= 1e-5, diffs
        else:
            assert max(diffs) > 0, diffs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [12, 5])
def test_mlp_nores_backward_matches_pallas(N, dtype):
    """Row 6: FusedMLPItems (kernel 3 and mlp_bwd with s=None) against
    fused_mlp_sublayer_items, whose backward is _ln_item_bwd_call with
    residual=False."""
    a = _sublayer_inputs(N, ("x", "do") + MLP_W, seed=20 + N)
    _grads_both(fused_mlp_sublayer_items, tmlp.fused_mlp_sublayer_items, a,
                MLP_W, dtype)


# ---------------------------------------------------------- remat ----------

REMAT_ROUTES = {
    # width off the 128 grid (flash route): 'kernel' falls back to
    # 'save_attn' there; 'full' checkpoints the whole layer
    "flash": (dict(embed_dim=32), ("kernel", "save_attn", "full")),
    # the fused sublayers: 'kernel' (rows 1-4) vs the remat pair
    "fused": (dict(embed_dim=128), ("kernel", "save_attn", "full")),
}


@pytest.mark.parametrize("route", sorted(REMAT_ROUTES))
def test_remat_policies_give_the_same_gradients(route):
    """The port's counterpart of the JAX remat test: features and every
    leaf gradient agree across policies (float32, DropPath on: the draws
    come from one generator seed in the same order on every policy)."""
    over, policies = REMAT_ROUTES[route]
    base = tmat.MATConfig(modalities=("img", "txt"), tasks=("rtv", "rtv"),
                          num_classes=(None, None), img_size=32,
                          patch_size=16, depth=2, num_heads=2, vocab_size=40,
                          max_text_len=10, colearn_param="attn",
                          compute_dtype="float32", use_pallas=True,
                          use_fused_mlp=True, drop_path_rate=0.3, **over)
    params = tmat.init_mat(base, torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    img = torch.from_numpy(r.randn(3, 32, 32, 3).astype(np.float32))
    ids = torch.from_numpy(r.randint(0, 40, (3, 10)).astype(np.int64))
    results = []
    for pol in policies:
        cfg = base.replace(remat_policy=pol)
        p = tmat.tree_map(lambda t: t.clone().requires_grad_(True), params)
        fi, ft = tmat.mat_apply(cfg, p, [img, ids], feat_out=True,
                                train=True,
                                gen=torch.Generator().manual_seed(5))
        loss = (fi * ft).sum() + fi.square().sum()
        grads = torch.autograd.grad(loss, tmat.tree_leaves(p))
        results.append((fi.detach(), ft.detach(), grads))
    ref = results[0]
    for pol, got in zip(policies[1:], results[1:]):
        for g, rr in zip(got[:2], ref[:2]):
            torch.testing.assert_close(g, rr, atol=1e-5, rtol=1e-5,
                                       msg=lambda m: f"{pol}: {m}")
        for g, rr in zip(got[2], ref[2]):
            torch.testing.assert_close(g, rr, atol=1e-5, rtol=1e-4,
                                       msg=lambda m: f"{pol}: {m}")
