"""The PyTorch port's fused sublayers against the JAX package's Pallas
kernels (interpret mode on the CPU): forward, the saved P / head concat,
and every gradient, client-stacked over n=2.

On CPU tensors the port's wrappers run their plain versions, so these tests
pin the plain versions that ``chip_smoke.py`` holds the CUDA kernels
against on the card.  Tolerance: atol 1e-5, rtol 1e-4 (float32 both sides;
the two differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu.ops.fused_attention import (
    _fwd_save_call, make_fused_attention_residual_sublayer,
    make_fused_attention_sublayer)
from fedcola_tpu.ops.fused_mlp import (fused_mlp_residual_sublayer_items,
                                       fused_mlp_sublayer_items)
from fedcola_tpu_torch.ops import fused_attention as tat
from fedcola_tpu_torch.ops import fused_mlp as tmlp
from fedcola_tpu_torch.ops import kernels

NC, B, D, H = 2, 2, 16, 2
TOL = dict(atol=1e-5, rtol=1e-4)


def _attn_inputs(N, seed=0):
    r = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=r.randn(NC, B, N, D).astype(f),
        s=r.choice([0.0, 1.0 / 0.9], size=(NC, B)).astype(f),
        lns=(r.rand(NC, D) + 0.5).astype(f),
        lnb=(r.randn(NC, D) * 0.1).astype(f),
        wqkv=(r.randn(NC, D, 3 * D) * 0.2).astype(f),
        bqkv=(r.randn(NC, 3 * D) * 0.1).astype(f),
        wproj=(r.randn(NC, D, D) * 0.2).astype(f),
        bproj=(r.randn(NC, D) * 0.1).astype(f),
        do=r.randn(NC, B, N, D).astype(f))


def _mlp_inputs(N, seed=0):
    r = np.random.RandomState(seed)
    f = np.float32
    F = 4 * D
    return dict(
        x=r.randn(NC, B, N, D).astype(f),
        s=r.choice([0.0, 1.0 / 0.9], size=(NC, B)).astype(f),
        lns=(r.rand(NC, D) + 0.5).astype(f),
        lnb=(r.randn(NC, D) * 0.1).astype(f),
        w1=(r.randn(NC, D, F) * 0.2).astype(f),
        b1=(r.randn(NC, F) * 0.1).astype(f),
        w2=(r.randn(NC, F, D) * 0.2).astype(f),
        b2=(r.randn(NC, D) * 0.1).astype(f),
        do=r.randn(NC, B, N, D).astype(f))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=name, **TOL)


ATTN_W = ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")
MLP_W = ("lns", "lnb", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("N", [12, 5])
def test_attention_residual_train_matches_pallas(N):
    """Kernels 1 (save, residual) and 2 against _fwd_save_call and the
    residual sublayer's custom VJP."""
    a = _attn_inputs(N)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    fn = jax.vmap(make_fused_attention_residual_sublayer(H))
    w = [j[k] for k in ATTN_W]
    out_j, vjp = jax.vjp(lambda x, *w: fn(x, j["s"], *w), j["x"], *w)
    grads_j = vjp(j["do"])
    _, p_j, cat_j = _fwd_save_call(
        H, j["x"], j["lns"][:, None], j["lnb"][:, None], j["wqkv"],
        j["bqkv"][:, None], j["wproj"], j["bproj"][:, None], s=j["s"])

    x = _t(a["x"], True)
    wt = [_t(a[k], True) for k in ATTN_W]
    out_t = tat.fused_attention_residual(x, _t(a["s"]), *wt, H)
    grads_t = torch.autograd.grad(out_t, [x] + wt, _t(a["do"]))
    _, p_t, cat_t = tat.attn_fwd(_t(a["x"]), _t(a["s"]),
                                 *[_t(a[k]) for k in ATTN_W], H, save=True)

    _close(out_t.detach(), out_j, "out")
    _close(p_t, p_j, "P")
    _close(cat_t, cat_j, "cat")
    for g_t, g_j, nm in zip(grads_t, grads_j, ("dx",) + ATTN_W):
        _close(g_t, g_j, "d" + nm)


@pytest.mark.parametrize("N", [12, 5])
def test_attention_eval_matches_pallas(N):
    """Kernel 1 with save=False, no residual, against _fwd_call."""
    a = _attn_inputs(N, seed=1)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    fn = jax.vmap(make_fused_attention_sublayer(H, save_residuals=False))
    ref = fn(j["x"], *[j[k] for k in ATTN_W])
    out = tat.fused_attention(_t(a["x"]), *[_t(a[k]) for k in ATTN_W], H)
    _close(out, ref, "out")


@pytest.mark.parametrize("N", [12, 5])
def test_mlp_residual_train_matches_pallas(N):
    """Kernels 3 (residual) and 4 against the residual item sublayer."""
    a = _mlp_inputs(N)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    fn = jax.vmap(fused_mlp_residual_sublayer_items)
    w = [j[k] for k in MLP_W]
    out_j, vjp = jax.vjp(lambda x, *w: fn(x, j["s"], *w), j["x"], *w)
    grads_j = vjp(j["do"])

    x = _t(a["x"], True)
    wt = [_t(a[k], True) for k in MLP_W]
    out_t = tmlp.fused_mlp_residual_sublayer_items(x, _t(a["s"]), *wt)
    grads_t = torch.autograd.grad(out_t, [x] + wt, _t(a["do"]))
    _close(out_t.detach(), out_j, "out")
    for g_t, g_j, nm in zip(grads_t, grads_j, ("dx",) + MLP_W):
        _close(g_t, g_j, "d" + nm)


@pytest.mark.parametrize("N", [12, 5])
def test_mlp_eval_matches_pallas(N):
    """Kernel 3 without the residual against fused_mlp_sublayer_items."""
    a = _mlp_inputs(N, seed=1)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref = jax.vmap(fused_mlp_sublayer_items)(j["x"], *[j[k] for k in MLP_W])
    out = tmlp.fused_mlp_sublayer_items(_t(a["x"]),
                                        *[_t(a[k]) for k in MLP_W])
    _close(out, ref, "out")


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters move only where a kernel goes to the card."""
    kernels.reset_launches()
    a = _mlp_inputs(5)
    tmlp.fused_mlp_sublayer_items(_t(a["x"]), *[_t(a[k]) for k in MLP_W])
    assert all(v == 0 for v in kernels.LAUNCHES.values())

