"""The port's rows-mode MLP (rows 7-10 of PERF.md's kernel table) against
the JAX package: ``fused_mlp`` and ``fused_mlp_sublayer`` on flattened
token rows, forward and every gradient, in the JAX signature (x
``[rows, D]``) and the client-stacked form that ``jax.vmap`` gives (n=2),
at row counts that are not multiples of the Pallas row tiles (512 forward,
256 backward).  The JAX functions run their Pallas kernels in interpret
mode on the CPU.

On CPU tensors the port's wrappers run their plain versions: these tests
pin the plain versions that ``chip_smoke.py`` holds the CUDA kernels
against on the card.  Tolerances: float32 atol 1e-5 (rtol 1e-4), bfloat16
max|d| within 2e-2 of max|ref| (both sides round at the same points; they
differ in summation order).  The output gradient is scaled by
1/sqrt(rows), so the weight gradients, sums over all rows, stay O(1) at
every row count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu.ops.fused_mlp import fused_mlp as jmlp
from fedcola_tpu.ops.fused_mlp import fused_mlp_sublayer as jsub
from fedcola_tpu_torch.ops import fused_mlp as tmlp
from fedcola_tpu_torch.ops import kernels

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NC, D, F = 2, 128, 256
MLP_W = ("w1", "b1", "w2", "b2")
LN_MLP_W = ("lns", "lnb") + MLP_W
FORMS = {"single": (), "stacked": (NC,)}


def _inputs(lead, rows, names, seed):
    r = np.random.RandomState(seed)
    shapes = {"x": (rows, D), "do": (rows, D), "lns": (D,), "lnb": (D,),
              "w1": (D, F), "b1": (F,), "w2": (F, D), "b2": (D,)}
    out = {}
    for k in ("x", "do") + names:
        shape = lead + shapes[k]
        if k == "lns":
            a = r.rand(*shape) + 0.5
        elif k == "w1":
            a = r.randn(*shape) / np.sqrt(D)
        elif k == "w2":
            a = r.randn(*shape) / np.sqrt(F)
        elif k.startswith("b") or k == "lnb":
            a = r.randn(*shape) * 0.1
        elif k == "do":
            # the weight gradients sum over all rows: keep them O(1)
            a = r.randn(*shape) / np.sqrt(rows)
        else:
            a = r.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


def _close(got, ref, dtype, name):
    got = np.asarray(got.detach().float(), np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    else:
        d = np.abs(got - ref).max()
        assert d <= 2e-2 * np.abs(ref).max(), (name, d, np.abs(ref).max())


def _against_jax(jfn, tfn, names, form, rows, dtype, seed):
    """Forward and every gradient of the JAX function (vmapped for the
    stacked form) and the port's on the same inputs; LN parameters stay
    float32, the rest is in the compute dtype."""
    jdt, tdt = DTYPES[dtype]
    a = _inputs(FORMS[form], rows, names, seed)
    lnp = lambda k: k.startswith("ln")
    cast_j = lambda k: jnp.asarray(a[k], jnp.float32 if lnp(k) else jdt)
    cast_t = lambda k: torch.from_numpy(a[k]).to(
        torch.float32 if lnp(k) else tdt)
    fn = jax.vmap(jfn) if form == "stacked" else jfn
    out_j, vjp = jax.vjp(fn, cast_j("x"), *[cast_j(k) for k in names])
    grads_j = vjp(cast_j("do"))
    leaves = [cast_t("x").requires_grad_(True)] + \
        [cast_t(k).requires_grad_(True) for k in names]
    out_t = tfn(*leaves)
    grads_t = torch.autograd.grad(out_t, leaves, cast_t("do"))
    assert out_t.dtype == tdt
    _close(out_t, out_j, dtype, "out")
    for leaf, g_t, g_j, nm in zip(leaves, grads_t, grads_j, ("x",) + names):
        assert g_t.dtype == leaf.dtype, nm
        _close(g_t, g_j, dtype, "d" + nm)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [40, 600, 1])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_fused_mlp_matches_pallas(form, rows, dtype):
    """Rows 7 and 8: ``fused_mlp`` against the JAX ``fused_mlp``
    (``_fwd_call`` and ``_bwd_call``)."""
    _against_jax(jmlp, tmlp.fused_mlp, MLP_W, form, rows, dtype, seed=rows)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [40, 600, 1])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_fused_mlp_sublayer_matches_pallas(form, rows, dtype):
    """Rows 9 and 10: ``fused_mlp_sublayer`` against the JAX
    ``fused_mlp_sublayer`` (``_ln_fwd_call`` and ``_ln_bwd_call``)."""
    _against_jax(jsub, tmlp.fused_mlp_sublayer, LN_MLP_W, form, rows, dtype,
                 seed=rows + 1)


def _stacked_torch(rows, names, dtype, seed):
    a = _inputs((NC,), rows, names, seed)
    return {k: torch.from_numpy(v).to(torch.float32 if k.startswith("ln")
                                      else dtype) for k, v in a.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_mode_matches_item_mode(dtype):
    """As the JAX test_item_mode_sublayer_matches_rows_mode: the rows-mode
    sublayer on flattened [n, B*N, D] against the item sublayer on
    [n, B, N, D], output and every gradient (both round at the same
    points, so they agree to summation order)."""
    B, N = 4, 12
    t = _stacked_torch(B * N, LN_MLP_W, DTYPES[dtype][1], seed=6)
    x = t["x"].requires_grad_(True)
    xi = t["x"].detach().reshape(NC, B, N, D).requires_grad_(True)
    w = [t[k].requires_grad_(True) for k in LN_MLP_W]
    wi = [t[k].detach().clone().requires_grad_(True) for k in LN_MLP_W]
    out_r = tmlp.fused_mlp_sublayer(x, *w)
    out_i = tmlp.fused_mlp_sublayer_items(xi, *wi)
    g_r = torch.autograd.grad(out_r, [x] + w, t["do"])
    g_i = torch.autograd.grad(out_i, [xi] + wi, t["do"].reshape(xi.shape))
    _close(out_r.reshape(out_i.shape), out_i.detach().float().numpy(), dtype,
           "out")
    for a, b, nm in zip(g_r, g_i, ("x",) + LN_MLP_W):
        _close(a.reshape(b.shape), b.float().numpy(), dtype, "d" + nm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_backward_is_the_plain_backward(dtype):
    """FusedMLPRows and FusedMLPSublayerRows save only their inputs and
    return exactly ``mlp_bwd_rows`` / ``mlp_ln_bwd_rows`` of them, each
    gradient in its parameter's dtype."""
    for fn, bwd, names in ((tmlp.fused_mlp, tmlp.mlp_bwd_rows_plain, MLP_W),
                           (tmlp.fused_mlp_sublayer,
                            tmlp.mlp_ln_bwd_rows_plain, LN_MLP_W)):
        t = _stacked_torch(33, names, dtype, seed=9)
        leaves = [t["x"].clone().requires_grad_(True)] + \
            [t[k].clone().requires_grad_(True) for k in names]
        got = torch.autograd.grad(fn(*leaves), leaves, t["do"])
        ref = bwd(t["x"], *[t[k] for k in names[:-1]], t["do"])
        for g, r, leaf in zip(got, ref, leaves):
            torch.testing.assert_close(g, r.to(leaf.dtype), rtol=0, atol=0)


def test_weights_in_float32_are_cast_as_the_pallas_kernels_cast_them():
    """x in bfloat16 with float32 weights: the forward runs on the weights
    rounded to bfloat16 (``_fwd_math`` casts them to x's dtype) and every
    gradient comes back in float32 without a bfloat16 rounding of its own
    (``_vjp_bwd`` casts the f32 sums to the parameter's dtype)."""
    t = _stacked_torch(20, MLP_W, torch.float32, seed=4)
    xb, dob = t["x"].bfloat16(), t["do"].bfloat16()
    w32 = [t[k].clone().requires_grad_(True) for k in MLP_W]
    out = tmlp.fused_mlp(xb, *w32)
    wb = [t[k].bfloat16() for k in MLP_W]
    torch.testing.assert_close(out, tmlp.mlp_fwd_rows_plain(xb, *wb),
                               rtol=0, atol=0)
    got = torch.autograd.grad(out, w32, dob)
    ref = tmlp.mlp_bwd_rows_plain(xb, *wb[:3], dob)[1:]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_cpu_rows_wrappers_do_not_count_launches():
    kernels.reset_launches()
    t = _stacked_torch(7, LN_MLP_W, torch.float32, seed=1)
    tmlp.mlp_fwd_rows(t["x"], *[t[k] for k in MLP_W])
    tmlp.mlp_bwd_rows(t["x"], *[t[k] for k in MLP_W[:3]], t["do"])
    tmlp.mlp_ln_fwd_rows(t["x"], *[t[k] for k in LN_MLP_W])
    tmlp.mlp_ln_bwd_rows(t["x"], *[t[k] for k in LN_MLP_W[:5]], t["do"])
    assert all(v == 0 for v in kernels.LAUNCHES.values())
