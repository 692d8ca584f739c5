"""The ``model`` mesh axis of the port (``parallel/mesh.py``
``TensorParallel``, the Megatron route of ``models/mat.py``) in one
process, on the CPU.

* The leaf rules, mirroring ``tests/test_mesh.py``'s leaf specs: which
  leaves shard and along which dimension, a sublayer whose width does not
  divide the axis replicated, and the head-aligned ``qkv`` cut, whose
  inverse gives back the whole leaf bit for bit.
* Each sharded sublayer (attention, MLP, the vocabulary-parallel word
  lookup, and all three) at m = 2 and m = 3 model ranks: the ranks are
  threads of this process and the route's collectives sums over them in
  rank order (``_Threads``), so the partials are summed in place of the
  all-reduces.  A txt-cls model with aux (non-zero scales, so the fold
  runs on the shards), depth 2, float32, at D=24 (the flash attention and
  the plain MLP) and D=384 (the flash attention and the no-residual item
  MLP): the output and every leaf gradient, the aux scales' and LN2's
  summed over the ranks, within 1e-5 of the whole model on one rank, and
  within 1e-4 of the JAX ``mat_apply`` of the same numpy weights.
* ``clip_global_norm`` and ``fedprox_term`` over shards against the whole
  tree, the term's gradient summed over the model ranks as ``descend``
  sums it.

The ranks' shards are put back by ``TensorParallel.join``, the server's
route, over the threads.
"""

import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu.models import mat as jmat
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models import mat as tmat
from fedcola_tpu_torch.ops import losses as tlosses
from fedcola_tpu_torch.parallel import mesh
from fedcola_tpu_torch.parallel import optim as toptim
from fedcola_tpu_torch.parallel.mesh import TensorParallel

TP_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)

_BASE = dict(modalities=(None, "txt"), tasks=(None, "cls"),
             num_classes=(None, 4), img_size=32, patch_size=16, depth=2,
             num_heads=6, vocab_size=30, max_text_len=10, with_aux=True,
             aux_trained=True, compute_dtype="float32", use_pallas=True,
             use_fused_mlp=True)
# D=24: flash attention, plain MLP; D=384: flash attention (the fused
# attention does not run under the axis) and the item MLP kernels' plain
# versions
WIDTHS = {"flash": dict(embed_dim=24), "fused": dict(embed_dim=384)}


class _Threads:
    """``m`` model ranks as threads of one process: ``run(fn)`` calls
    ``fn(rank)`` in each, and the collectives ``parallel/mesh.py`` makes
    are sums and lists over the threads, in rank order."""

    def __init__(self, m):
        self.m = m
        self.barrier = threading.Barrier(m, timeout=120)
        self.slots = [None] * m
        self.local = threading.local()

    def _exchange(self, t):
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        every = list(self.slots)
        self.barrier.wait()
        return every

    def all_reduce(self, t, group=None):
        every = self._exchange(t)
        total = every[0].clone()
        for x in every[1:]:
            total += x
        t.copy_(total)

    def all_gather(self, parts, t, group=None):
        for p, x in zip(parts, self._exchange(t)):
            p.copy_(x)

    def get_world_size(self, group=None):
        return self.m

    def run(self, fn):
        out, errors = [None] * self.m, []

        def go(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:      # re-raised in the caller
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=go, args=(r,))
                   for r in range(self.m)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def threads(monkeypatch):
    """A factory of ``_Threads`` whose collectives ``parallel/mesh.py``
    calls in place of ``torch.distributed``'s."""
    def make(m):
        t = _Threads(m)
        monkeypatch.setattr(mesh, "dist", types.SimpleNamespace(
            all_reduce=t.all_reduce, all_gather=t.all_gather,
            get_world_size=t.get_world_size))
        return t
    return make


def _shards(cfg, m, rank, sublayer):
    """The ``TensorParallel`` of one rank with ``sublayer`` sharded ('all':
    by the rules of ``TensorParallel.build``)."""
    tp = TensorParallel.build(cfg, m, rank, None)
    if sublayer == "all":
        return tp
    return TensorParallel(m, rank, None, *(s == sublayer
                                           for s in ("attn", "mlp", "word")))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------- rules ----

def test_tp_leaf_rules_and_the_head_aligned_cut(threads):
    """``tests/test_mesh.py``'s leaf specs on the port's rules; a sublayer
    whose width does not divide the axis stays whole; the qkv cut takes q,
    k and v of the rank's heads and its inverse is exact."""
    cfg = tmat.MATConfig(embed_dim=8, num_heads=2, mlp_ratio=4.0,
                         vocab_size=40)
    tp = TensorParallel.build(cfg, 2, 1, None)
    assert (tp.attn, tp.mlp, tp.word) == (True, True, True)
    tree = {"blk": {"0": {
        "fc1_kernel": torch.zeros(2, 2, 8, 32),
        "fc2_kernel": torch.zeros(2, 2, 32, 8),
        "qkv_bias": torch.zeros(2, 2, 24),
        "norm1_scale": torch.zeros(2, 2, 8),
    }}, "emb": {"1": {"word": torch.zeros(2, 40, 8)}}}
    assert [tp.dim(k) for k in ("fc1_kernel", "fc2_kernel", "qkv_bias",
                                "norm1_scale", "word")] == [3, 2, 2, None, 1]
    out = tp.cut(tree)
    b = out["blk"]["0"]
    assert tuple(b["fc1_kernel"].shape) == (2, 2, 8, 16)
    assert tuple(b["fc2_kernel"].shape) == (2, 2, 16, 8)
    assert tuple(b["qkv_bias"].shape) == (2, 2, 12)
    assert b["norm1_scale"] is tree["blk"]["0"]["norm1_scale"]
    assert tuple(out["emb"]["1"]["word"].shape) == (2, 20, 8)
    for name in ("proj_kernel", "proj_aux", "fc1_bias", "qkv_aux", "fc1_aux",
                 "fc2_aux", "qkv_kernel"):
        assert tp.dim(name) is not None, name
    for name in ("proj_bias", "fc2_bias", "qkv_scale", "norm2_bias", "pos",
                 "kernel", "scale"):
        assert tp.dim(name) is None, name

    # three ranks: 2 heads, F=32 and V=40 do not divide, so every leaf
    # stays whole; F=48 would
    odd = TensorParallel.build(cfg, 3, 0, None)
    assert (odd.attn, odd.mlp, odd.word) == (False, False, False)
    assert odd.cut(tree)["blk"]["0"]["fc1_kernel"] \
        is tree["blk"]["0"]["fc1_kernel"]
    assert TensorParallel.build(cfg.replace(mlp_ratio=6.0), 3, 0, None).mlp

    # the head-aligned cut: D=12, 6 heads of 2 over m in (2, 3)
    g = torch.Generator().manual_seed(0)
    D, H = 12, 6
    whole = {"qkv_kernel": torch.randn(2, 3, D, 3 * D, generator=g),
             "qkv_bias": torch.randn(2, 3, 3 * D, generator=g),
             "proj_kernel": torch.randn(2, 3, D, D, generator=g)}
    hcfg = tmat.MATConfig(embed_dim=D, num_heads=H)
    for m in (2, 3):
        tps = [TensorParallel.build(hcfg, m, r, None) for r in range(m)]
        cuts = [t.cut(whole) for t in tps]
        per = D // m
        for r, c in enumerate(cuts):
            cols = torch.cat([torch.arange(i * D + r * per, i * D + (r + 1)
                                           * per) for i in range(3)])
            assert torch.equal(c["qkv_kernel"], whole["qkv_kernel"][..., cols])
            assert torch.equal(c["qkv_bias"], whole["qkv_bias"][..., cols])
            assert torch.equal(c["proj_kernel"],
                               whole["proj_kernel"][:, :, r * per:
                                                    (r + 1) * per])
        for back in threads(m).run(lambda r: tps[r].join(cuts[r])):
            for k in whole:
                assert torch.equal(back[k], whole[k]), (m, k)
        # an unstacked tree (the round's global model) cuts alike
        one = {k: v[0] for k, v in whole.items()}
        for r, t in enumerate(tps):
            assert torch.equal(t.cut(one, lead=0)["qkv_kernel"],
                               cuts[r]["qkv_kernel"][0])


# ------------------------------------------------------------ sublayers ----

@functools.lru_cache(maxsize=None)
def _model(width):
    """``(jax cfg, torch cfg, numpy params, ids, cot, jax output, jax
    grads)`` of the txt-cls model at ``width``: aux scales made non-zero
    so the fold matters."""
    kw = dict(_BASE, **WIDTHS[width])
    jcfg, tcfg = jmat.MATConfig(**kw), tmat.MATConfig(**kw)
    r = np.random.RandomState(0)
    jparams = jmat.init_mat(jcfg, jax.random.PRNGKey(0))
    jparams["aux"] = {k: (v + jnp.asarray(r.rand(*v.shape) * 0.5,
                                          jnp.float32)
                          if k.endswith("_scale") else v)
                      for k, v in jparams["aux"].items()}
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    ids = r.randint(0, kw["vocab_size"], (3, 10)).astype(np.int32)
    cot = r.randn(3, 4).astype(np.float32)

    def jloss(p):
        out = jmat.mat_apply(jcfg, p, [None, jnp.asarray(ids)], train=True,
                             rng=jax.random.PRNGKey(1))[1]
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    return (tcfg, np_params, ids, cot, np.asarray(jout),
            {k: np.asarray(v) for k, v in _flat(jgrads).items()})


def _port_run(cfg, params, ids, cot, tp=None):
    """Output ``[n, B, C]`` and the gradient tree of one rank's forward
    (``params`` stacked ``[n, ...]``), the partial gradients summed over
    the model ranks as ``descend`` sums them."""
    params = tmat.tree_map(lambda t: t.clone().requires_grad_(True), params)
    out = tmat.mat_apply_stacked(cfg, params, [None, ids], train=True,
                                 gen=torch.Generator().manual_seed(0),
                                 tp=tp)[1]
    leaves = tmat.tree_leaves(params)
    grads = list(torch.autograd.grad((out * cot).sum(), leaves))
    if tp is not None:
        grads = tp.sum_partial_grads(params, grads)
    it = iter(grads)
    return out.detach(), _rebuild(params, it)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("sublayer", ["attn", "mlp", "word", "all"])
def test_tp_sublayer_matches_the_whole_model_and_jax(threads, sublayer, m,
                                                     width):
    cfg, np_params, ids, cot, jout, jgrads = _model(width)
    whole = tmat.tree_map(lambda t: t[None].contiguous(),
                          convert.params_from_jax(np_params, cfg=cfg))
    tids = torch.from_numpy(ids)[None]
    tcot = torch.from_numpy(cot)[None]
    want_out, want_grads = _port_run(cfg, whole, tids, tcot)

    tps = [_shards(cfg, m, r, sublayer) for r in range(m)]
    assert any((tps[0].attn, tps[0].mlp, tps[0].word))
    def rank(r):
        out, grads = _port_run(cfg, tps[r].cut(whole), tids, tcot, tps[r])
        return out, tps[r].join(grads)

    runs = threads(m).run(rank)
    for out, _ in runs:
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), **TP_TOL)
    got = _flat(runs[0][1])
    want = _flat(want_grads)
    assert sorted(got) == sorted(want) == sorted(jgrads)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg="/".join(k), **TP_TOL)
        np.testing.assert_allclose(got[k][0].numpy(), jgrads[k],
                                   err_msg="jax " + "/".join(k), **JAX_TOL)
    np.testing.assert_allclose(runs[0][0][0].numpy(), jout, **JAX_TOL)


# ------------------------------------------------- clipping and FedProx ----

def test_clip_and_fedprox_over_shards_match_the_whole_tree(threads):
    cfg, np_params, *_ = _model("flash")
    g = torch.Generator().manual_seed(3)
    glob = convert.params_from_jax(np_params, cfg=cfg)
    stacked = tmat.tree_map(
        lambda t: (t[None].repeat((2,) + (1,) * t.dim())
                   + 0.01 * torch.randn((2,) + tuple(t.shape), generator=g)),
        glob)
    grads = tmat.tree_map(lambda t: torch.randn(t.shape, generator=g),
                          stacked)
    frozen = tmat.tree_map(lambda t: False, stacked)
    frozen["aux"]["fc1_aux"] = True
    want_clip = toptim.clip_global_norm(grads, 0.5, frozen)
    p = tmat.tree_map(lambda t: t.clone().requires_grad_(True), stacked)
    want_prox = tlosses.fedprox_term(p, glob, 0.3)
    want_dprox = torch.autograd.grad(want_prox.sum(), tmat.tree_leaves(p))
    for m in (2, 3):
        tps = [TensorParallel.build(cfg, m, r, None) for r in range(m)]

        def rank(r):
            tp = tps[r]
            clipped = toptim.clip_global_norm(tp.cut(grads), 0.5, frozen, tp)
            shard = tmat.tree_map(lambda t: t.requires_grad_(True),
                                  tp.cut(stacked))
            prox = tlosses.fedprox_term(shard, tp.cut(glob, lead=0), 0.3, tp)
            # the term's gradient as ``descend`` takes it
            leaves = tmat.tree_leaves(shard)
            d = torch.autograd.grad(prox.sum(), leaves, allow_unused=True)
            d = tp.sum_partial_grads(shard, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, d)])
            return (tp.join(clipped), prox.detach(),
                    tp.join(_rebuild(shard, iter(d))))

        runs = threads(m).run(rank)
        clipped = _flat(runs[0][0])
        for k, v in _flat(want_clip).items():
            np.testing.assert_allclose(clipped[k].numpy(), v.numpy(),
                                       err_msg=str((m, k)), **TP_TOL)
        dprox = tmat.tree_leaves(runs[0][2])
        for _, prox, _ in runs:
            np.testing.assert_allclose(prox.numpy(), want_prox.detach()
                                       .numpy(), **TP_TOL)
        for a, b in zip(dprox, want_dprox):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TP_TOL)
