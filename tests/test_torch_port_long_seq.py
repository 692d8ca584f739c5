"""Sequences longer than 256 tokens: the PyTorch port against the JAX
package on the CPU (float32).

Past N = 256 the port's attention kernels stream the keys
(``kernels.streams_keys``); on CPU tensors the wrappers run the plain
versions, which ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``
hold those kernels against on the card.  Here:

* rows 1, 1e, 2 and 5 (``attn_fwd`` with and without saves,
  ``attn_bwd``, ``attn_bwd_recompute``) against ``_fwd_save_call``,
  ``_fwd_call``, ``_bwd_save_call`` and ``_bwd_call`` in Pallas interpret
  mode at N = 264 and 300;
* rows 11 and 12 against the JAX ``flash_attention`` (its Pallas kernels in
  interpret mode) at N = 300, and at N = 1100, past ``MAX_FUSED_SEQ``,
  where both packages run their plain attention, forward and gradients;
* the predicates, the streamed kernels' shared memory and the streamed
  backward's launch arguments;
* the model at ``max_text_len`` 300 on both routes, and one FedAvg round of
  the MedicalAbstracts line at ``--seq_len 300`` through both servers.

Tolerances as the other parity tests: kernels atol 1e-5 / rtol 1e-4, the
model 1e-4, the round's loss 1e-5 relative with acc1 and f1 equal.  The
attention sublayer's weight gradients sum over B * N = 600 rows here, so
its upstream gradient is drawn at 0.1 (a gradient of order one would put
the f32 rounding of those sums, in a different order in each package, at
the atol).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedcola_tpu import config as jconfig
from fedcola_tpu.data.loaders import load_federated_data as jload
from fedcola_tpu.federation.server import create_server as jcreate
from fedcola_tpu.models import mat as jmat
from fedcola_tpu.ops.flash_attention import flash_attention as jflash
from fedcola_tpu.ops.fused_attention import (_bwd_call, _bwd_save_call,
                                             _fwd_call, _fwd_save_call)
from fedcola_tpu_torch import config as tconfig
from fedcola_tpu_torch import main as tmain
from fedcola_tpu_torch.data.loaders import load_federated_data as tload
from fedcola_tpu_torch.federation.server import create_server as tcreate
from fedcola_tpu_torch.models import convert
from fedcola_tpu_torch.models import mat as tmat
from fedcola_tpu_torch.ops import flash_attention as tfl
from fedcola_tpu_torch.ops import fused_attention as tat
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.ops.attention import attention_xla

TOL = dict(atol=1e-5, rtol=1e-4)
NC, B, D, H = 1, 2, 128, 2


def _close(a, b, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=name, **tol)


def _attn_inputs(N, seed):
    r = np.random.RandomState(seed)
    f = np.float32
    return dict(
        x=r.randn(NC, B, N, D).astype(f),
        s=r.choice([0.0, 1.0 / 0.9], size=(NC, B)).astype(f),
        lns=(r.rand(NC, D) + 0.5).astype(f),
        lnb=(r.randn(NC, D) * 0.1).astype(f),
        wqkv=(r.randn(NC, D, 3 * D) * 0.1).astype(f),
        bqkv=(r.randn(NC, 3 * D) * 0.1).astype(f),
        wproj=(r.randn(NC, D, D) * 0.1).astype(f),
        bproj=(r.randn(NC, D) * 0.1).astype(f),
        da=(r.randn(NC, B, N, D) * 0.1).astype(f))


GRADS = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj")


@pytest.mark.parametrize("N", [264, 300])
def test_fused_attention_rows_match_pallas(N):
    """Rows 1 (save, residual) and 1e (eval), 2 from the saves and 5
    recomputing, past the resident kernels' 256 keys."""
    a = _attn_inputs(N, seed=N)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    per = lambda k: j[k][:, None]          # the JAX calls' [n, 1, C] leaves
    jw = (per("lns"), per("lnb"), j["wqkv"], per("bqkv"), j["wproj"])
    tw = [t[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj")]

    out_j, p_j, cat_j = _fwd_save_call(H, j["x"], *jw, per("bproj"),
                                       s=j["s"])
    out_t, p_t, cat_t = tat.attn_fwd(t["x"], t["s"], *tw, t["bproj"], H)
    for got, want, name in ((out_t, out_j, "out"), (p_t, p_j, "P"),
                            (cat_t, cat_j, "cat")):
        _close(got, want, name)
    _close(tat.attn_fwd(t["x"], None, *tw, t["bproj"], H, save=False)[0],
           _fwd_call(H, j["x"], *jw, per("bproj")), "out_eval")

    got = tat.attn_bwd(t["x"], t["s"], *tw, p_t, cat_t, t["da"], H)
    want = _bwd_save_call(H, j["x"], *jw, p_j, cat_j, j["da"], s=j["s"])
    for g, w, name in zip(got, want, GRADS):
        _close(g, np.asarray(w).reshape(g.shape), name)
    got = tat.attn_bwd_recompute(t["x"], *tw, t["da"], H)
    want = _bwd_call(H, j["x"], *jw, j["da"])
    for g, w, name in zip(got, want, GRADS):
        _close(g, np.asarray(w).reshape(g.shape), name + " (recompute)")


@pytest.mark.parametrize("N,hd,pairs", [(300, 16, (2, 3)), (1100, 8, (1, 2))])
def test_flash_attention_matches_jax(N, hd, pairs, monkeypatch):
    """Rows 11 and 12 at N = 300 against the Pallas kernels; at N = 1100
    both packages run their plain attention (``_attention_xla`` /
    ``attention_xla``) forward and backward, and the port's kernels'
    autograd function is not called at all."""
    r = np.random.RandomState(N)
    q, k, v, do = (r.randn(*pairs, N, hd).astype(np.float32)
                   for _ in range(4))
    scale = hd ** -0.5
    out_j, vjp = jax.vjp(lambda *a: jflash(*a, scale),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    if tfl.routes_to_plain(N):
        def refuse(*args):
            raise AssertionError("the flash kernels ran past MAX_FUSED_SEQ")
        monkeypatch.setattr(tfl.FlashAttention, "apply", refuse)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_t = tfl.flash_attention(*leaves, scale)
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(do))
    _close(out_t.detach(), out_j, "o")
    for g_t, g_j, name in zip(grads_t, grads_j, ("dq", "dk", "dv")):
        _close(g_t, g_j, name)
    if tfl.routes_to_plain(N):
        assert torch.equal(out_t, attention_xla(*leaves, scale))


@pytest.mark.parametrize("N", [40, 197, 256, 257, 512, 1024, 1025, 2048])
def test_predicates_and_streamed_shared_memory(N):
    """The kernels take every N: bf16 at head_dim 64 stays on the Hopper /
    tensor-core path, the keys stream past 256, the flash route runs the
    plain attention past 1024, and no streamed kernel's shared memory
    passes the 232,448 bytes a Hopper block may take (a function of the
    head_dim alone)."""
    bf = torch.bfloat16
    assert tat.uses_sm90(bf, 384, 6, N) and tfl.uses_tensor_cores(bf, N, 64)
    assert not tat.uses_sm90(torch.float32, 384, 6, N)
    assert not tfl.uses_tensor_cores(bf, N, 48)
    assert kernels.streams_keys(N) is (N > 256)
    assert tfl.routes_to_plain(N) is (N > 1024)
    for hd in (16, 32, 48, 64):
        smem = kernels.stream_smem_bytes(hd)
        assert max(smem.values()) <= kernels.SMEM_LIMIT, smem


@pytest.mark.parametrize("N", [257, 300, 333, 512, 513, 1024, 1536])
def test_streamed_launch_plan(N):
    """What Python mirrors of the bf16 streamed kernels' launch plan: the P
    ``fwd_launch`` allocates (and ``bwd_launch`` passes on) moves in whole
    TMA tiles exactly where a row of it starts on a 16-byte boundary, as a
    tensor map's strides must (N = 512, 1024, 1536), and element by
    element at 257, 300, 333 and 513; a grid block covers 128 queries, one
    column-sum part row each; and the Hopper kernels' shared memory is the
    same at every head_dim (and N)."""
    n, Bm, Dm, Hm = 1, 2, 128, 2
    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt)
    f32 = torch.float32
    x = z(n, Bm, N, Dm)
    _, args, (_, P, _) = tat.fwd_launch(
        x, z(n, Bm, dt=f32), z(n, Dm, dt=f32), z(n, Dm, dt=f32),
        z(n, Dm, 3 * Dm), z(n, 3 * Dm), z(n, Dm, Dm), z(n, Dm), Hm)
    assert P.shape == (n, Bm, Hm, N, N) and P.is_contiguous()
    row_bytes = P.stride(-2) * P.element_size()
    assert kernels.p_moves_in_tiles(N) is (row_bytes % 16 == 0)
    assert kernels.p_moves_in_tiles(N) is (N in (512, 1024, 1536))
    blocks = kernels.attn_part_rows(N)
    assert (blocks - 1) * kernels.AS_QB < N <= blocks * kernels.AS_QB
    hopper = ("attn_fwd_head_stream", "attn_bwd_head_rows_stream",
              "attn_bwd_head_cols_stream")
    for hd in (16, 32):
        assert all(kernels.stream_smem_bytes(hd)[k]
                   == kernels.stream_smem_bytes(64)[k] for k in hopper)


def _resident(case):
    """The same launch at N = 256 (the arguments of ``bwd_launch``)."""
    def cut(t):
        if t is None or not torch.is_tensor(t) or t.dim() < 4:
            return t
        if t.dim() == 5:
            return t[..., :256, :256].contiguous()
        return t[:, :, :256].contiguous()
    return tuple(cut(t) for t in case)


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("N", [257, 512])
def test_streamed_backward_launch_arguments(N, recompute):
    """The bf16 attention backward past 256: the arguments match the
    ctypes signature, the statistics scratch is [items, H, N, 3] f32 and
    dbqkv's column sums take one row per item and 128-query block; the
    flash backward's statistics are [pairs, N, 3]."""
    n, Bm, Dm, Hm = 2, 3, 384, 6
    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt)
    f32 = torch.float32
    w = (z(n, Dm, dt=f32), z(n, Dm, dt=f32), z(n, Dm, 3 * Dm), z(n, 3 * Dm),
         z(n, Dm, Dm))
    x = z(n, Bm, N, Dm)
    if recompute:
        case = (x, None, *w, None, None, x, Hm)
    else:
        case = (x, z(n, Bm, dt=f32), *w, z(n, Bm, Hm, N, N), x, x, Hm)
    name, args, _ = tat.bwd_launch(*case)
    assert len(args) + 1 == len(kernels._SIGNATURES["fc_" + name])
    _, _, scratch = tat._bwd_buffers(x, Hm, recompute)
    stats, hpart, wpart = scratch[-3:]
    assert stats.shape == (n * Bm, Hm, N, 3) and stats.dtype == f32
    assert hpart.shape == (n * Bm * -(-N // 128), 3 * Dm)
    assert kernels.attn_part_rows(N) == -(-N // 128)
    # stats, hpart, wpart close the argument list; resident, stats is null
    assert isinstance(args[-3], int) and isinstance(args[-2], int)
    assert tat.bwd_launch(*_resident(case))[1][-3] is None
    q = z(2, 3, N, 64)
    _, fargs, _, fstats = tfl.bwd_launch(q, q, q, q, 0.125)
    assert fstats.shape == (6, N, 3) and fargs[-1] == fstats.data_ptr()
    assert len(fargs) + 1 == len(kernels._SIGNATURES["fc_flash_bwd"])


_BASE = dict(img_size=32, patch_size=16, depth=2, vocab_size=40,
             max_text_len=300, compute_dtype="float32", use_pallas=True,
             use_fused_mlp=True, modalities=(None, "txt"),
             tasks=(None, "cls"), num_classes=(None, 4), with_aux=True,
             aux_trained=True)
ROUTES = {"fused": dict(embed_dim=128, num_heads=2),
          "flash": dict(embed_dim=32, num_heads=2)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_model_at_300_tokens_matches_jax(route):
    """The text stack at 300 tokens on the fused route (D=128, kernels
    1-4 in training, 1e and 3e at eval) and the flash route (D=32, kernels
    11 and 12): logits in training and eval and every leaf gradient
    against the JAX ``mat_apply``."""
    kw = dict(_BASE, **ROUTES[route])
    jcfg, tcfg = jmat.MATConfig(**kw), tmat.MATConfig(**kw)
    assert tcfg.fused_attn_ok is (route == "fused")
    r = np.random.RandomState(1)
    jparams = jmat.init_mat(jcfg, jax.random.PRNGKey(0))
    ids = r.randint(0, 40, (3, 300)).astype(np.int32)
    cot = r.randn(3, 4).astype(np.float32)

    def jloss(p, train):
        out = jmat.mat_apply(jcfg, p, [None, jnp.asarray(ids)], train=train,
                             rng=jax.random.PRNGKey(1))[1]
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(lambda p: jloss(p, True),
                                           has_aux=True)(jparams)
    jeval = jloss(jparams, False)[1]
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg=tcfg)
    tparams = tmat.tree_map(lambda a: a.requires_grad_(True), tparams)
    tids = [None, torch.from_numpy(ids)]
    tout = tmat.mat_apply(tcfg, tparams, tids, train=True,
                          gen=torch.Generator().manual_seed(0))[1]
    flat_t = _flat(tparams)
    paths = sorted(flat_t)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                                 [flat_t[p] for p in paths])
    with torch.no_grad():
        teval = tmat.mat_apply(tcfg, tparams, tids)[1]
    tol = dict(atol=1e-4, rtol=1e-4)
    _close(tout.detach(), jout, "out", tol)
    _close(teval, jeval, "eval", tol)
    flat_j = _flat(jgrads)
    assert sorted(flat_j) == paths
    for p, g in zip(paths, tgrads):
        _close(g, flat_j[p], "/".join(p), tol)


def _write_medabstracts(root, n_train, n_test, words, seed):
    """medical_tc_{train,test}.csv (condition_label 1-5, medical_abstract
    of ``words`` words) and the vocab.txt the text is made of."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + \
        [f"term{i}" for i in range(60)]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    r = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        with open(root / f"medical_tc_{split}.csv", "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(["condition_label", "medical_abstract"])
            for _ in range(n):
                label = r.randint(1, 6)
                # a label-dependent band of terms, so the classes differ
                terms = (r.randint(0, 50, words) + 2 * label) % 60
                out.writerow([label, " ".join(f"term{t}" for t in terms)])


def test_medabstracts_round_at_300_tokens_matches_jax_server(tmp_path):
    """``main.MEDABS_LONG_FLAGS`` on written CSVs at ``--seq_len 300``
    (abstracts of 400 words, so every position is a token), cut to
    ``mome_test_patch16_32``, float32, dropout 0: one round through both
    servers from the JAX weights; the round's training loss within 1e-5
    relative, the central acc1 and f1 equal."""
    root = tmp_path / "medabstract"
    root.mkdir()
    _write_medabstracts(root, 96, 48, 400, seed=0)
    flags = [f for f in tmain.MEDABS_LONG_FLAGS if f != "--synthetic_data"]
    del flags[flags.index("--device"):flags.index("--device") + 2]
    cuts = {"--model_name": "mome_test_patch16_32", "--seq_len": "300",
            "--B": "8", "--R": "1", "--eval_batch_size": "32"}
    for flag, value in cuts.items():
        flags[flags.index(flag) + 1] = value
    flags += ["--data_paths", str(root), str(root), "--dropout", "0",
              "--compute_dtype", "float32"]
    out = ["--result_path", str(tmp_path / "j"), "--log_path",
           str(tmp_path / "l")]
    jcfg = jconfig.parse_args(flags + out + ["--no_pallas",
                                             "--mesh_shape", "1"])
    jserver = jcreate(jcfg, jload(jcfg, np.random.RandomState(jcfg.seed)))
    out[1] = str(tmp_path / "t")
    tcfg = tconfig.parse_args(flags + out + ["--device", "cpu"])
    tserver = tcreate(tcfg, tload(tcfg, np.random.RandomState(tcfg.seed)))
    assert tserver.model_cfgs["MedicalAbstracts"].max_text_len == 300
    for ds, p in jserver.global_params.items():
        tserver.global_params[ds] = convert.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p), cfg=tserver.model_cfgs[ds])
    for s in (jserver, tserver):
        s.round = 1
        s.update()
        s.evaluate([])
    jr, tr = jserver.results[1], tserver.results[1]
    jl = jr["clients_updated_summary"]["loss"]["avg"]
    tl = tr["clients_updated_summary"]["loss"]["avg"]
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    key = "server_evaluated_MedicalAbstracts"
    assert tr[key]["metrics"] == jr[key]["metrics"]
    assert set(tr[key]["metrics"]) == {"acc1", "f1"}


def test_long_line_builds_a_512_token_text_stack():
    """``main.MEDABS_LONG_FLAGS`` parse to the script's line at 512 tokens:
    two MedicalAbstracts text populations, two clients sampled a round, and
    a text-only model whose stack runs at N = 512, past the resident
    kernels (at the test width here)."""
    from fedcola_tpu_torch.models.registry import create_model
    flags = list(tmain.MEDABS_LONG_FLAGS)
    flags[flags.index("--model_name") + 1] = "mome_test_patch16_32"
    cfg = tconfig.parse_args(flags)
    assert (cfg.seq_len, cfg.B, cfg.algorithm) == (512, 96, "fedavg")
    assert cfg.eval_metrics == ["acc1", "f1"]
    assert int(cfg.Cs[0] * cfg.Ks[0]) == 2
    mcfg, _ = create_model(cfg.model_name, cfg, "MedicalAbstracts",
                           torch.Generator().manual_seed(0))
    assert mcfg.modalities == (None, "txt") and mcfg.max_text_len == 512
    assert kernels.streams_keys(mcfg.max_text_len)
