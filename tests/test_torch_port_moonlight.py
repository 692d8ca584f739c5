"""The moonlight block (Moonlight-16B-A3B's decoder layer, ``models/moe.py``)
against the benchmark's plain reference (``portbench/reference/moonlight.py``)
on the CPU at a small width: D 64, 4 heads, MLA head dims 16 / 8 / 16 and
kv rank 32, a dense layer of 128, then MoE layers of 16 routed experts of
width 32 of which 4 are held, top-6, two shared.  Both sides run in
float32 on seeded random weights (the benchmark's own draw).

* the forward and the gradient of every leaf;
* the expert share: the held shares of four disjoint expert ranges, plus
  the shared experts once, are the uncut layer;
* no row is dropped when every token routes to one expert;
* names and scopes: ``--shared_param attn`` shares the MLA leaves across
  modalities and not the experts;
* the aux fold over the expert kernels, expert by expert;
* a recompute (remat 'full') that routes otherwise than its forward;
* two whole FedCola rounds of a ``mome_moonlight_test`` population through
  the program's server against ``portbench/reference/fedcola.Federation``
  through ``portbench/arch/moonlight.py``.

Tolerances: both sides are float32 and differ only in the order of their
sums (batched products, scaled_dot_product_attention against an explicit
softmax, the combine's slot order against the reference's expert order),
so outputs agree within 1e-5 relative and gradients within 1e-4 of each
leaf's norm; the routing is the same choice on both sides at these
widths.  About 20 s on one worker.
"""

import json

import pytest
import torch

from fedcola_tpu_torch.federation.aux import fold_aux_into_upload
from fedcola_tpu_torch.models import moe, naming
from fedcola_tpu_torch.models.mat import MATConfig, mat_apply, tree_map
from fedcola_tpu_torch.models.registry import MOONLIGHT_SIZES
from fedcola_tpu_torch.ops import moe_gemm
from portbench import check, program
from portbench.cell import Run, _inputs, _reference, readings
from portbench.inputs import make_weights
from portbench.reference import moonlight as ref
from portbench.reference.precision import Products
from portbench.spec import arch_of, resolve_cell
from portbench.tests.tinyroot import REPO, make_root
from portbench.tree import get, leaves

TINY = {"architecture": "moonlight", "model_name": "mome_moonlight_test",
        "hidden_size": 64, "num_hidden_layers": 3,
        "first_k_dense_replace": 1, "num_attention_heads": 4,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "kv_lora_rank": 32, "rope_theta": 50000,
        "intermediate_size": 128, "moe_intermediate_size": 32,
        "router_experts": 16, "experts_held_first": 0,
        "n_routed_experts": 4, "num_experts_per_tok": 6,
        "n_shared_experts": 2, "routed_scaling_factor": 2.446,
        "rms_norm_eps": 1e-5, "img_size": 32, "patch_size": 16,
        "in_chans": 3, "vocab_size": 120, "max_text_len": 12,
        "drop_path_rate": 0.0, "compute_dtype": "float32"}
SLOTS = {"img": (("img", None), ("cls", None), (10, None)),
         "txt": ((None, "txt"), (None, "cls"), (None, 4)),
         "img+txt": (("img", "txt"), ("rtv", "rtv"), (None, None))}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(modality="img", **kw):
    mods, tasks, ncls = SLOTS[modality]
    return MATConfig(block="moonlight", **MOONLIGHT_SIZES[
        "mome_moonlight_test"], modalities=mods, tasks=tasks,
        num_classes=ncls, compute_dtype="float32", vocab_size=120,
        max_text_len=12, **kw)


def _model(modality="img", with_aux=False, seed=2 ** 31 + 5):
    mods, tasks, ncls = SLOTS[modality]
    spec = ref.model_spec(TINY, modality, tasks[0] or tasks[1],
                          ncls[0] or ncls[1], with_aux)
    weights = make_weights({"m": ref.layout(spec)}, seed, "cpu",
                           arch_of(REPO, "moonlight"))["m"]
    return spec, weights


def _inputs_of(modality, B=3, seed=7):
    g = torch.Generator().manual_seed(seed)
    out = {}
    if "img" in modality:
        out[0] = torch.rand(B, 32, 32, 3, generator=g) * 2 - 1
    if "txt" in modality:
        out[1] = torch.randint(5, 120, (B, 12), generator=g)
    return out


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_registry_matches_the_test_configuration():
    cfg = _cfg()
    for key, want in arch_of(REPO, "moonlight").program_check(TINY).items():
        assert getattr(cfg, key) == want, key


@pytest.mark.parametrize("modality", ["img", "txt", "img+txt"])
def test_forward_and_every_gradient(modality):
    spec, w = _model(modality, with_aux=modality != "img+txt")
    cfg = _cfg(modality, with_aux=modality != "img+txt", aux_trained=True)
    if spec.has_aux:
        # nonzero scales, so that the aux kernels carry gradient
        g = torch.Generator().manual_seed(3)
        for k in ref.AUX_KINDS:
            s = w["aux"][f"{k}_scale"]
            w["aux"][f"{k}_scale"] = torch.rand(s.shape, generator=g) * 0.5
    ins = _inputs_of(modality)
    theirs = tree_map(lambda t: t.clone().requires_grad_(True), w)
    mine = tree_map(lambda t: t.clone().requires_grad_(True), w)
    want = ref.forward(spec, theirs, ins, Products(), feat_out=True)
    got = mat_apply(cfg, mine, [ins.get(0), ins.get(1)], feat_out=True)
    for slot, y in want.items():
        assert _rel(got[slot], y) < 1e-5
    probe = torch.Generator().manual_seed(11)
    coef = {s: torch.randn(y.shape, generator=probe) for s, y in want.items()}
    sum(torch.sum(coef[s] * y) for s, y in want.items()).backward()
    sum(torch.sum(coef[s] * got[s]) for s in want).backward()
    for path, t in leaves(theirs):
        a = get(mine, path).grad
        if t.grad is None:
            # the selection bias (no gradient reaches it) and, under
            # feat_out, the classification head
            assert a is None, path
            continue
        assert a is not None, path
        assert _rel(a, t.grad) < 1e-4, path


def _program_moe(cfg, w, layer, x, first, held):
    """The program's MoE FFN of MoE layer ``layer`` for the experts
    ``first .. first + held - 1`` over ``x [B, N, D]``."""
    c = cfg.replace(held_first=first, experts_held=held)
    blk = tree_map(lambda t: t[None], w["blk"]["0"])
    for k in ("gate", "up", "down"):
        leaf = blk[f"expert_{k}_kernel"]
        blk[f"expert_{k}_kernel"] = leaf[:, :, first:first + held]
    lw = moe._layer_weights(c, blk, cfg.dense_layers + layer, torch.float32)
    return moe.moe_ffn(c, x[None], lw, False)[0]


def test_expert_shares_sum_to_the_uncut_layer():
    spec, w = _model()
    E, held = spec.router_experts, spec.held
    # the uncut layer: all 16 experts' kernels
    g = torch.Generator().manual_seed(5)
    blk = w["blk"]["0"]
    for k in ("gate", "up", "down"):
        shape = list(blk[f"expert_{k}_kernel"].shape)
        shape[1] = E
        blk[f"expert_{k}_kernel"] = torch.randn(shape, generator=g) * 0.1
    x = torch.randn(2, 5, spec.embed_dim, generator=g)
    flat = x.reshape(-1, spec.embed_dim)
    mm = Products()
    uncut = ref.routed(spec, mm, flat, blk, 0, 0, E) + ref.glu(
        mm, flat, blk["shared_gate_kernel"][0], blk["shared_up_kernel"][0],
        blk["shared_down_kernel"][0])
    cfg = _cfg()
    shares = [_program_moe(cfg, w, 0, x, first, held)
              for first in range(0, E, held)]
    shared = ref.glu(mm, flat, blk["shared_gate_kernel"][0],
                     blk["shared_up_kernel"][0],
                     blk["shared_down_kernel"][0]).reshape(x.shape)
    # each share holds the shared experts: count them once
    total = sum(shares) - (len(shares) - 1) * shared
    assert _rel(total.reshape(flat.shape), uncut) < 1e-5
    # and the reference's shares alike, each given its experts' kernels
    ref_total = sum(ref.routed(spec, mm, flat, _held(blk, first, held), 0,
                               first, held) for first in range(0, E, held))
    assert _rel(ref_total, ref.routed(spec, mm, flat, blk, 0, 0, E)) < 1e-5


def _held(blk, first, held):
    out = dict(blk)
    for k in ("gate", "up", "down"):
        out[f"expert_{k}_kernel"] = blk[f"expert_{k}_kernel"][
            :, first:first + held]
    return out


def test_no_row_dropped_on_one_expert():
    """Every token chooses held expert 2: its group holds every token, and
    the layer agrees with the reference."""
    spec, w = _model()
    blk = w["blk"]["0"]
    blk["router_kernel"][0, :, 2] = 0.0
    blk["router_bias"][0, 2] = 10.0     # the choice alone, not the weight
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 7, spec.embed_dim, generator=g)
    flat = x.reshape(-1, spec.embed_dim)
    idx, _ = ref.route(spec, flat, blk["router_kernel"][0],
                       blk["router_bias"][0])
    assert (idx == 2).any(-1).all()
    cfg = _cfg()
    midx, _ = moe.route(cfg, x.reshape(1, -1, spec.embed_dim),
                        blk["router_kernel"][0][None],
                        blk["router_bias"][0][None])
    plan = moe_gemm.route_plan(midx, 0, spec.held)
    assert int(plan.counts[2]) == flat.shape[0]
    got = _program_moe(cfg, w, 0, x, 0, spec.held)
    mm = Products()
    want = ref.routed(spec, mm, flat, blk, 0, 0, spec.held) + ref.glu(
        mm, flat, blk["shared_gate_kernel"][0], blk["shared_up_kernel"][0],
        blk["shared_down_kernel"][0])
    assert _rel(got.reshape(flat.shape), want) < 1e-5


def test_route_plan_layout():
    """Groups in client-major order, each padded to the 128-row tile; a
    row's pair and a pair's row invert each other; unheld pairs point at
    the zero row."""
    g = torch.Generator().manual_seed(1)
    n, T, k, held = 2, 50, 6, 4
    idx = torch.rand(n, T, 16, generator=g).topk(k, -1).indices
    plan = moe_gemm.route_plan(idx, 4, held)
    mine = (idx >= 4) & (idx < 8)
    counts = [int(((idx[c] - 4) == e).sum()) for c in range(n)
              for e in range(held)]
    assert plan.counts.tolist() == counts
    po = plan.poff.tolist()
    assert po[0] == 0 and all(p % moe_gemm.BM == 0 for p in po)
    assert all(po[i + 1] - po[i] >= counts[i] for i in range(len(counts)))
    assert plan.cap >= po[-1]
    assert int((plan.pair_row < plan.cap).sum()) == int(mine.sum())
    for p, r in enumerate(plan.pair_row.tolist()):
        if r < plan.cap:
            assert plan.row_pair[r] == p
    # within a group, pairs in token order
    rows = plan.row_pair[:po[1]][:counts[0]]
    assert torch.equal(rows, rows.sort().values)


def test_names_and_scopes():
    cfg = _cfg("img+txt")
    names = dict(naming.param_names(cfg))
    scope = naming.build_param_scope(names.values(), "attn", "modality")
    for path, name in names.items():
        attn = path[0] == "blk" and path[-1] in arch_of(
            REPO, "moonlight").ATTN_LEAVES
        assert scope[name] == ("modality" if attn else "dataset"), name
    assert names[("blk", "1", "expert_gate_kernel")] == \
        "blockses.1.*.mlp.experts.*.gate_proj.weight"
    assert names[("blk", "0", "q_kernel")] == "blockses.0.*.attn.q_proj.weight"
    assert ("norm", "bias") not in names
    assert len(set(names.values())) == len(names)


def test_aux_fold_expert_by_expert():
    cfg = _cfg("txt", with_aux=True, aux_trained=True)
    spec, w = _model("txt", with_aux=True)
    g = torch.Generator().manual_seed(4)
    for k in cfg.aux_layer_kinds:
        w["aux"][f"{k}_aux"] = torch.randn(w["aux"][f"{k}_aux"].shape,
                                           generator=g)
        w["aux"][f"{k}_scale"] = torch.randn(w["aux"][f"{k}_scale"].shape,
                                             generator=g)
    assert set(cfg.aux_layer_kinds) == set(ref.AUX_KINDS)
    stacked = tree_map(lambda t: t[None].repeat((2,) + (1,) * t.dim()), w)
    up = fold_aux_into_upload(cfg, stacked)
    assert "aux" not in up
    blk, aux = w["blk"]["1"], w["aux"]
    for layer in range(spec.moe_layers):
        for e in range(spec.held):
            want = blk["expert_down_kernel"][layer, e] + aux[
                "expert_down_scale"][layer, e] * aux["expert_down_aux"][
                layer, e]
            for c in range(2):
                assert torch.equal(up["blk"]["1"]["expert_down_kernel"][
                    c, layer, e], want)
    # the program's fold is the reference's
    folded = ref.fold_aux(spec, w)["blk"]["1"]
    for k, v in folded.items():
        assert torch.allclose(up["blk"]["1"][k][0], v, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def moon_root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("moonroot"))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "moon", "source": "test width",
                         "file": "portbench/configs/moon.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"].append({"name": "pop.moon", "config": "moon",
                           "traffic": "pop-tiny", "chips": 1,
                           "why": "CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    p = root / "portbench"
    (p / "configs" / "moon.json").write_text(json.dumps(TINY))
    (p / "limits" / "pop.moon.json").write_text(
        (p / "limits" / "pop.tiny.json").read_text())
    return root


def test_fedcola_rounds_against_the_reference(moon_root):
    """Two rounds of the tiny population (4 + 4 + 4 clients, C 0.5, E 2,
    B 8: aux exchange, scoped and compensated aggregation, the central
    evaluation with retrieval) through the program's server, against the
    reference through the architecture file."""
    cell = resolve_cell(moon_root, "pop.moon")
    assert cell.architecture == "moonlight"
    seed = 2 ** 31 + 17
    run = Run(cell, seed, "cpu", moon_root)
    run.follow(2)
    counters = run.server.results[1]["round_counters"]
    assert counters["moe_layers"] > 0 and counters["routed_rows"] > 0
    # read back on the device the server names (cuda, not cuda:0)
    moe._add_routed(torch.ones(2, dtype=torch.long))
    assert int(moe.take_routed_rows(torch.device("cpu", 0))) == 2
    assert moe.take_routed_rows("cpu") is None
    prog = {"losses": dict(run.losses),
            "eval": program.eval_results(run.server, 2, run.data),
            "init_eval": program.eval_results(run.server, 0, run.data)}
    _, _, layouts = _inputs(cell, seed, "cpu")
    w0 = make_weights(layouts, seed, "cpu", cell.arch)
    prog["delta"] = {ds: check.norms(cell.arch.parts, t, w0[ds])
                     for ds, t in run.server.global_params.items()}
    got = readings(prog, _reference(cell, seed, "cpu", 2, 2))
    assert got["loss"] < 1e-5 and got["eval_loss"] < 1e-5
    assert got["init_eval_loss"] < 1e-5
    assert got["rtv_meanr"] == 0.0 and got["init_rtv_meanr"] == 0.0
    # every parameter's change over the rounds, the experts' one by one
    assert got["change"] < 1e-3 and got["change_median"] < 1e-4


def test_cell_configuration_is_the_registry_model():
    """The benchmark cell's flags build, for each dataset, the program's
    ``mome_moonlight_a3b`` at the configuration's widths, with the
    reference's kernel shapes (checked without allocating its weights)."""
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.models.registry import build_mat_config
    cell = resolve_cell(REPO, "coco-pop1.moonlight_a3b_mat")
    cfg = parse_args(program.flags_of(cell, "cpu", "/nonexistent"))
    want = cell.arch.program_check(cell.config)
    for ds in cfg.client_datasets:
        m = build_mat_config(cfg.model_name, cfg, ds)
        assert {k: getattr(m, k) for k in want} == want
        mod = {("img", None): "img", (None, "txt"): "txt"}.get(
            m.modalities, "img+txt")
        spec = ref.model_spec(cell.config, mod, "cls", 10, True)
        assert moe.kernel_shapes(m) == ref.kernel_shapes(spec)
        for kind in m.aux_layer_kinds:
            assert moe.aux_scale_shape(m, kind) == \
                ref.aux_scale_shape(spec, kind)
    # the traffic trains one sampled client of each dataset a round
    from portbench.inputs import flag
    Ks = [int(k) for k in flag(cell.traffic["flags"], "--Ks")]
    C = float(flag(cell.traffic["flags"], "--Cs"))
    assert [max(int(C * k), 1) for k in Ks] == [1, 1, 1]


def test_recompute_that_routes_otherwise():
    """Under remat 'full' the backward recomputes the layer; a library
    product need not repeat its bits, so the recompute may route a near
    tie otherwise.  The backward must then follow the recompute's routing
    plan throughout: its gradients are those of the layer routed as the
    recompute routed (token 0 sent to experts 0-5 here)."""
    spec, w = _model()
    cfg = _cfg()
    x0 = torch.randn(1, 2, 5, spec.embed_dim,
                     generator=torch.Generator().manual_seed(8))
    coef = torch.randn(x0.shape, generator=torch.Generator().manual_seed(9))
    route = moe.route

    def flipped(*args):
        idx, wts = route(*args)
        idx = idx.clone()
        idx[:, 0] = torch.arange(idx.shape[-1])
        return idx, wts

    def grads(remat):
        blk = tree_map(lambda t: t[None].clone().requires_grad_(True),
                       w["blk"]["0"])
        x = x0.clone().requires_grad_(True)
        calls = []

        def routing(*args):
            calls.append(1)
            return (flipped if len(calls) > 1 or not remat else route)(*args)

        def layer(h):
            lw = moe._layer_weights(cfg, blk, cfg.dense_layers, torch.float32)
            return moe.moe_ffn(cfg, h, lw, True)

        moe.route = routing
        try:
            out = moe._mat._ckpt(layer, x) if remat else layer(x)
            (coef * out).sum().backward()
        finally:
            moe.route = route
        moe.take_routed_rows("cpu")
        return [x.grad] + [t.grad for _, t in leaves(blk)
                           if t.grad is not None]

    for a, b in zip(grads(True), grads(False)):
        assert _rel(a, b) < 1e-5
