"""The moonlight architecture: its configuration and cell found by name, its
FLOP count and the grouped GEMM's least time against the hand counts, its
readers, and its plain reference pinned at a test width."""

import json

import pytest
import torch

from portbench.counts.peaks import BF16_FLOPS
from portbench.inputs import make_weights
from portbench.reference import moonlight as ref
from portbench.reference.precision import Products
from portbench.spec import arch_of, metric_reader, resolve_cell
from portbench.tests.tinyroot import REPO

CELL = "coco-pop1.moonlight_a3b_mat"
NEW = ("experts_roofline.train", "moe_ms_per_step.train",
       "route_ms_per_step.train")
APPENDED = ("mfu.train", "idle_share.train", "forward_ms.train",
            "backward_ms.train", "opt_ms.train", "aggregate_ms.train",
            "eval_ms.train", "sync_ms.train", "data_ms.train",
            "aten_ms_per_step.train")

# the published widths (the catalog's Moonlight-16B-A3B config.json)
PUBLISHED = {"hidden_size": 2048, "num_attention_heads": 16,
             "num_key_value_heads": 16, "kv_lora_rank": 512,
             "q_lora_rank": None, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "v_head_dim": 128,
             "intermediate_size": 11264, "moe_intermediate_size": 1408,
             "first_k_dense_replace": 1, "num_experts_per_tok": 6,
             "n_shared_experts": 2, "routed_scaling_factor": 2.446,
             "scoring_func": "sigmoid", "norm_topk_prob": True,
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "rms_norm_eps": 1e-05, "rope_theta": 50000,
             "hidden_act": "silu", "attention_bias": False,
             "model_type": "deepseek_v3"}


def _config():
    return json.loads((REPO / "portbench" / "configs"
                       / "moonlight_a3b_mat.json").read_text())


def test_cell_is_found_by_name():
    cell = resolve_cell(REPO, CELL)
    assert cell.architecture == "moonlight" and cell.chips == 1
    assert cell.arch.__file__ == str(REPO / "portbench" / "arch"
                                     / "moonlight.py")
    assert [m.name for m in cell.end_to_end] == ["train_samples_per_s",
                                                 "setup_s"]
    names = {m.name for m in cell.per_layer}
    assert set(NEW) | set(APPENDED) == names
    assert (REPO / "portbench" / "limits" / f"{CELL}.json").is_file()
    assert cell.traffic["mode"] == "rounds"


def test_configuration_keeps_the_published_widths():
    c = _config()
    for k, v in PUBLISHED.items():
        assert c[k] == v, k
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(x for x in b["configs"] if x["name"] == "moonlight_a3b_mat")
    assert set(entry["reduced"]) == set(c["reduced"])
    for k, was in {"num_hidden_layers": 27, "n_routed_experts": 64,
                   "ep_size": 1, "vocab_size": 163840}.items():
        assert c["published"][k] == was and c[k] != was
        assert k in entry["reduced"]
    assert c["router_experts"] == 64 and c["n_routed_experts"] == 8


def test_flops_against_the_hand_counts():
    A, c = arch_of(REPO, "moonlight"), _config()
    f = A.token_flops(c, 197)
    want = {"mla": 27.5, "core": 2.0, "dense": 138.4, "router": 0.26,
            "shared": 34.6, "routed": 13.0}
    for k, v in want.items():
        assert f[k] / 1e6 == pytest.approx(v, rel=0.01), k
    per_token = 5 * (f["mla"] + f["core"]) + f["dense"] + 4 * (
        f["router"] + f["shared"] + f["routed"])
    assert per_token / 1e6 == pytest.approx(477, rel=0.002)
    assert A.forward_flops(c, "img") / 1e9 == pytest.approx(94.6, rel=0.002)
    assert A.forward_flops(c, "txt") / 1e9 == pytest.approx(18.8, rel=0.005)
    # a training img+txt pair: three forwards of both towers
    assert A.routed_share(c) == 0.75


def test_experts_least_against_the_hand_count():
    A, c = arch_of(REPO, "moonlight"), _config()
    (_, dense), (count, moe) = A.layers(c, "img")
    assert count == 4 and A.experts_least(96, 1, 197, dense, True) == 0.0
    R = 96 * 197 * 6 * 8 / 64                       # 14,184 routed rows
    D, F = 2048, 1408
    # compute-bound at these shapes: 6RDF forward, 12RDF backward
    assert A.experts_least(96, 1, 197, moe, True) == pytest.approx(
        18 * R * D * F / BF16_FLOPS, rel=1e-12)
    assert A.experts_least(512, 1, 197, moe, False) == pytest.approx(
        6 * 512 * 197 * 0.75 * D * F / BF16_FLOPS, rel=1e-12)
    # a text step's 360-row groups: the weights' reads (bf16 in, and the
    # f32 gradients out) bound both calls
    for ops, nbytes in A.experts_calls(96 * 40 * 0.75, 1, D, F, 8, True):
        assert ops / BF16_FLOPS < nbytes / 3.35e12


def test_readers():
    cell = resolve_cell(REPO, CELL)
    ranges = {"fc_moe.route": 0.1, "fc_moe.dispatch": 0.2,
              "fc_moe.experts": 0.3, "fc_moe.combine": 0.4,
              "fc_moe.shared": 0.5, "fc_moe_gemm_bwd": 0.6,
              "fc_moe_gemm_fwd": 0.25, "fc_attn_fwd": 9.0}
    ctx = {"trace": {"ranges": ranges},
           "work": {"steps": 10, "least": {"experts": 0.17}},
           "routes": {r: v.ranges for r, v in cell.arch.routes().items()}}
    get = lambda name: metric_reader(REPO, name)(ctx)  # noqa: E731
    assert get("moe_ms_per_step.train") == pytest.approx(1e3 * 2.1 / 10)
    assert get("route_ms_per_step.train") == pytest.approx(1e3 * 0.7 / 10)
    assert get("experts_roofline.train") == pytest.approx(100 * 0.17 / 0.85)
    # the parent's program has no such ranges: nothing to read
    ctx["trace"]["ranges"] = {"fc_attn_fwd": 9.0}
    for name in NEW:
        assert get(name) is None


# the reference at test width (tests/test_torch_port_moonlight.py's): the
# first row's first three outputs and the sum of |outputs| of a slot
PINNED = {("img", 0): ([0.23834139108657837, -0.0563347153365612,
                        0.3165892958641052], 3.74736369214952),
          ("txt", 1): ([-0.07349439710378647, 0.14376695454120636,
                        0.11089536547660828], 1.8879714161157608),
          ("img+txt", 0): ([0.0982479453086853, -0.017265798524022102,
                            -0.015094341710209846], 18.94349544700526),
          ("img+txt", 1): ([-0.1849317103624344, 0.0008000913658179343,
                            0.15675826370716095], 19.403612915048143)}
TINY = {"hidden_size": 64, "num_hidden_layers": 3,
        "first_k_dense_replace": 1, "num_attention_heads": 4,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "kv_lora_rank": 32, "rope_theta": 50000, "intermediate_size": 128,
        "moe_intermediate_size": 32, "router_experts": 16,
        "experts_held_first": 0, "n_routed_experts": 4,
        "num_experts_per_tok": 6, "n_shared_experts": 2,
        "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5,
        "img_size": 32, "patch_size": 16, "in_chans": 3, "vocab_size": 120,
        "max_text_len": 12}


@pytest.mark.parametrize("modality", ["img", "txt", "img+txt"])
def test_reference_is_pinned(modality):
    torch.set_num_threads(1)
    task, classes = {"img": ("cls", 10), "txt": ("cls", 4),
                     "img+txt": ("rtv", None)}[modality]
    spec = ref.model_spec(TINY, modality, task, classes,
                          modality != "img+txt")
    w = make_weights({"m": ref.layout(spec)}, 2 ** 31 + 5, "cpu",
                     arch_of(REPO, "moonlight"))["m"]
    g = torch.Generator().manual_seed(7)
    ins = {}
    if "img" in modality:
        ins[0] = torch.rand(3, 32, 32, 3, generator=g) * 2 - 1
    if "txt" in modality:
        ins[1] = torch.randint(5, 120, (3, 12), generator=g)
    out = ref.forward(spec, w, ins, Products())
    for slot, y in out.items():
        first, total = PINNED[(modality, slot)]
        assert [float(v) for v in y[0, :3]] == pytest.approx(first,
                                                            rel=1e-5)
        assert float(y.double().abs().sum()) == pytest.approx(total,
                                                              rel=1e-5)
    assert ref.param_count(spec) == sum(
        t.numel() for t in _leaves(w))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
