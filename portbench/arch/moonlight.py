"""Moonlight-16B-A3B's decoder layer as the MAT's block (the configuration
names ``"architecture": "moonlight"``).  Its plain reference is
``portbench/reference/moonlight.py``; its kernel route is the routed
experts' grouped GEMM (``experts``: ``fc_moe_gemm_fwd`` and
``fc_moe_gemm_bwd``).  The MLA core, the projections, the dense layer and
the shared experts run on library routes and have no roofline here.

Model FLOPs of one tower's forward over one sequence of N tokens (2
operations a multiply-add), a token's by layer kind, at the configuration's
widths (D hidden, H heads, r the kv rank, nope / rope / v head dims, Fd
the dense width, F the expert width, S shared experts):

    MLA           2D·H(nope+rope) + 2D(r+rope) + 2r·H(nope+v) + 2H·v·D
    core          2N·H(nope+rope) + 2N·H·v
    dense FFN     6D·Fd
    MoE FFN       2D·E_router (router) + 6D·S·F (shared)
                  + top_k · held / E_router · 6D·F (the routed experts
                  held here, at the routing's expectation)

The routed term is taken at its expectation, tokens x top_k x held /
E_router pairs, so that the count reads the same work whatever computes
it (the program's ``routed_rows`` counter gives the pairs it computed).
The image tower adds the patch embedding, a classification head 2·D·classes.
At the configuration's widths a token of the image tower is 477 MFLOP
(MLA 27.5, core 2.0 at N 197, dense 138.4, router 0.26, shared 34.6,
routed 13.0 a layer): an image forward 94.6 GFLOP, a 40-token text
forward 18.8.

The grouped GEMM's least time (``experts_least``): over R routed rows of
a layer (the expectation above), the forward's 6·R·D·F operations and the
backward's 12·R·D·F; bytes, each input read once and each output written
once: the forward reads the rows and the held experts' bf16 weights (once
a client) and writes the outputs (and, training, the kept g and u); the
backward reads dY, the rows, g, u and the weights and writes dX and the
float32 weight gradients.
"""

from __future__ import annotations

from functools import partial

from portbench.arch import Route
from portbench.counts.peaks import least_seconds
from portbench.reference.moonlight import AUX_KINDS, contrastive, \
    cross_entropy, fold_aux, forward, layout, model_spec, \
    preprocess as _preprocess  # noqa: F401

# ------------------------------------------------------------ model side --


def preprocess(spec, x):
    return _preprocess(x, spec.img_size)


def data_shapes(config: dict) -> dict:
    return {"pixels": int(config["img_size"]),
            "vocab": int(config["vocab_size"]),
            "text_len": int(config["max_text_len"])}


# ------------------------------------------------------- federation side --

ATTN_LEAVES = ("q_kernel", "kv_a_kernel", "kv_norm_scale", "kv_b_kernel",
               "o_kernel")


def shared_leaf(path) -> bool:
    """The MLA leaves of a block stack (the published ``self_attn``)."""
    return path[0] == "blk" and path[-1] in ATTN_LEAVES


def exchanged(path) -> bool:
    return path[0] == "aux"


def has_aux(spec) -> bool:
    return spec.has_aux


def exchange_aux(spec, tree: dict, src_spec, src_tree: dict) -> None:
    """A uni-modal model's aux kernels take the other modality's new
    main kernels, each routed expert its namesake's."""
    src = src_tree["blk"][str(src_spec.main_slot)]
    for k in AUX_KINDS:
        tree["aux"][f"{k}_aux"] = src[f"{k}_kernel"]


def parts(path: tuple, t):
    """The parameters a leaf holds: a block stack's leaf (``blk``, ``aux``)
    layer by layer, and a routed expert's kernel expert by expert."""
    if path[0] not in ("blk", "aux") or t.dim() == 1:
        yield path, t
        return
    for layer in range(t.shape[0]):
        x = t[layer]
        if path[-1].startswith("expert_") and x.dim() == 3:
            for e in range(x.shape[0]):
                yield path + (layer, e), x[e]
        else:
            yield path + (layer,), x


def copy_of(tree: dict, path: tuple):
    """An aux kernel starts as the main stack's kernel of its kind."""
    (main,) = tree["blk"].values()
    return main[path[-1].replace("_aux", "_kernel")]


# ---------------------------------------------------------------- counts --

def tokens(config: dict, tower: str) -> int:
    if tower == "img":
        return (config["img_size"] // config["patch_size"]) ** 2 + 1
    return int(config["max_text_len"])


def routed_share(config: dict) -> float:
    """Expert passes a token computes here, at the routing's expectation:
    top_k x held / router experts."""
    return config["num_experts_per_tok"] * config["n_routed_experts"] \
        / config["router_experts"]


def token_flops(config: dict, N: int) -> dict:
    """A token's forward FLOPs by part, at sequence length N."""
    c = config
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    r, F = c["kv_lora_rank"], c["moe_intermediate_size"]
    return {"mla": 2.0 * D * H * (nope + rope) + 2.0 * D * (r + rope)
            + 2.0 * r * H * (nope + v) + 2.0 * H * v * D,
            "core": 2.0 * N * H * (nope + rope) + 2.0 * N * H * v,
            "dense": 6.0 * D * c["intermediate_size"],
            "router": 2.0 * D * c["router_experts"],
            "shared": 6.0 * D * c["n_shared_experts"] * F,
            "routed": routed_share(c) * 6.0 * D * F}


def forward_flops(config: dict, tower: str, classes: int = 0) -> float:
    c = config
    D, N = c["hidden_size"], tokens(config, tower)
    f = token_flops(config, N)
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    per_token = L * (f["mla"] + f["core"]) + Ld * f["dense"] + (L - Ld) * (
        f["router"] + f["shared"] + f["routed"])
    total = N * per_token + 2.0 * D * classes
    if tower == "img":
        P, C = c["patch_size"], c["in_chans"]
        total += 2.0 * (N - 1) * P * P * C * D
    return total


def layers(config: dict, tower: str):
    """The dense layers and the MoE layers."""
    Ld = config["first_k_dense_replace"]
    return [(Ld, {**config, "layer_kind": "dense"}),
            (config["num_hidden_layers"] - Ld,
             {**config, "layer_kind": "moe"})]


def experts_calls(R: float, n: int, D: int, F: int, E: int, train: bool):
    """(operations, bytes) of the grouped GEMM's calls over R routed rows
    of one layer of ``n`` stacked clients, each holding E experts."""
    w = n * 3 * E * D * F
    fwd = (6.0 * R * D * F,
           2 * (2 * R * D) + 2 * w + (2 * 2 * R * F if train else 0))
    if not train:
        return [fwd]
    bwd = (12.0 * R * D * F, 2 * (3 * R * D + 2 * R * F) + (2 + 4) * w)
    return [fwd, bwd]


def experts_least(rows: int, n: int, N: int, layer: dict,
                  train: bool) -> float:
    """The least seconds of one layer's grouped GEMM calls over ``rows``
    valid sequences of length N of ``n`` stacked clients (none in a dense
    layer)."""
    if layer["layer_kind"] != "moe":
        return 0.0
    R = rows * N * routed_share(layer)
    return sum(least_seconds(o, b) for o, b in experts_calls(
        R, n, layer["hidden_size"], layer["moe_intermediate_size"],
        layer["n_routed_experts"], train))


def routes():
    return {"experts": Route(("fc_moe_gemm_fwd", "fc_moe_gemm_bwd"),
                             experts_least)}


# --------------------------------------------------------------- program --

def program_flags(config: dict):
    """The configuration's model, text length, DropPath rate and
    precision on the program's command line."""
    return ["--model_name", config["model_name"],
            "--seq_len", str(config["max_text_len"]),
            "--dropout", str(config["drop_path_rate"]),
            "--vocab_size", str(config["vocab_size"]),
            "--compute_dtype", config["compute_dtype"]]


def program_check(config: dict) -> dict:
    """The program's ``MATConfig`` at the configuration's widths."""
    c = config
    return {"block": "moonlight", "embed_dim": c["hidden_size"],
            "depth": c["num_hidden_layers"],
            "num_heads": c["num_attention_heads"],
            "kv_lora_rank": c["kv_lora_rank"],
            "qk_nope_head_dim": c["qk_nope_head_dim"],
            "qk_rope_head_dim": c["qk_rope_head_dim"],
            "v_head_dim": c["v_head_dim"],
            "rope_theta": float(c["rope_theta"]),
            "dense_layers": c["first_k_dense_replace"],
            "dense_hidden": c["intermediate_size"],
            "moe_hidden": c["moe_intermediate_size"],
            "router_experts": c["router_experts"],
            "held_first": c["experts_held_first"],
            "experts_held": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"],
            "shared_experts": c["n_shared_experts"],
            "routed_scale": c["routed_scaling_factor"],
            "rms_eps": c["rms_norm_eps"], "img_size": c["img_size"],
            "patch_size": c["patch_size"], "in_chans": c["in_chans"],
            "max_text_len": c["max_text_len"],
            "drop_path_rate": c["drop_path_rate"],
            "compute_dtype": c["compute_dtype"],
            "vocab_size": c["vocab_size"]}
