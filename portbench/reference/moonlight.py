"""Moonlight-16B-A3B's decoder layer (model_type deepseek_v3, the
published DeepSeek-V3 equations) as the block of FedCola's multi-modal
transformer, in plain float32 PyTorch, one model and one batch at a time.

The embeddings and heads are the MAT's (``reference/mat.py``): patch + CLS
+ learned positions for images; BERT word + position + token type 0 and
LayerNorm (eps 1e-12) for text; the CLS token through a classification
head, or L2-normalised for retrieval.  Each present slot has its own stack
of ``depth`` blocks: ``dense_layers`` leading dense layers, then MoE
layers.  A block, with RMSNorm ``rms(x, w) = x * rsqrt(mean(x²) + eps) *
w``:

    h = x + MLA(rms(x, attn_norm));   out = h + FFN(rms(h, ffn_norm))

MLA (no q LoRA, no biases): ``q = x W_q`` gives H heads of (nope | rope);
``[c | k_pe] = x W_kv_a``; ``rms(c, kv_norm) W_kv_b`` gives H heads of
(k_nope | v); RoPE (theta ``rope_theta``, positions 0..N-1, the pairs
(2i, 2i+1) rotated and written out as [evens | odds], as the published
code's permute and ``rotate_half`` do) goes on q_pe and on the one k_pe
every head shares; scores ``q kᵀ / sqrt(nope + rope)``, softmax, times v,
then ``W_o``.  The dense FFN is SiLU-GLU, ``down(silu(x W_gate) * x
W_up)``.  An MoE FFN: ``s = sigmoid(x W_router)`` over ``router_experts``
experts in float32; the top ``top_k`` of ``s + b`` are chosen (``b``, the
selection bias); their weights are ``s`` normalised over the chosen and
times ``routed_scale``; the output is the sum over the chosen experts held
here (``held_first .. held_first + held - 1``) of ``w_e E_e(x)``, plus
the shared experts' SiLU-GLU of width ``shared x moe_hidden``.  No token
is dropped.  The final norm is RMSNorm.

Departures from the published model, which the program shares:

* attention is bidirectional: the MAT is an encoder whose CLS token has to
  see the whole sequence;
* the selection bias ``b`` stays zero and is not updated: the
  configuration gives no bias-update speed;
* the sequence-wise balance loss is left out: its coefficient is not in
  the configuration;
* only the experts held here compute (a chip's share of an expert-parallel
  deployment); the others' part of the result is left out.

A uni-modal model with aux folds ``W + s * W_aux`` into every attention
kernel (q, kv_a, kv_b, o) and every expert kernel (dense, shared and
routed, each routed expert with its own scale); the router is not an aux
kind.  The parameters are a nested dict, kernels ``[in, out]``: a block
stack's attention and norm leaves carry a leading axis of all ``depth``
layers, the dense FFN's of the dense layers, the MoE leaves of the MoE
layers, and the routed experts an axis of their own after it.
``portbench/arch/moonlight.py`` hands this model to the harness.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.mat import _embed as _mat_embed, \
    contrastive, cross_entropy, preprocess  # noqa: F401
from portbench.reference.precision import Products

ATTN_KINDS = ("q", "kv_a", "kv_b", "o")
DENSE_KINDS = ("dense_gate", "dense_up", "dense_down")
MOE_KINDS = ("shared_gate", "shared_up", "shared_down", "expert_gate",
             "expert_up", "expert_down")
AUX_KINDS = ATTN_KINDS + DENSE_KINDS + MOE_KINDS


@dataclass(frozen=True)
class ModelSpec:
    modalities: Tuple[Optional[str], Optional[str]]   # (img|None, txt|None)
    tasks: Tuple[Optional[str], Optional[str]]        # cls | rtv | None
    classes: Tuple[Optional[int], Optional[int]]
    embed_dim: int
    depth: int
    dense_layers: int
    heads: int
    nope: int
    rope: int
    v_dim: int
    kv_rank: int
    rope_theta: float
    dense_hidden: int
    moe_hidden: int
    router_experts: int
    held_first: int
    held: int
    top_k: int
    shared: int
    routed_scale: float
    eps: float
    img_size: int
    patch: int
    in_chans: int
    vocab: int
    text_len: int
    with_aux: bool

    @property
    def main_slot(self) -> int:
        return 0 if self.modalities[0] is not None else 1

    @property
    def has_aux(self) -> bool:
        return self.with_aux and None in self.modalities

    @property
    def moe_layers(self) -> int:
        return self.depth - self.dense_layers


def model_spec(config: dict, modality: str, task: str,
               classes: Optional[int], with_aux: bool) -> ModelSpec:
    """The model of one dataset, at the configuration's widths (the keys
    of the published config.json, ``n_routed_experts`` being the experts
    held here)."""
    slots = {"img": (("img", None), (task, None), (classes, None)),
             "txt": ((None, "txt"), (None, task), (None, classes)),
             "img+txt": (("img", "txt"), (task, task), (None, None))}
    mods, tasks, ncls = slots[modality]
    c = config
    return ModelSpec(
        mods, tasks, ncls, int(c["hidden_size"]),
        int(c["num_hidden_layers"]), int(c["first_k_dense_replace"]),
        int(c["num_attention_heads"]), int(c["qk_nope_head_dim"]),
        int(c["qk_rope_head_dim"]), int(c["v_head_dim"]),
        int(c["kv_lora_rank"]), float(c["rope_theta"]),
        int(c["intermediate_size"]), int(c["moe_intermediate_size"]),
        int(c["router_experts"]), int(c["experts_held_first"]),
        int(c["n_routed_experts"]), int(c["num_experts_per_tok"]),
        int(c["n_shared_experts"]), float(c["routed_scaling_factor"]),
        float(c["rms_norm_eps"]), int(c["img_size"]), int(c["patch_size"]),
        int(c["in_chans"]), int(c["vocab_size"]), int(c["max_text_len"]),
        with_aux)


def kernel_shapes(s: ModelSpec) -> Dict[str, Tuple[int, ...]]:
    """Every kernel of a block stack by aux kind, with its layer axes."""
    D, H, L = s.embed_dim, s.heads, s.depth
    Ld, Lm, E = s.dense_layers, s.moe_layers, s.held
    Fd, F_, Fs = s.dense_hidden, s.moe_hidden, s.shared * s.moe_hidden
    return {"q": (L, D, H * (s.nope + s.rope)),
            "kv_a": (L, D, s.kv_rank + s.rope),
            "kv_b": (L, s.kv_rank, H * (s.nope + s.v_dim)),
            "o": (L, H * s.v_dim, D),
            "dense_gate": (Ld, D, Fd), "dense_up": (Ld, D, Fd),
            "dense_down": (Ld, Fd, D),
            "shared_gate": (Lm, D, Fs), "shared_up": (Lm, D, Fs),
            "shared_down": (Lm, Fs, D),
            "expert_gate": (Lm, E, D, F_), "expert_up": (Lm, E, D, F_),
            "expert_down": (Lm, E, F_, D)}


def aux_scale_shape(s: ModelSpec, kind: str) -> Tuple[int, ...]:
    """One scale a layer, and one a routed expert of a layer."""
    shape = kernel_shapes(s)[kind]
    return shape[:2] if kind.startswith("expert") else shape[:1]


def layout(s: ModelSpec) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """Every leaf as (path, shape, init kind); kinds: ``normal``, ``one``
    (an RMSNorm or LayerNorm scale), ``zero`` (the selection bias, the aux
    scales), ``copy`` (an aux kernel: the main stack's kernel of its
    kind)."""
    D, P, C = s.embed_dim, s.patch, s.in_chans
    L, Lm = s.depth, s.moe_layers
    out = []
    for i, m in enumerate(s.modalities):
        e = ("emb", str(i))
        if m == "img":
            n = (s.img_size // P) ** 2 + 1
            out += [(e + ("patch_kernel",), (P, P, C, D), "normal"),
                    (e + ("patch_bias",), (D,), "normal"),
                    (e + ("cls",), (1, 1, D), "normal"),
                    (e + ("pos",), (1, n, D), "normal")]
        elif m == "txt":
            out += [(e + ("word",), (s.vocab, D), "normal"),
                    (e + ("posemb",), (s.text_len, D), "normal"),
                    (e + ("toktype",), (2, D), "normal"),
                    (e + ("ln_scale",), (D,), "one"),
                    (e + ("ln_bias",), (D,), "normal")]
    shapes = kernel_shapes(s)
    for i, m in enumerate(s.modalities):
        if m is None:
            continue
        b = ("blk", str(i))
        out += [(b + ("attn_norm_scale",), (L, D), "one"),
                (b + ("kv_norm_scale",), (L, s.kv_rank), "one"),
                (b + ("ffn_norm_scale",), (L, D), "one"),
                (b + ("router_kernel",), (Lm, D, s.router_experts),
                 "normal"),
                (b + ("router_bias",), (Lm, s.router_experts), "zero")]
        out += [(b + (f"{k}_kernel",), shapes[k], "normal")
                for k in AUX_KINDS]
    out.append((("norm", "scale"), (D,), "one"))
    for i, t in enumerate(s.tasks):
        if t == "cls":
            out += [(("head", str(i), "kernel"), (D, s.classes[i]), "normal"),
                    (("head", str(i), "bias"), (s.classes[i],), "normal")]
    if s.has_aux:
        for k in AUX_KINDS:
            out += [(("aux", f"{k}_aux"), shapes[k], "copy"),
                    (("aux", f"{k}_scale"), aux_scale_shape(s, k), "zero")]
    return out


# --------------------------------------------------------------- forward --

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(N: int, d: int, theta: float, device):
    """cos and sin ``[N, d/2]`` of positions 0..N-1 (float32, as the
    published rotary embedding computes them)."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=device).float() / d))
    ang = torch.outer(torch.arange(N, device=device).float(), inv)
    return ang.cos(), ang.sin()


def apply_rope(x, cos, sin):
    """Rotate the pairs (2i, 2i+1) of ``x [..., N, d]``; the result laid
    out [evens | odds]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mla(s: ModelSpec, mm: Products, x, w: dict, l: int):
    B, N, _ = x.shape
    H, dq = s.heads, s.nope + s.rope
    q = mm.mm(x, w["q_kernel"][l]).reshape(B, N, H, dq).transpose(1, 2)
    q_nope, q_pe = q.split([s.nope, s.rope], dim=-1)
    c, k_pe = mm.mm(x, w["kv_a_kernel"][l]).split([s.kv_rank, s.rope],
                                                  dim=-1)
    kv = mm.mm(rms_norm(c, w["kv_norm_scale"][l], s.eps),
               w["kv_b_kernel"][l])
    kv = kv.reshape(B, N, H, s.nope + s.v_dim).transpose(1, 2)
    k_nope, v = kv.split([s.nope, s.v_dim], dim=-1)
    cos, sin = rope_tables(N, s.rope, s.rope_theta, x.device)
    q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
    k_pe = apply_rope(k_pe[:, None], cos, sin).expand(B, H, N, s.rope)
    k = torch.cat([k_nope, k_pe], dim=-1)
    att = torch.softmax(mm.mm(q, k.transpose(-1, -2), wide_out=True)
                        * dq ** -0.5, dim=-1)
    o = mm.mm(att, v).transpose(1, 2).reshape(B, N, H * s.v_dim)
    return mm.mm(o, w["o_kernel"][l])


def glu(mm: Products, x, gate, up, down):
    """SiLU-GLU: ``down(silu(x gate) * (x up))``."""
    return mm.mm(F.silu(mm.mm(x, gate)) * mm.mm(x, up), down)


def route(s: ModelSpec, x, router, bias):
    """(chosen experts ``[T, k]``, their weights ``[T, k]``) of rows ``x
    [T, D]``: sigmoid scores in float32, the top ``k`` of scores + bias,
    weights normalised over the chosen, times the routed scale."""
    scores = torch.sigmoid(x.float() @ router.float())
    idx = (scores + bias).topk(s.top_k, dim=-1).indices
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * s.routed_scale


def routed(s: ModelSpec, mm: Products, x, w: dict, l: int, first: int,
           held: int):
    """The routed part of MoE layer ``l`` (of the MoE layers) over rows
    ``x [T, D]`` from the experts ``first .. first + held - 1``, whose
    kernels are ``w``'s expert leaves ``0 .. held - 1``; every token an
    expert is chosen for, none dropped."""
    idx, wts = route(s, x, w["router_kernel"][l], w["router_bias"][l])
    out = torch.zeros_like(x)
    for e in range(held):
        rows, slot = (idx == first + e).nonzero(as_tuple=True)
        if len(rows) == 0:
            continue
        y = glu(mm, x[rows], w["expert_gate_kernel"][l, e],
                w["expert_up_kernel"][l, e], w["expert_down_kernel"][l, e])
        out = out.index_add(0, rows, y * wts[rows, slot, None])
    return out


def _ffn(s: ModelSpec, mm: Products, x, w: dict, layer: int):
    if layer < s.dense_layers:
        return glu(mm, x, w["dense_gate_kernel"][layer],
                   w["dense_up_kernel"][layer], w["dense_down_kernel"][layer])
    l = layer - s.dense_layers
    B, N, D = x.shape
    flat = x.reshape(B * N, D)
    out = routed(s, mm, flat, w, l, s.held_first, s.held) + glu(
        mm, flat, w["shared_gate_kernel"][l], w["shared_up_kernel"][l],
        w["shared_down_kernel"][l])
    return out.reshape(B, N, D)


def _kernels(s: ModelSpec, p: dict, slot: int) -> dict:
    blk = dict(p["blk"][str(slot)])
    if s.has_aux and slot == s.main_slot and "aux" in p:
        for k in AUX_KINDS:
            scale = p["aux"][f"{k}_scale"][..., None, None]
            blk[f"{k}_kernel"] = blk[f"{k}_kernel"] + scale * p["aux"][f"{k}_aux"]
    return blk


def block(s: ModelSpec, mm: Products, h, w: dict, layer: int):
    h = mm.act(h + _mla(s, mm, rms_norm(h, w["attn_norm_scale"][layer],
                                        s.eps), w, layer))
    return mm.act(h + _ffn(s, mm, rms_norm(h, w["ffn_norm_scale"][layer],
                                           s.eps), w, layer))


def forward(s: ModelSpec, p: dict, inputs: Dict[int, torch.Tensor],
            mm: Products, feat_out: bool = False) -> Dict[int, torch.Tensor]:
    """Per given slot: logits ``[B, C]`` of a classification slot, or the
    L2-normalised CLS feature ``[B, D]`` (retrieval slots, ``feat_out``).
    Image inputs are preprocessed floats ``[B, H, W, C]``, text inputs
    token ids ``[B, L]``."""
    out = {}
    for slot, x in inputs.items():
        h = mm.act(_mat_embed(s, mm, p["emb"][str(slot)], s.modalities[slot],
                              x))
        w = _kernels(s, p, slot)
        for layer in range(s.depth):
            h = block(s, mm, h, w, layer)
        h = rms_norm(h, p["norm"]["scale"], s.eps)
        cls = h[:, 0]
        if feat_out or s.tasks[slot] == "rtv":
            out[slot] = cls / cls.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        else:
            head = p["head"][str(slot)]
            out[slot] = cls @ head["kernel"] + head["bias"]
    return out


def fold_aux(s: ModelSpec, p: dict) -> dict:
    """A uni-modal aux model's upload: aux folded into the main kernels,
    the aux collection dropped."""
    out = {k: v for k, v in p.items() if k != "aux"}
    if s.has_aux and "aux" in p:
        out["blk"] = dict(p["blk"])
        out["blk"][str(s.main_slot)] = _kernels(s, p, s.main_slot)
    return out


def param_count(s: ModelSpec) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(s))
