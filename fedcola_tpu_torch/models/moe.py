"""Moonlight-16B-A3B's decoder layer (model_type deepseek_v3: the published
DeepSeek-V3 equations) as the MAT's block: ``MATConfig.block ==
"moonlight"``.  ``models/mat.py`` keeps the embeddings, the heads and the
server-facing tree; this module holds the block stack.

A stack of ``depth`` layers, the first ``dense_layers`` dense and the rest
MoE, each ``h = x + MLA(rms(x)); out = h + FFN(rms(h))`` with RMSNorm
(eps ``rms_eps``, in float32):

* MLA, no q LoRA, no biases: ``q = x W_q`` is H heads of (nope | rope);
  ``[c | k_pe] = x W_kv_a``; ``rms(c) W_kv_b`` is H heads of (k_nope | v);
  RoPE (theta ``rope_theta``, positions 0..N-1; the pairs (2i, 2i+1)
  rotated and laid out [evens | odds], as the published code's permute
  and ``rotate_half``) on q_pe and on the k_pe all heads share; the core
  at scale ``1 / sqrt(nope + rope)`` on
  ``torch.nn.functional.scaled_dot_product_attention`` (a library route:
  no kernel of the port takes head dims 192 and 128), then ``W_o``.  The
  core is held to the memory-efficient backend on CUDA (the math one on
  the CPU): the cuDNN backend, PyTorch's first choice on Hopper, does not
  repeat its bits from the forward to a remat recompute in the backward's
  thread, and a recompute that routes a near tie otherwise trains each
  layer's experts on a routing the loss never saw.
* The dense FFN and the shared experts: SiLU-GLU on ``torch.bmm``.
* The routed experts (``ops/moe_gemm.py``): sigmoid scores over
  ``router_experts`` in float32, the top ``top_k`` of scores + the
  selection bias, their weights normalised over the chosen and times
  ``routed_scale``; the chosen experts held here (``held_first ..
  held_first + experts_held - 1``, an expert-parallel share) run on the
  grouped GEMM, every token, none dropped; the combine sums each token's
  experts in float32.

Departures from the published model, written in the reference too
(``portbench/reference/moonlight.py``): attention is bidirectional (the
MAT is an encoder whose CLS token sees the whole sequence); the selection
bias is a leaf held at zero, which no gradient reaches (the configuration
gives no bias-update speed); the sequence-wise balance loss is left out
(its coefficient is not in the configuration); the experts not held here
are left out of the result.

Leaves of a slot's stack (kernels ``[in, out]``, a leading client axis
``[n]`` in the stacked trees): ``attn_norm_scale``, ``ffn_norm_scale``
``[L, D]``; ``kv_norm_scale [L, r]``; ``q_kernel``, ``kv_a_kernel``,
``kv_b_kernel``, ``o_kernel`` ``[L, ...]``; ``dense_{gate,up,down}_kernel``
over the dense layers; ``router_kernel``, ``router_bias`` and
``shared_{gate,up,down}_kernel`` over the MoE layers, and
``expert_{gate,up,down}_kernel`` ``[Lm, E, ...]`` with the held experts as
an axis of their own.  Every kernel but the router's is an aux kind
(``AUX_KINDS``): the aux fold ``W + s W_aux`` takes one scale a layer, and
one a routed expert.

Trace-only spans: ``mat.mla`` and ``mat.moe`` a layer, and on the device's
timeline ``moe.route``, ``moe.dispatch``, ``moe.experts`` (the kernel's
``fc_moe_gemm_fwd`` inside), ``moe.combine`` (their backwards too) and
``moe.shared``.  Round counters: ``moe_layers`` (MoE layer calls, a backward's
recompute not counted) and, in training, ``routed_rows`` (token-expert
pairs the held experts computed a step), summed on the device and read
back with the group's metrics (:func:`take_routed_rows`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from fedcola_tpu_torch.models import mat as _mat
from fedcola_tpu_torch.ops import moe_gemm
from fedcola_tpu_torch.utils.profiling import count, span

ATTN_KINDS = ("q", "kv_a", "kv_b", "o")
DENSE_KINDS = ("dense_gate", "dense_up", "dense_down")
MOE_KINDS = ("shared_gate", "shared_up", "shared_down", "expert_gate",
             "expert_up", "expert_down")
AUX_KINDS = ATTN_KINDS + DENSE_KINDS + MOE_KINDS

# the MLA core's backends: bitwise repeatable (see the module's docstring)
SDPA_BACKENDS = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]

# token-expert pairs computed in training, by device, until read back
_ROUTED: Dict[str, torch.Tensor] = {}


def kernel_shapes(cfg) -> Dict[str, tuple]:
    """Each kernel of a slot's stack by aux kind, with its layer axes."""
    D, H, L = cfg.embed_dim, cfg.num_heads, cfg.depth
    Ld, Lm, E = cfg.dense_layers, cfg.depth - cfg.dense_layers, \
        cfg.experts_held
    Fd, F_ = cfg.dense_hidden, cfg.moe_hidden
    Fs = cfg.shared_experts * F_
    r, nope, rope, vd = cfg.kv_lora_rank, cfg.qk_nope_head_dim, \
        cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"q": (L, D, H * (nope + rope)), "kv_a": (L, D, r + rope),
            "kv_b": (L, r, H * (nope + vd)), "o": (L, H * vd, D),
            "dense_gate": (Ld, D, Fd), "dense_up": (Ld, D, Fd),
            "dense_down": (Ld, Fd, D),
            "shared_gate": (Lm, D, Fs), "shared_up": (Lm, D, Fs),
            "shared_down": (Lm, Fs, D),
            "expert_gate": (Lm, E, D, F_), "expert_up": (Lm, E, D, F_),
            "expert_down": (Lm, E, F_, D)}


def aux_scale_shape(cfg, kind: str) -> tuple:
    shape = kernel_shapes(cfg)[kind]
    return shape[:2] if kind.startswith("expert") else shape[:1]


def init_stack(cfg, gen: torch.Generator) -> dict:
    """One slot's stack (float32, CPU): kernels as torch ``nn.Linear``
    initialises them (U(+-1/sqrt(fan_in))), norm scales one, the
    selection bias zero."""
    out = {}
    for kind, shape in kernel_shapes(cfg).items():
        bound = 1.0 / math.sqrt(shape[-2])
        out[f"{kind}_kernel"] = _mat._uniform(gen, shape, bound)
    Lm = cfg.depth - cfg.dense_layers
    out["router_kernel"] = _mat._uniform(
        gen, (Lm, cfg.embed_dim, cfg.router_experts),
        1.0 / math.sqrt(cfg.embed_dim))
    out["router_bias"] = torch.zeros(Lm, cfg.router_experts)
    for name, width in (("attn_norm_scale", cfg.embed_dim),
                        ("kv_norm_scale", cfg.kv_lora_rank),
                        ("ffn_norm_scale", cfg.embed_dim)):
        out[name] = torch.ones(cfg.depth, width)
    return out


# ------------------------------------------------------------ pieces -------

def rms_norm(x, scale, eps):
    """RMSNorm in float32, the result in x's dtype; ``scale [n, W]``
    broadcast over x ``[n, ..., W]``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    shape = (scale.shape[0],) + (1,) * (x.dim() - 2) + (scale.shape[-1],)
    return (y * scale.float().reshape(shape)).to(x.dtype)


def rope_tables(N: int, d: int, theta: float, device):
    """cos and sin ``[N, d/2]`` of positions 0..N-1, in float32."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=device).float() / d))
    ang = torch.outer(torch.arange(N, device=device).float(), inv)
    return ang.cos(), ang.sin()


def apply_rope(x, cos, sin):
    """Rotate the pairs (2i, 2i+1) of ``x [..., N, d]`` in float32; laid
    out [evens | odds], in x's dtype."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _bmm(x, w):
    """``[n, ..., K] @ [n, K, M]``."""
    n = x.shape[0]
    return torch.bmm(x.reshape(n, -1, x.shape[-1]), w).reshape(
        x.shape[:-1] + (w.shape[-1],))


def mla(cfg, x, w: dict):
    """Multi-head latent attention over ``x [n, B, N, D]`` (normed), with
    the layer's weights ``w`` in x's dtype."""
    n, B, N, _ = x.shape
    H = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    dq = nope + rope
    q = _bmm(x, w["q"]).reshape(n * B, N, H, dq).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    c, k_pe = _bmm(x, w["kv_a"]).split([cfg.kv_lora_rank, rope], dim=-1)
    kv = _bmm(rms_norm(c, w["kv_norm"], cfg.rms_eps), w["kv_b"])
    kv = kv.reshape(n * B, N, H, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    cos, sin = rope_tables(N, rope, cfg.rope_theta, x.device)
    q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
    k_pe = apply_rope(k_pe.reshape(n * B, 1, N, rope), cos, sin)
    k = torch.cat([k_nope, k_pe.expand(n * B, H, N, rope)], dim=-1)
    with sdpa_kernel(SDPA_BACKENDS):
        o = F.scaled_dot_product_attention(q, k, v, scale=dq ** -0.5)
    o = o.transpose(1, 2).reshape(n, B, N, H * vd)
    return _bmm(o, w["o"])


def glu(x, gate, up, down):
    """SiLU-GLU ``down(silu(x gate) * (x up))`` over stacked clients."""
    return _bmm(F.silu(_bmm(x, gate)) * _bmm(x, up), down)


def route(cfg, x, router, bias):
    """(chosen experts ``[n, T, k]``, weights ``[n, T, k]`` float32) of
    rows ``x [n, T, D]``: sigmoid scores in float32, the top ``k`` of
    scores + bias, the weights normalised over the chosen and times the
    routed scale."""
    scores = torch.sigmoid(torch.bmm(x.float(), router.float()))
    idx = (scores + bias.float()[:, None, :]).topk(cfg.top_k, dim=-1).indices
    wts = scores.gather(-1, idx)
    return idx, wts / (wts.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def moe_ffn(cfg, x, w: dict, train: bool):
    """An MoE FFN over ``x [n, B, N, D]`` (normed): the held experts' share
    of the routed sum, plus the shared experts."""
    n, B, N, D = x.shape
    T = B * N
    flat = x.reshape(n, T, D)
    with span("moe.route", timed=False, device=True):
        idx, wts = route(cfg, flat, w["router"], w["router_bias"])
    with span("moe.dispatch", timed=False, device=True):
        plan = moe_gemm.route_plan(idx, cfg.held_first, cfg.experts_held)
        xp = moe_gemm.dispatch(flat.reshape(n * T, D), plan)
    with span("moe.experts", timed=False, device=True):
        E, Fh = cfg.experts_held, cfg.moe_hidden
        yp = moe_gemm.grouped_glu(
            xp, w["expert_gate"].reshape(n * E, D, Fh),
            w["expert_up"].reshape(n * E, D, Fh),
            w["expert_down"].reshape(n * E, Fh, D), plan.poff)
    with span("moe.combine", timed=False, device=True):
        routed = moe_gemm.combine(yp, wts.reshape(n * T, cfg.top_k), plan)
    with span("moe.shared", timed=False, device=True):
        shared = glu(flat, w["shared_gate"], w["shared_up"],
                     w["shared_down"])
    if torch._C._current_graph_task_id() == -1:
        # not a recompute inside the backward (remat 'full')
        count("moe_layers")
        if train:
            _add_routed(plan.counts)
    out = routed.reshape(n, T, D) + shared.float()
    return out.to(x.dtype).reshape(n, B, N, D)


def _add_routed(counts: torch.Tensor) -> None:
    key = counts.device.type           # a process drives one device
    s = counts.sum()
    _ROUTED[key] = s if key not in _ROUTED else _ROUTED[key] + s


def take_routed_rows(device) -> Optional[torch.Tensor]:
    """The token-expert pairs computed in training on ``device`` since the
    last call (a device scalar), or None."""
    return _ROUTED.pop(torch.device(device).type, None)


# ------------------------------------------------------------- stack -------

def _layer_weights(cfg, blk: dict, layer: int, dt) -> dict:
    """Layer ``layer``'s weights: the attention's, the norms' and the dense
    FFN's or the shared experts' in ``dt``; the router and the routed
    experts' float32 masters (the grouped GEMM casts them itself, so their
    gradients leave in float32)."""
    def at(key, i, cast=True):
        t = blk[key][:, i]
        return (t.to(dt) if cast else t).contiguous()

    w = {k: at(f"{k}_kernel", layer) for k in ATTN_KINDS}
    w.update(attn_norm=at("attn_norm_scale", layer, False),
             kv_norm=at("kv_norm_scale", layer, False),
             ffn_norm=at("ffn_norm_scale", layer, False))
    if layer < cfg.dense_layers:
        w.update({k: at(f"dense_{k}_kernel", layer)
                  for k in ("gate", "up", "down")})
        return w
    m = layer - cfg.dense_layers
    w.update({f"shared_{k}": at(f"shared_{k}_kernel", m)
              for k in ("gate", "up", "down")})
    w.update({f"expert_{k}": at(f"expert_{k}_kernel", m, False)
              for k in ("gate", "up", "down")})
    w.update(router=at("router_kernel", m, False),
             router_bias=at("router_bias", m, False))
    return w


def run_stack(cfg, blk: dict, x: torch.Tensor, train: bool,
              gen) -> torch.Tensor:
    """The ``depth`` blocks over x ``[n, B, N, D]``.  Training keeps what
    autograd saves; ``remat_policy == 'full'`` keeps each layer's input
    alone and recomputes the layer in the backward."""
    n, B = x.shape[:2]
    dt = x.dtype
    use_dp = train and cfg.drop_path_rate > 0
    h = x
    for layer, rate in enumerate(cfg.drop_path_rates):
        with span("mat.weights", timed=False):
            w = _layer_weights(cfg, blk, layer, dt)
        masks = [_mat._drop_path_mask(rate, n, B, gen, x.device)
                 if use_dp else None for _ in range(2)]
        inv = _mat._keep_inv(rate, dt) if use_dp else None

        def block(h, w=w, layer=layer, masks=masks, inv=inv):
            with span("mat.mla", timed=False):
                a = mla(cfg, rms_norm(h, w["attn_norm"], cfg.rms_eps), w)
            h = h + _mat._drop_path(a, masks[0], inv)
            y = rms_norm(h, w["ffn_norm"], cfg.rms_eps)
            if layer < cfg.dense_layers:
                with span("mat.mlp", timed=False):
                    f = glu(y, w["gate"], w["up"], w["down"])
            else:
                with span("mat.moe", timed=False):
                    f = moe_ffn(cfg, y, w, train)
            return h + _mat._drop_path(f, masks[1], inv)

        h = _mat._ckpt(block, h) if train and cfg.remat_policy == "full" \
            else block(h)
    return h
