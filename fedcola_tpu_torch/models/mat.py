"""ModalityAgnosticTransformer (MAT) in eager PyTorch over parameter trees.

Port of ``fedcola_tpu/models/mat.py``.  The parameter tree and its layout
are the JAX package's: the same nested keys, kernels ``[in, out]``, block
leaves stacked on a leading ``depth`` axis, the ``aux`` collection of
uni-modal ``with_aux`` models and the colearn-tied attention leaves absent
from non-main slots.  So ``models/naming.py`` paths and the aggregation
carry over unchanged, and ``models/convert.py`` moves trees between the two
packages as plain tree maps.

The forward works on *client-stacked* trees: every leaf has a leading
client axis ``[n, ...]`` and every input a leading ``[n, B, ...]``, so one
call trains or evaluates a whole client group and each kernel launch
covers all ``n`` clients.  :func:`mat_apply` is the single-model form
(``n = 1``).

Per block the stack is routed as the JAX ``_run_stack`` routes it.  Widths
on the 128 grid take the fused sublayers of ``ops/fused_*.py``: under
``remat_policy='kernel'`` the residual-folded training pair (kernels 1-4),
otherwise (eval, 'save_attn', 'full') the no-residual pair (kernels 1e, 5,
3e, 6).  Other widths (mome_tiny) take LayerNorm + ``multi_head_attention``
(the flash kernels 11/12, or plain ops with ``use_pallas`` off) and a plain
MLP, under 'save_attn'.  On CUDA tensors the kernels launch, on CPU
tensors their plain versions run; the route does not depend on the device.
DropPath draws come from a ``torch.Generator`` before any checkpointed
region, so a recompute sees the same draws.  Numerics follow the
reference: f32 attention scores and softmax, exact-erf GELU, LayerNorm eps
1e-5 in blocks, 1e-6 for the final norm and 1e-12 for the text embedding.

``MATConfig.block`` chooses the block: ``"vit"`` (the above) or
``"moonlight"``, Moonlight-16B-A3B's decoder layer (MLA attention, a
leading dense SiLU-GLU layer, then routed-expert layers), whose stack is
``models/moe.py``'s; its final norm is RMSNorm.  The embeddings and heads
are the same for both.

Under the mesh's ``model`` axis (``parallel/mesh.py`` ``TensorParallel``)
a training forward takes the Megatron route on the rank's shards: each
sharded attention sublayer runs its heads through the flash kernels (11 /
12) and each sharded MLP its hidden columns through the no-residual item
kernels (3e / 6), joined by one all-reduce a sublayer (the JAX package
runs no kernel under the axis; the fused attention sublayers do not run
here either).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fedcola_tpu_torch.ops.attention import (attention_heads,
                                             multi_head_attention)
from fedcola_tpu_torch.parallel.mesh import RankDraws, TensorParallel
from fedcola_tpu_torch.ops.flash_attention import MAX_HEAD_DIM, scale_as
from fedcola_tpu_torch.ops.fused_attention import (fused_attention,
                                                   fused_attention_residual)
from fedcola_tpu_torch.ops.fused_mlp import (
    fused_mlp_residual_sublayer_items, fused_mlp_sublayer_items)
from fedcola_tpu_torch.utils.profiling import span

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MATConfig:
    """Static model configuration: the JAX package's fields, less the
    tuning knobs the eager port has no use for (scan unroll, per-layer
    I/O, the remat on/off switch)."""
    modalities: Tuple[Optional[str], ...] = ("img", "txt")
    tasks: Tuple[Optional[str], ...] = ("cls", None)
    num_classes: Tuple[Optional[int], ...] = (None, None)
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    vocab_size: int = 30522
    max_text_len: int = 40
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    shared_param: str = "none"
    share_scope: str = "dataset"
    colearn_param: str = "none"
    with_aux: bool = False
    aux_trained: bool = False
    aux_attn_only: bool = False
    aux_mlp_only: bool = False
    use_pallas: bool = True
    # stacks shorter than this take the unfused attention path
    fused_attn_min_seq: int = 0
    use_fused_mlp: bool = False
    compute_dtype: str = "bfloat16"
    # 'kernel': the residual-folded fused sublayers save what their
    # backward kernels need (falls back to 'save_attn' where the fused
    # sublayers are off); 'save_attn': keep each layer's input and
    # attention output, recompute the rest; 'full': keep only the input
    # (the moonlight block: 'full', or else autograd keeps what it saves)
    remat_policy: str = "kernel"
    # the block: "vit" or "moonlight" (models/moe.py; the fields below are
    # its widths, in the published config's terms, and unused by "vit")
    block: str = "vit"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_theta: float = 0.0
    dense_layers: int = 0             # first_k_dense_replace
    dense_hidden: int = 0             # intermediate_size
    moe_hidden: int = 0               # moe_intermediate_size
    router_experts: int = 0           # the router's outputs
    held_first: int = 0               # the experts held here: held_first
    experts_held: int = 0             # .. held_first + experts_held - 1
    top_k: int = 0                    # num_experts_per_tok
    shared_experts: int = 0           # n_shared_experts
    routed_scale: float = 0.0         # routed_scaling_factor
    rms_eps: float = 1e-5

    FUSED_MAX_EMBED_DIM = 1024

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def fused_mlp_ok(self) -> bool:
        return (self.use_fused_mlp and self.embed_dim % 128 == 0
                and self.hidden_dim % 128 == 0
                and self.embed_dim <= self.FUSED_MAX_EMBED_DIM)

    @property
    def fused_attn_ok(self) -> bool:
        return (self.use_pallas and self.embed_dim % 128 == 0
                and self.embed_dim <= self.FUSED_MAX_EMBED_DIM)

    @property
    def main_slot(self) -> int:
        for i, m in enumerate(self.modalities):
            if m is not None:
                return i
        raise ValueError("model has no present modality")

    @property
    def is_multimodal(self) -> bool:
        return sum(m is not None for m in self.modalities) > 1

    @property
    def has_aux(self) -> bool:
        return self.with_aux and (None in self.modalities)

    @property
    def aux_layer_kinds(self) -> Tuple[str, ...]:
        if self.block == "moonlight":
            if self.aux_attn_only:
                return moe.ATTN_KINDS
            if self.aux_mlp_only:
                return moe.DENSE_KINDS + moe.MOE_KINDS
            return moe.AUX_KINDS
        if self.aux_attn_only:
            return ("qkv", "proj")
        if self.aux_mlp_only:
            return ("fc1", "fc2")
        return ("qkv", "proj", "fc1", "fc2")

    @property
    def drop_path_rates(self) -> Tuple[float, ...]:
        if self.depth == 1:
            return (0.0,)
        return tuple(float(x) for x in
                     np.linspace(0.0, self.drop_path_rate, self.depth))

    def replace(self, **kw) -> "MATConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------------- trees -------

def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List:
    """Leaves in sorted-key order (the order jax.tree_util uses)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def stack_clients(tree, n: int):
    """'download': one model tree -> an ``[n, ...]`` client-stacked copy."""
    return tree_map(lambda a: a.detach().unsqueeze(0).repeat(
        (n,) + (1,) * a.dim()), tree)


# -------------------------------------------------------------- init -------

def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _linear_init(gen, fan_in: int, shape_kernel, shape_bias):
    """torch nn.Linear default: U(+-1/sqrt(fan_in)) for kernel and bias."""
    bound = 1.0 / math.sqrt(fan_in)
    return _uniform(gen, shape_kernel, bound), _uniform(gen, shape_bias, bound)


def _init_image_embedding(cfg: MATConfig, gen) -> Params:
    P, C, D = cfg.patch_size, cfg.in_chans, cfg.embed_dim
    k, b = _linear_init(gen, C * P * P, (P, P, C, D), (D,))
    return {"patch_kernel": k, "patch_bias": b,
            "cls": torch.zeros(1, 1, D),
            "pos": torch.zeros(1, cfg.num_patches + 1, D)}


def _init_text_embedding(cfg: MATConfig, gen) -> Params:
    D = cfg.embed_dim
    return {"word": torch.randn(cfg.vocab_size, D, generator=gen),
            "posemb": torch.randn(cfg.max_text_len, D, generator=gen),
            "toktype": torch.randn(2, D, generator=gen),
            "ln_scale": torch.ones(D), "ln_bias": torch.zeros(D)}


def _init_block_stack(cfg: MATConfig, gen) -> Params:
    D, F, depth = cfg.embed_dim, cfg.hidden_dim, cfg.depth
    leaves: Dict[str, list] = {k: [] for k in (
        "qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias",
        "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")}
    for _ in range(depth):
        for name, fan_in, ks, bs in (("qkv", D, (D, 3 * D), (3 * D,)),
                                     ("proj", D, (D, D), (D,)),
                                     ("fc1", D, (D, F), (F,)),
                                     ("fc2", F, (F, D), (D,))):
            k, b = _linear_init(gen, fan_in, ks, bs)
            leaves[f"{name}_kernel"].append(k)
            leaves[f"{name}_bias"].append(b)
    out = {k: torch.stack(v) for k, v in leaves.items()}
    out.update(norm1_scale=torch.ones(depth, D), norm1_bias=torch.zeros(depth, D),
               norm2_scale=torch.ones(depth, D), norm2_bias=torch.zeros(depth, D))
    return out


def init_mat(cfg: MATConfig, gen: torch.Generator) -> Params:
    """The full parameter tree of one MAT (float32, on the CPU)."""
    moonlight = cfg.block == "moonlight"
    if moonlight and cfg.colearn_param != "none":
        raise NotImplementedError("--colearn_param ties the ViT block's "
                                  "attention leaves; the moonlight block "
                                  "takes 'none'")
    params: Params = {"emb": {}, "blk": {}, "head": {}}
    for i, modality in enumerate(cfg.modalities):
        if modality == "img":
            params["emb"][str(i)] = _init_image_embedding(cfg, gen)
        elif modality == "txt":
            params["emb"][str(i)] = _init_text_embedding(cfg, gen)
        elif modality is not None:
            raise NotImplementedError(modality)
        if modality is not None:
            if moonlight:
                params["blk"][str(i)] = moe.init_stack(cfg, gen)
            else:
                params["blk"][str(i)] = _init_block_stack(cfg, gen)
    # colearn_param='attn' ties the non-main slot's attention to the main
    # slot's (mome.py:837-841): the non-main leaves do not exist
    if cfg.colearn_param == "attn" and cfg.is_multimodal:
        main = str(cfg.main_slot)
        for i, m in enumerate(cfg.modalities):
            if m is not None and str(i) != main:
                for leaf in ("qkv_kernel", "qkv_bias", "proj_kernel",
                             "proj_bias"):
                    del params["blk"][str(i)][leaf]
    params["norm"] = {"scale": torch.ones(cfg.embed_dim)} if moonlight else \
        {"scale": torch.ones(cfg.embed_dim),
         "bias": torch.zeros(cfg.embed_dim)}
    for i, task in enumerate(cfg.tasks):
        if task == "cls":
            nc = cfg.num_classes[i]
            k, b = _linear_init(gen, cfg.embed_dim, (cfg.embed_dim, nc), (nc,))
            params["head"][str(i)] = {"kernel": k, "bias": b}
    # aux (mome.py:767-786): aux weights start as copies of the main
    # stack's kernels, the cross-modal scales at zero
    if cfg.has_aux:
        main_blk = params["blk"][str(cfg.main_slot)]
        params["aux"] = {}
        for kind in cfg.aux_layer_kinds:
            params["aux"][f"{kind}_aux"] = main_blk[f"{kind}_kernel"].clone()
            if moonlight:
                shape = moe.aux_scale_shape(cfg, kind)
            else:
                shape = (cfg.depth,)
            params["aux"][f"{kind}_scale"] = torch.zeros(shape)
    return params


# ----------------------------------------------------------- forward -------

def _layer_norm(x, scale, bias, eps):
    """LayerNorm in f32, result in x's dtype; scale/bias ``[n, D]``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    shape = (scale.shape[0],) + (1,) * (x.dim() - 2) + (scale.shape[-1],)
    return (y * scale.float().reshape(shape)
            + bias.float().reshape(shape)).to(x.dtype)


def fold_aux_kernels(cfg: MATConfig, blk: Params, aux: Params) -> Params:
    """``W_eff = W + scale * W_aux`` over ``cfg.aux_layer_kinds``
    (mome.py:58-60); single ``[depth, ...]`` or stacked ``[n, depth, ...]``
    trees (a routed expert kernel ``[.., layers, experts, in, out]`` with
    a scale an expert).  Shared by the forward and the upload fold-in."""
    blk = dict(blk)
    for kind in cfg.aux_layer_kinds:
        scale = aux[f"{kind}_scale"][..., :, None, None]
        blk[f"{kind}_kernel"] = blk[f"{kind}_kernel"] + scale * aux[f"{kind}_aux"]
    return blk


def _effective_kernels(cfg: MATConfig, params: Params, slot: str) -> Params:
    blk = dict(params["blk"][slot])
    if cfg.has_aux and int(slot) == cfg.main_slot and "aux" in params:
        blk = fold_aux_kernels(cfg, blk, params["aux"])
    if cfg.colearn_param == "attn" and cfg.is_multimodal \
            and int(slot) != cfg.main_slot:
        main = params["blk"][str(cfg.main_slot)]
        for leaf in ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias"):
            blk[leaf] = main[leaf]
    return blk


def check_kernel_support(cfg: MATConfig) -> None:
    """Refuse, on the card, what no CUDA kernel of this port covers: both
    attention routes take head_dim <= 64.  Every sequence length runs: the
    kernels stream the keys past 256 tokens, and the flash route runs the
    plain attention past 1024 (``ops/flash_attention.py``), as the JAX
    package does."""
    if cfg.block == "moonlight":
        # the grouped GEMM takes bf16 operands with 16-byte rows; the MLA
        # core runs on torch's scaled_dot_product_attention
        if cfg.compute_dtype != "bfloat16" or cfg.embed_dim % 8 \
                or cfg.moe_hidden % 8:
            raise NotImplementedError(
                f"the moonlight block's grouped GEMM takes bfloat16 with D "
                f"and the expert width multiples of 8, not "
                f"{cfg.compute_dtype}, D {cfg.embed_dim}, F "
                f"{cfg.moe_hidden}")
        return
    if not cfg.use_pallas:
        return
    hd = cfg.embed_dim // cfg.num_heads
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"embed_dim {cfg.embed_dim} / {cfg.num_heads} heads: the "
            f"attention kernels take head_dim <= {MAX_HEAD_DIM}")


def _drop_path_mask(rate: float, n: int, B: int, draws: RankDraws,
                    device) -> torch.Tensor:
    """Per-sample keep mask ``[n, B]``: uniform < 1 - rate."""
    return draws.rand((n, B), device) < 1.0 - rate


def _keep_inv(rate: float, dtype) -> float:
    """``1 / keep`` computed in float32 and rounded to the activation dtype
    (the JAX ``_drop_path``)."""
    return scale_as(dtype, np.float32(1.0) / (np.float32(1.0)
                                              - np.float32(rate)))


def _drop_path(x: torch.Tensor, mask: Optional[torch.Tensor],
               inv: Optional[float]) -> torch.Tensor:
    """timm DropPath with the draw passed in: ``where(mask, x * inv, 0)``
    in x's dtype (mat.py ``_drop_path``); identity without a mask."""
    if mask is None:
        return x
    return torch.where(mask[:, :, None, None], x * inv, torch.zeros_like(x))


def _mlp_plain(h, ln2, w):
    """The unfused MLP sublayer (LN, fc1, exact GELU, fc2), matmul operands
    and results in h's dtype as the JAX package's XLA branch."""
    n, B, N, D = h.shape
    w1, b1, w2, b2 = w
    m = _layer_norm(h, ln2[0], ln2[1], 1e-5).reshape(n, B * N, D)
    m = torch.nn.functional.gelu(torch.matmul(m, w1) + b1[:, None, :])
    return (torch.matmul(m, w2) + b2[:, None, :]).reshape(n, B, N, D)


def _sublayers(cfg: MATConfig, fused_attn: bool, fused_mlp_: bool,
               flash: bool, ln1, attn_w, ln2, mlp_w, masks, inv):
    """One layer's non-residual-folded pieces, bound to its weights and
    DropPath draws (so a checkpoint's recompute sees the same ones):
    ``attn(h) -> a``, ``mlp_join(h1) -> h1 + dp(mlp(h1))`` and the whole
    ``layer(h)``."""
    def attn(h):
        with span("mat.attn", timed=False):
            if fused_attn:
                return fused_attention(h, *ln1, *attn_w, cfg.num_heads)
            return multi_head_attention(
                _layer_norm(h, ln1[0], ln1[1], 1e-5), *attn_w, cfg.num_heads,
                use_pallas=flash)

    def mlp_join(h1):
        with span("mat.mlp", timed=False):
            m = fused_mlp_sublayer_items(h1, *ln2, *mlp_w) if fused_mlp_ \
                else _mlp_plain(h1, ln2, mlp_w)
            return h1 + _drop_path(m, masks[1], inv)

    def layer(h):
        return mlp_join(h + _drop_path(attn(h), masks[0], inv))

    return attn, mlp_join, layer


def _ckpt(fn, x):
    # the DropPath draws are taken outside, so no RNG state to replay
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)


def _tp_layer(cfg: MATConfig, tp: TensorParallel, h, flash: bool, ln1,
              attn_w, ln2, mlp_w, masks, inv, train: bool):
    """One layer on the rank's shards (Megatron): a sharded sublayer is
    ``enter`` (f), the rank's partial (its heads through the flash route;
    its hidden columns through the no-residual item MLP, or the plain MLP
    off the 128 grid, with a zero b2), ``reduce`` (g), then its output
    bias once; a replicated one runs whole.  Training checkpoints each
    partial ('kernel' and 'full' act as 'save_attn': the layer input and
    the all-reduced attention output are kept); every forward collective
    stays outside the checkpointed regions, so a recompute replays none
    (``enter`` is the identity forward)."""
    def ckpt(fn, x):
        return _ckpt(fn, x) if train else fn(x)

    def attn_part(x):
        with span("mat.attn", timed=False):
            xn = tp.enter(_layer_norm(x, ln1[0], ln1[1], 1e-5))
            return attention_heads(xn, *attn_w[:3],
                                   cfg.num_heads // tp.size,
                                   use_pallas=flash).reshape(x.shape)

    def mlp_part(x):
        with span("mat.mlp", timed=False):
            w = (*mlp_w[:3], torch.zeros_like(mlp_w[3]))
            if cfg.fused_mlp_ok:
                return fused_mlp_sublayer_items(tp.enter(x), *ln2, *w)
            return _mlp_plain(tp.enter(x), ln2, w)

    attn_whole, mlp_join, _ = _sublayers(cfg, False, cfg.fused_mlp_ok, flash,
                                         ln1, attn_w, ln2, mlp_w, masks, inv)
    a = tp.reduce(ckpt(attn_part, h)) + attn_w[3][:, None, None, :] \
        if tp.attn else ckpt(attn_whole, h)
    h = h + _drop_path(a, masks[0], inv)
    if not tp.mlp:
        return mlp_join(h) if cfg.fused_mlp_ok else ckpt(mlp_join, h)
    # the item kernels save only their inputs already
    m = mlp_part(h) if cfg.fused_mlp_ok else ckpt(mlp_part, h)
    return h + _drop_path(tp.reduce(m) + mlp_w[3][:, None, None, :],
                          masks[1], inv)


def _run_stack(cfg: MATConfig, blk: Params, x: torch.Tensor, train: bool,
               gen, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """The ``depth`` blocks over x ``[n, B, N, D]`` (a Python loop), routed
    as the JAX ``_run_stack`` (mat.py:427-591); ``tp``: the rank's shards
    of the ``model`` axis, each layer on :func:`_tp_layer`."""
    if cfg.block == "moonlight":
        if tp is not None:
            raise NotImplementedError("the model axis shards the ViT "
                                      "block only")
        return moe.run_stack(cfg, blk, x, train, gen)
    n, B, N = x.shape[:3]
    dt = x.dtype
    use_dp = train and cfg.drop_path_rate > 0
    fused_attn_here = (cfg.fused_attn_ok and N >= cfg.fused_attn_min_seq
                       and tp is None)
    flash = cfg.use_pallas and N >= cfg.fused_attn_min_seq
    policy = cfg.remat_policy
    if policy == "kernel" and not (fused_attn_here and cfg.fused_mlp_ok):
        policy = "save_attn"
    h = x

    def layer(l, key, cast=False):
        w = blk[key][:, l]
        return (w.to(dt) if cast else w).contiguous()

    for l, rate in enumerate(cfg.drop_path_rates):
        with span("mat.weights", timed=False):
            ln1 = (layer(l, "norm1_scale"), layer(l, "norm1_bias"))
            ln2 = (layer(l, "norm2_scale"), layer(l, "norm2_bias"))
            attn_w = [layer(l, k, True) for k in (
                "qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias")]
            mlp_w = [layer(l, k, True) for k in (
                "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")]
        masks = [_drop_path_mask(rate, n, B, gen, x.device)
                 if use_dp else None for _ in range(2)]
        if train and policy == "kernel":
            # the residual join and the DropPath scale run in the kernels
            s_a, s_m = (torch.ones((n, B), device=x.device) if m is None
                        else m.float() / (1.0 - rate) for m in masks)
            with span("mat.attn", timed=False):
                h = fused_attention_residual(h, s_a, *ln1, *attn_w,
                                             cfg.num_heads)
            with span("mat.mlp", timed=False):
                h = fused_mlp_residual_sublayer_items(h, s_m, *ln2, *mlp_w)
            continue
        inv = _keep_inv(rate, dt) if use_dp else None
        if tp is not None:
            h = _tp_layer(cfg, tp, h, flash, ln1, attn_w, ln2, mlp_w, masks,
                          inv, train)
            continue
        attn, mlp_join, whole = _sublayers(
            cfg, fused_attn_here, cfg.fused_mlp_ok, flash, ln1, attn_w, ln2,
            mlp_w, masks, inv)
        if not train:
            h = whole(h)
        elif policy == "full":
            h = _ckpt(whole, h)
        else:
            # 'save_attn': keep the attention output; recompute the rest.
            # The fused sublayers save only their inputs already.
            a = attn(h) if fused_attn_here else _ckpt(attn, h)
            h = h + _drop_path(a, masks[0], inv)
            h = mlp_join(h) if cfg.fused_mlp_ok else _ckpt(mlp_join, h)
    return h


def _embed_image(cfg: MATConfig, emb: Params, x: torch.Tensor, train: bool,
                 gen) -> torch.Tensor:
    """Patchify ``[n, B, H, W, C]`` -> ``[n, B, P+1, D]`` as a matmul."""
    dtype = DTYPES[cfg.compute_dtype]
    n, B, H, W, C = x.shape
    P = cfg.patch_size
    if C == 1 and cfg.in_chans == 3:
        x = x.repeat(1, 1, 1, 1, 3)
        C = 3
    x = x.to(dtype)
    if (H, W) != (cfg.img_size, cfg.img_size):
        raise ValueError(
            f"input image size ({H}x{W}) doesn't match model "
            f"({cfg.img_size}x{cfg.img_size}); if --crop is set it must "
            "equal the model's img_size (the reference asserts the same, "
            "mome.py:262-263)")
    gh, gw = H // P, W // P
    x = x.reshape(n, B, gh, P, gw, P, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(n, B * gh * gw, P * P * C)
    kernel = emb["patch_kernel"].reshape(n, P * P * C, cfg.embed_dim)
    x = torch.bmm(x, kernel.to(dtype)).reshape(n, B, gh * gw, cfg.embed_dim)
    x = x + emb["patch_bias"].to(dtype)[:, None, None, :]
    cls = emb["cls"].to(dtype)[:, None, 0].expand(n, B, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=2) + emb["pos"].to(dtype)[:, None, 0]
    if train and cfg.drop_rate > 0:
        keep = gen.rand(x.shape, x.device) >= cfg.drop_rate
        x = torch.where(keep, x / (1 - cfg.drop_rate), torch.zeros_like(x))
    return x


def _word_partial(word: torch.Tensor, ids: torch.Tensor, index: int
                  ) -> torch.Tensor:
    """A model rank's part of the word lookup: ``word`` ``[n, V/size, D]``
    its rows ``index * V/size ...``; ids outside them give zero rows, so
    the sum over the model ranks is the whole lookup."""
    n, per = word.shape[:2]
    local = ids.long() - index * per
    inside = (local >= 0) & (local < per)
    rows = torch.arange(n, device=ids.device)[:, None, None]
    x = word[rows, local.clamp(0, per - 1)]
    return torch.where(inside[..., None], x, torch.zeros_like(x))


def _embed_text(cfg: MATConfig, emb: Params, ids: torch.Tensor, train: bool,
                gen, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """BertEmbeddings: word + position + token-type(0), LayerNorm eps 1e-12.
    With a vocabulary-sharded ``tp`` the lookup is the sum of the model
    ranks' :func:`_word_partial`."""
    dtype = DTYPES[cfg.compute_dtype]
    n, B, L = ids.shape
    if tp is not None and tp.word:
        x = tp.reduce(_word_partial(emb["word"], ids, tp.index))
    else:
        rows = torch.arange(n, device=ids.device)[:, None, None]
        x = emb["word"][rows, ids.long()]
    x = x + emb["posemb"][:, None, :L]
    x = x + emb["toktype"][:, None, None, 0]
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], 1e-12)
    return x.to(dtype)


def mat_apply_stacked(cfg: MATConfig, params: Params,
                      inputs: Sequence[Optional[torch.Tensor]],
                      feat_out: bool = False, train: bool = False,
                      gen=None, seq_feat_out: bool = False,
                      tp: Optional[TensorParallel] = None):
    """Forward of a client-stacked tree (reference mome.py:881-922).

    ``inputs`` is slot-aligned: image slots take ``[n, B, H, W, C]`` floats,
    text slots ``[n, B, L]`` token ids, absent slots None.  Returns a
    slot-aligned list: cls logits ``[n, B, C]``, L2-normalised CLS features
    ``[n, B, D]`` (rtv head or ``feat_out``), or None.

    ``seq_feat_out`` returns the rtv head's literal output instead: the
    whole sequence after the final LayerNorm, every token L2-normalised,
    ``[n, B, N, D]`` float32 (mome.py:651-659).  Its one consumer is
    CreamFL's distillation, which sums it over tokens.

    ``gen``: a training forward's DropPath / dropout draws, a
    ``torch.Generator`` (whole ``[n, B, ...]`` tensors) or a mesh rank's
    ``RankDraws`` (its block of the whole group's).

    ``tp``: ``params`` is a model rank's cut (``TensorParallel.cut``) and
    the forward runs on the Megatron route."""
    if train and gen is None:
        raise ValueError("training forward needs a torch.Generator")
    if train and not isinstance(gen, RankDraws):
        n, B = next(a for a in inputs if a is not None).shape[:2]
        gen = RankDraws.whole(gen, n, B)
    outs: List[Optional[torch.Tensor]] = [None] * len(cfg.modalities)
    for i, modality in enumerate(cfg.modalities):
        if modality is None or inputs[i] is None:
            continue
        s = str(i)
        with span("mat.embed", timed=False):
            if modality == "img":
                h = _embed_image(cfg, params["emb"][s], inputs[i], train,
                                 gen)
            else:
                h = _embed_text(cfg, params["emb"][s], inputs[i], train,
                                gen, tp)
        h = _run_stack(cfg, _effective_kernels(cfg, params, s), h, train, gen,
                       tp)
        with span("mat.head", timed=False):
            outs[i] = _head(cfg, params, i, h, feat_out, seq_feat_out)
    return outs


def _head(cfg: MATConfig, params: Params, i: int, h: torch.Tensor,
          feat_out: bool, seq_feat_out: bool) -> torch.Tensor:
    """Slot ``i``'s output from the stack's ``h``: the final LayerNorm,
    then the whole normalised sequence, the normalised CLS feature, the
    class logits or the CLS token (see :func:`mat_apply_stacked`)."""
    if cfg.block == "moonlight":
        h = moe.rms_norm(h, params["norm"]["scale"], cfg.rms_eps)
    else:
        h = _layer_norm(h, params["norm"]["scale"], params["norm"]["bias"],
                        1e-6)
    if seq_feat_out:
        hf = h.float()
        return hf / torch.clamp(hf.norm(dim=-1, keepdim=True), min=1e-12)
    cls_tok = h[:, :, 0].float()
    if feat_out or cfg.tasks[i] == "rtv":
        norm = cls_tok.norm(dim=-1, keepdim=True)
        return cls_tok / torch.clamp(norm, min=1e-12)
    if cfg.tasks[i] == "cls":
        head = params["head"][str(i)]
        return torch.bmm(cls_tok, head["kernel"].float()) \
            + head["bias"].float()[:, None, :]
    return cls_tok


def mat_apply(cfg: MATConfig, params: Params,
              inputs: Sequence[Optional[torch.Tensor]],
              feat_out: bool = False, train: bool = False,
              gen: Optional[torch.Generator] = None,
              seq_feat_out: bool = False):
    """Single-model forward: ``params`` without a client axis, inputs
    ``[B, ...]`` (the JAX ``mat_apply`` signature)."""
    stacked = tree_map(lambda a: a.unsqueeze(0), params)
    ins = [None if a is None else a.unsqueeze(0) for a in inputs]
    outs = mat_apply_stacked(cfg, stacked, ins, feat_out, train, gen,
                             seq_feat_out)
    return [None if o is None else o[0] for o in outs]


# the moonlight block's stack imports this module's helpers
from fedcola_tpu_torch.models import moe  # noqa: E402
