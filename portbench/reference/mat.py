"""The multi-modal transformer of FedCola (reference mome.py) in plain
float32 PyTorch, one model and one batch at a time.

A model has two input slots, image (0) and text (1); a uni-modal model
leaves the other slot out.  Each present slot has its own embedding and
its own stack of ``depth`` pre-norm blocks (LayerNorm eps 1e-5; qkv laid
out q | k | v on the output axis, heads inside each; exact-erf GELU); one
final LayerNorm (eps 1e-6) serves both slots; the CLS token of a slot goes
through its classification head, or is L2-normalised for retrieval.  A
uni-modal model with aux folds ``W + scale * W_aux`` into its qkv, proj,
fc1 and fc2 kernels.  The text embedding is BERT's: word + position +
token type 0, LayerNorm eps 1e-12.

The parameters are a nested dict in the layout both sides share (leaves
of a block stack carry a leading ``depth`` axis, kernels are ``[in,
out]``); :func:`layout` lists it.  ``portbench/arch/mat.py`` hands this
model to the harness.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Products

AUX_KINDS = ("qkv", "proj", "fc1", "fc2")


@dataclass(frozen=True)
class ModelSpec:
    modalities: Tuple[Optional[str], Optional[str]]   # (img|None, txt|None)
    tasks: Tuple[Optional[str], Optional[str]]        # cls | rtv | None
    classes: Tuple[Optional[int], Optional[int]]
    embed_dim: int
    depth: int
    heads: int
    hidden: int
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


def model_spec(config: dict, modality: str, task: str,
               classes: Optional[int], with_aux: bool) -> ModelSpec:
    """The model of one dataset, at the configuration's widths."""
    slots = {"img": (("img", None), (task, None), (classes, None)),
             "txt": ((None, "txt"), (None, task), (None, classes)),
             "img+txt": (("img", "txt"), (task, task), (None, None))}
    mods, tasks, ncls = slots[modality]
    D = int(config["embed_dim"])
    return ModelSpec(mods, tasks, ncls, D, int(config["depth"]),
                     int(config["num_heads"]),
                     int(round(D * float(config["mlp_ratio"]))),
                     int(config["img_size"]), int(config["patch_size"]),
                     int(config["in_chans"]), int(config["vocab_size"]),
                     int(config["max_text_len"]), with_aux)


def layout(s: ModelSpec) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """Every leaf as (path, shape, init kind); kinds: ``normal``, ``one``
    (a LayerNorm scale), ``zero`` (the aux scales), ``copy`` (an aux
    kernel: the main stack's kernel of its kind)."""
    D, F_, L, P, C = s.embed_dim, s.hidden, s.depth, s.patch, s.in_chans
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
    for i, m in enumerate(s.modalities):
        if m is None:
            continue
        b = ("blk", str(i))
        for name, shape in (("qkv_kernel", (L, D, 3 * D)),
                            ("qkv_bias", (L, 3 * D)),
                            ("proj_kernel", (L, D, D)), ("proj_bias", (L, D)),
                            ("fc1_kernel", (L, D, F_)), ("fc1_bias", (L, F_)),
                            ("fc2_kernel", (L, F_, D)), ("fc2_bias", (L, D))):
            out.append((b + (name,), shape, "normal"))
        for name in ("norm1", "norm2"):
            out += [(b + (f"{name}_scale",), (L, D), "one"),
                    (b + (f"{name}_bias",), (L, D), "normal")]
    out += [(("norm", "scale"), (D,), "one"), (("norm", "bias"), (D,),
                                               "normal")]
    for i, t in enumerate(s.tasks):
        if t == "cls":
            out += [(("head", str(i), "kernel"), (D, s.classes[i]), "normal"),
                    (("head", str(i), "bias"), (s.classes[i],), "normal")]
    if s.has_aux:
        for k, (a, b_) in zip(AUX_KINDS, ((D, 3 * D), (D, D), (D, F_),
                                          (F_, D))):
            out += [(("aux", f"{k}_aux"), (L, a, b_), "copy"),
                    (("aux", f"{k}_scale"), (L,), "zero")]
    return out


# --------------------------------------------------------------- forward --

def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def preprocess(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> float32 in [-1, 1] at ``img_size`` (bilinear,
    half-pixel centres)."""
    x = (x.float() / 255.0 - 0.5) / 0.5
    if x.shape[1] != img_size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(img_size, img_size),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)
    return x


def _kernels(s: ModelSpec, p: dict, slot: int) -> dict:
    blk = dict(p["blk"][str(slot)])
    if s.has_aux and slot == s.main_slot and "aux" in p:
        for k in AUX_KINDS:
            scale = p["aux"][f"{k}_scale"][:, None, None]
            blk[f"{k}_kernel"] = blk[f"{k}_kernel"] + scale * p["aux"][f"{k}_aux"]
    return blk


def _block(s: ModelSpec, mm: Products, h, w: dict, l: int):
    B, N, D = h.shape
    H, hd = s.heads, D // s.heads
    y = layer_norm(h, w["norm1_scale"][l], w["norm1_bias"][l], 1e-5)
    qkv = mm.mm(y, w["qkv_kernel"][l]) + w["qkv_bias"][l]
    q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    att = torch.softmax(mm.mm(q * hd ** -0.5, k.transpose(-1, -2),
                              wide_out=True), dim=-1)
    a = mm.mm(att, v).transpose(1, 2).reshape(B, N, D)
    h = mm.act(h + mm.mm(a, w["proj_kernel"][l]) + w["proj_bias"][l])
    y = layer_norm(h, w["norm2_scale"][l], w["norm2_bias"][l], 1e-5)
    m = F.gelu(mm.mm(y, w["fc1_kernel"][l]) + w["fc1_bias"][l])
    return mm.act(h + mm.mm(m, w["fc2_kernel"][l]) + w["fc2_bias"][l])


def _embed(s: ModelSpec, mm: Products, e: dict, modality: str, x):
    if modality == "img":
        B, H, W, C = x.shape
        P = s.patch
        x = x.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // P) * (W // P), P * P * C)
        x = mm.mm(x, e["patch_kernel"].reshape(P * P * C, s.embed_dim)) \
            + e["patch_bias"]
        cls = e["cls"][0].expand(B, 1, s.embed_dim)
        return torch.cat([cls, x], dim=1) + e["pos"][0]
    L = x.shape[1]
    h = e["word"][x.long()] + e["posemb"][:L] + e["toktype"][0]
    return layer_norm(h, e["ln_scale"], e["ln_bias"], 1e-12)


def forward(s: ModelSpec, p: dict, inputs: Dict[int, torch.Tensor],
            mm: Products, feat_out: bool = False) -> Dict[int, torch.Tensor]:
    """Per given slot: logits ``[B, C]`` of a classification slot, or the
    L2-normalised CLS feature ``[B, D]`` (retrieval slots, ``feat_out``).
    Image inputs are preprocessed floats ``[B, H, W, C]``, text inputs
    token ids ``[B, L]``."""
    out = {}
    for slot, x in inputs.items():
        h = mm.act(_embed(s, mm, p["emb"][str(slot)], s.modalities[slot], x))
        w = _kernels(s, p, slot)
        for l in range(s.depth):
            h = _block(s, mm, h, w, l)
        h = layer_norm(h, p["norm"]["scale"], p["norm"]["bias"], 1e-6)
        cls = h[:, 0]
        if feat_out or s.tasks[slot] == "rtv":
            out[slot] = cls / cls.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        else:
            head = p["head"][str(slot)]
            out[slot] = cls @ head["kernel"] + head["bias"]
    return out


CLIP_SCALE = 1.0 / 0.07


def cross_entropy(logits, y):
    return F.cross_entropy(logits, y.long())


def contrastive(fi, ft):
    """Symmetric CLIP loss at the fixed temperature 0.07."""
    logits = CLIP_SCALE * fi @ ft.T
    target = torch.arange(len(fi), device=fi.device)
    return 0.5 * (F.cross_entropy(logits, target)
                  + F.cross_entropy(logits.T, target))


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
