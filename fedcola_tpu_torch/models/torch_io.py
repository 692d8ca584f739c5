"""Reference-format state dicts: MAT parameters under the exact per-layer
names and layouts of the reference's ``ModalityAgnosticTransformer``
(mome.py:671-922), so checkpoints move both ways between the port and the
PyTorch reference.  Port of ``fedcola_tpu/models/torch_io.py``.

The reference's Linear / Conv weights are ``[out, in]`` / ``[out, in, kh,
kw]`` with one module per layer; the port's tree holds ``[in, out]`` /
``[kh, kw, in, out]`` kernels stacked on a leading depth axis.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from fedcola_tpu_torch.models.mat import MATConfig, Params, tree_map

_BLK_TORCH = {
    "norm1_scale": ("norm1.weight", False),
    "norm1_bias": ("norm1.bias", False),
    "qkv_kernel": ("attn.qkv.weight", True),
    "qkv_bias": ("attn.qkv.bias", False),
    "proj_kernel": ("attn.proj.weight", True),
    "proj_bias": ("attn.proj.bias", False),
    "norm2_scale": ("norm2.weight", False),
    "norm2_bias": ("norm2.bias", False),
    "fc1_kernel": ("mlp.fc1.weight", True),
    "fc1_bias": ("mlp.fc1.bias", False),
    "fc2_kernel": ("mlp.fc2.weight", True),
    "fc2_bias": ("mlp.fc2.bias", False),
}

_IMG_EMB = (("embed.proj.bias", "patch_bias"), ("cls_token", "cls"),
            ("pos_embed", "pos"))
_TXT_EMB = (("word_embeddings.weight", "word"),
            ("position_embeddings.weight", "posemb"),
            ("token_type_embeddings.weight", "toktype"),
            ("LayerNorm.weight", "ln_scale"), ("LayerNorm.bias", "ln_bias"))
_AUX_LAYER = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
              "fc2": "mlp.fc2"}


def _moonlight_layers(cfg: MATConfig, leaf: str) -> range:
    """The layers a moonlight stack leaf stacks: all, the dense ones or
    the MoE ones."""
    if leaf.startswith("dense_"):
        return range(cfg.dense_layers)
    if leaf.startswith(("router_", "shared_", "expert_")):
        return range(cfg.dense_layers, cfg.depth)
    return range(cfg.depth)


def _moonlight_entries(cfg: MATConfig, tmpl: str, leaf: str, arr,
                       transpose: bool):
    """(name, tensor) of a stacked moonlight leaf, one a layer and, for a
    routed expert's, one an expert (numbered in the router's range)."""
    for j, layer in enumerate(_moonlight_layers(cfg, leaf)):
        name = tmpl.replace("*", str(layer), 1)
        if leaf.startswith("expert_"):
            for e in range(arr.shape[1]):
                x = arr[j, e]
                yield name.replace("*", str(cfg.held_first + e)), \
                    x.T if transpose else x
        else:
            yield name, arr[j].T if transpose else arr[j]


def _moonlight_state_dict(cfg: MATConfig, p: Params) -> Dict[str, torch.Tensor]:
    """The moonlight block's stacks and aux under the published module
    names (models/naming.py), kernels as torch ``[out, in]``."""
    from fedcola_tpu_torch.models import naming
    sd: Dict[str, torch.Tensor] = {}
    for path, tmpl in naming.param_names(cfg, include_aux=False):
        if path[0] == "blk":
            leaf = path[-1]
            sd.update(_moonlight_entries(cfg, tmpl, leaf,
                                         p["blk"][path[1]][leaf],
                                         leaf.endswith("_kernel")))
    if cfg.has_aux and "aux" in p:
        for kind in cfg.aux_layer_kinds:
            base = f"blockses.{cfg.main_slot}.*." \
                f"{naming.aux_layer_of_kind(cfg, kind)}"
            leaf = f"{kind}_kernel"
            sd.update(_moonlight_entries(cfg, base + ".aux_weight", leaf,
                                         p["aux"][f"{kind}_aux"], True))
            for name, v in _moonlight_entries(
                    cfg, base + ".cross_modal_scale", leaf,
                    p["aux"][f"{kind}_scale"], False):
                sd[name] = v.reshape(1)
    return sd


def to_torch_state_dict(cfg: MATConfig, params: Params) -> Dict[str, torch.Tensor]:
    """Contiguous float32 CPU tensors under the reference's names, one
    entry per depth layer (and routed expert); colearn-tied leaves are read
    from the main slot."""
    p = tree_map(lambda t: t.detach().to("cpu", torch.float32), params)
    sd: Dict[str, torch.Tensor] = {}
    for i, modality in enumerate(cfg.modalities):
        s = str(i)
        if modality == "img":
            e = p["emb"][s]
            sd[f"embeddings.{i}.embed.proj.weight"] = \
                e["patch_kernel"].permute(3, 2, 0, 1)
            for name, leaf in _IMG_EMB:
                sd[f"embeddings.{i}.{name}"] = e[leaf]
        elif modality == "txt":
            e = p["emb"][s]
            for name, leaf in _TXT_EMB:
                sd[f"embeddings.{i}.text_embeddings.{name}"] = e[leaf]
        if modality is None or cfg.block == "moonlight":
            continue
        blk = p["blk"][s]
        for leaf, (suffix, transpose) in _BLK_TORCH.items():
            # colearn-attn tied leaves live on the main slot
            arr = blk[leaf] if leaf in blk \
                else p["blk"][str(cfg.main_slot)][leaf]
            for j in range(cfg.depth):
                sd[f"blockses.{i}.{j}.{suffix}"] = \
                    arr[j].T if transpose else arr[j]
    sd["norm.weight"] = p["norm"]["scale"]
    if cfg.block == "moonlight":
        sd.update(_moonlight_state_dict(cfg, p))
    else:
        sd["norm.bias"] = p["norm"]["bias"]
    for i, task in enumerate(cfg.tasks):
        if task == "cls":
            h = p["head"][str(i)]
            sd[f"heads.{i}.head.weight"] = h["kernel"].T
            sd[f"heads.{i}.head.bias"] = h["bias"]
    if cfg.has_aux and "aux" in p and cfg.block != "moonlight":
        for kind in cfg.aux_layer_kinds:
            aux, scale = p["aux"][f"{kind}_aux"], p["aux"][f"{kind}_scale"]
            for j in range(cfg.depth):
                base = f"blockses.{cfg.main_slot}.{j}.{_AUX_LAYER[kind]}"
                sd[f"{base}.aux_weight"] = aux[j].T
                sd[f"{base}.cross_modal_scale"] = scale[j:j + 1]
    return {k: v.contiguous() for k, v in sd.items()}


def from_torch_state_dict(cfg: MATConfig, params: Params,
                          sd: Mapping[str, object]) -> Params:
    """A copy of ``params`` with the reference-named tensors of ``sd``
    loaded, each on its leaf's device and in its dtype.  As
    ``load_state_dict(strict=False)``: missing keys keep their values, and
    a group (a stacked block leaf, the final norm, a head, an aux kind)
    loads only when all of its keys are present."""
    if cfg.block != "vit":
        raise NotImplementedError(f"loading a state dict into the "
                                  f"{cfg.block} block")
    out = tree_map(lambda t: t, params)

    def get(key):
        return torch.as_tensor(sd[key]).to("cpu", torch.float32)

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node[k]
        old = node[path[-1]]
        node[path[-1]] = value.to(old.device, old.dtype).contiguous()

    for i, modality in enumerate(cfg.modalities):
        s = str(i)
        if modality == "img":
            k = f"embeddings.{i}.embed.proj.weight"
            if k in sd:
                put(("emb", s, "patch_kernel"), get(k).permute(2, 3, 1, 0))
            for name, leaf in _IMG_EMB:
                if f"embeddings.{i}.{name}" in sd:
                    put(("emb", s, leaf), get(f"embeddings.{i}.{name}"))
        elif modality == "txt":
            for name, leaf in _TXT_EMB:
                k = f"embeddings.{i}.text_embeddings.{name}"
                if k in sd:
                    put(("emb", s, leaf), get(k))
        if modality is None or s not in out["blk"]:
            continue
        for leaf, (suffix, transpose) in _BLK_TORCH.items():
            keys = [f"blockses.{i}.{j}.{suffix}" for j in range(cfg.depth)]
            # a colearn-tied leaf lives on the main slot
            if leaf not in out["blk"][s] or not all(k in sd for k in keys):
                continue
            put(("blk", s, leaf), torch.stack(
                [get(k).T if transpose else get(k) for k in keys]))
    if "norm.weight" in sd and "norm.bias" in sd:
        put(("norm", "scale"), get("norm.weight"))
        put(("norm", "bias"), get("norm.bias"))
    for i, task in enumerate(cfg.tasks):
        w, b = f"heads.{i}.head.weight", f"heads.{i}.head.bias"
        if task == "cls" and w in sd and b in sd:
            put(("head", str(i), "kernel"), get(w).T)
            put(("head", str(i), "bias"), get(b))
    if cfg.has_aux and "aux" in out:
        for kind in cfg.aux_layer_kinds:
            bases = [f"blockses.{cfg.main_slot}.{j}.{_AUX_LAYER[kind]}"
                     for j in range(cfg.depth)]
            if not all(f"{b}.aux_weight" in sd
                       and f"{b}.cross_modal_scale" in sd for b in bases):
                continue
            put(("aux", f"{kind}_aux"),
                torch.stack([get(f"{b}.aux_weight").T for b in bases]))
            put(("aux", f"{kind}_scale"),
                torch.stack([get(f"{b}.cross_modal_scale")[0]
                             for b in bases]))
    return out
