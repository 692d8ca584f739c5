"""Reference-style parameter names for scope rules and checkpoint parity.

The reference classifies parameters by *torch state_dict name substrings*
(``get_name_type`` / ``get_name_modality``, fedavgserver.py:94-115) and its
aggregation, upload, and aux-exchange machinery all key on those names.  We
keep the structured/stacked pytree for compute, and expose a bijection to
flat reference-style names for:

* the per-parameter scope table (``_init_param_scope``, fedavgserver.py:183-238),
* aggregation coefficient computation (fedavgserver.py:591-668),
* upload semantics (state_dict incl. scope-'all' aliases & aux fold-in,
  fedavgclient.py:158-184),
* import/export of torch checkpoints.

Names are emitted *per stacked leaf*, not per depth-layer: scope
classification never depends on the layer index, only on the substring
pattern and the ``blockses.{slot}`` index, so one name per stacked leaf —
``blockses.{slot}.*.attn.qkv.weight`` — carries exactly the same scope and
modality information as the reference's twelve per-layer names.  (Per-layer
names are materialised only by the torch-checkpoint import/export helpers.)
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from fedcola_tpu_torch.models.mat import MATConfig

# leaf-path (tuple) -> reference-style name template pieces ----------------

_IMG_EMB_LEAVES = {
    "patch_kernel": "embeddings.{i}.embed.proj.weight",
    "patch_bias": "embeddings.{i}.embed.proj.bias",
    "cls": "embeddings.{i}.cls_token",
    "pos": "embeddings.{i}.pos_embed",
}
_TXT_EMB_LEAVES = {
    "word": "embeddings.{i}.text_embeddings.word_embeddings.weight",
    "posemb": "embeddings.{i}.text_embeddings.position_embeddings.weight",
    "toktype": "embeddings.{i}.text_embeddings.token_type_embeddings.weight",
    "ln_scale": "embeddings.{i}.text_embeddings.LayerNorm.weight",
    "ln_bias": "embeddings.{i}.text_embeddings.LayerNorm.bias",
}
_BLK_LEAVES = {
    "norm1_scale": "blockses.{i}.*.norm1.weight",
    "norm1_bias": "blockses.{i}.*.norm1.bias",
    "qkv_kernel": "blockses.{i}.*.attn.qkv.weight",
    "qkv_bias": "blockses.{i}.*.attn.qkv.bias",
    "proj_kernel": "blockses.{i}.*.attn.proj.weight",
    "proj_bias": "blockses.{i}.*.attn.proj.bias",
    "norm2_scale": "blockses.{i}.*.norm2.weight",
    "norm2_bias": "blockses.{i}.*.norm2.bias",
    "fc1_kernel": "blockses.{i}.*.mlp.fc1.weight",
    "fc1_bias": "blockses.{i}.*.mlp.fc1.bias",
    "fc2_kernel": "blockses.{i}.*.mlp.fc2.weight",
    "fc2_bias": "blockses.{i}.*.mlp.fc2.bias",
}
_AUX_LAYER_OF_KIND = {
    "qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}
# The moonlight block (models/moe.py), under the published module names
# (DeepSeek-V3's self_attn as ``attn``): MLA leaves are ``attn`` leaves, so
# that ``--shared_param attn`` averages them across modalities; every FFN
# leaf, the routed experts' included, is a ``blockses`` leaf of its
# dataset's scope.
_MOON_AUX_LAYER_OF_KIND = {
    "q": "attn.q_proj", "kv_a": "attn.kv_a_proj_with_mqa",
    "kv_b": "attn.kv_b_proj", "o": "attn.o_proj",
    "dense_gate": "mlp.gate_proj", "dense_up": "mlp.up_proj",
    "dense_down": "mlp.down_proj",
    "shared_gate": "mlp.shared_experts.gate_proj",
    "shared_up": "mlp.shared_experts.up_proj",
    "shared_down": "mlp.shared_experts.down_proj",
    "expert_gate": "mlp.experts.*.gate_proj",
    "expert_up": "mlp.experts.*.up_proj",
    "expert_down": "mlp.experts.*.down_proj",
}
_MOON_BLK_LEAVES = {
    "attn_norm_scale": "blockses.{i}.*.norm1.weight",
    "kv_norm_scale": "blockses.{i}.*.attn.kv_a_layernorm.weight",
    "ffn_norm_scale": "blockses.{i}.*.norm2.weight",
    "router_kernel": "blockses.{i}.*.mlp.gate.weight",
    "router_bias": "blockses.{i}.*.mlp.gate.e_score_correction_bias",
    **{f"{kind}_kernel": f"blockses.{{i}}.*.{layer}.weight"
       for kind, layer in _MOON_AUX_LAYER_OF_KIND.items()},
}


def _blk_leaves(cfg: MATConfig) -> Dict[str, str]:
    return _MOON_BLK_LEAVES if cfg.block == "moonlight" else _BLK_LEAVES


def aux_layer_of_kind(cfg: MATConfig, kind: str) -> str:
    """The reference-style layer name of an aux kind."""
    table = _MOON_AUX_LAYER_OF_KIND if cfg.block == "moonlight" \
        else _AUX_LAYER_OF_KIND
    return table[kind]


def get_name_type(name: str) -> str:
    """Parameter-type classification, substring precedence included
    (reference fedavgserver.py:94-104).  Note: mlp params inside blockses
    classify as 'blocks' because the 'blocks' check precedes 'mlp'."""
    if "embeddings" in name:
        return "embedding"
    if "attention" in name or "attn" in name:
        return "attn"
    if "blocks" in name:
        return "blocks"
    if "mlp" in name:
        return "mlp"
    return "task"


def get_first_number(name: str) -> Optional[int]:
    m = re.search(r"\d+", name)
    return int(m.group()) if m else None


def get_name_modality(name: str, modalities) -> Optional[str]:
    """Modality of a parameter from its blockses index
    (reference fedavgserver.py:106-115).  NOTE the reference passes the
    *experiment-level* ``args.modalities`` list here, and the first number in
    e.g. ``embeddings.0...`` also matches — replicate exactly."""
    idx = get_first_number(name)
    return modalities[idx] if idx is not None else None


def build_param_scope(param_names, shared_param: str, share_scope: str) -> Dict[str, str]:
    """Per-parameter-name scope table (reference fedavgserver.py:183-238)."""
    scope = {}
    for name in param_names:
        t = get_name_type(name)
        if shared_param == "none":
            scope[name] = "dataset"
        elif shared_param == "attn":
            scope[name] = share_scope if t == "attn" else "dataset"
        elif shared_param == "blocks":
            scope[name] = share_scope if t == "blocks" else "dataset"
        elif shared_param == "mlp":
            # parity quirk: block-mlp params classify as 'blocks', so this
            # branch shares nothing for MAT (documented in SURVEY.md §2.1)
            scope[name] = share_scope if t == "mlp" else "dataset"
        else:
            raise ValueError(f"unknown shared_param {shared_param!r}")
    return scope


# ---------------------------------------------------------- name emission --

def param_names(cfg: MATConfig, include_aux: bool = True,
                include_absent_blocks: bool = False) -> List[Tuple[Tuple[str, ...], str]]:
    """(pytree path, reference-style name) for every stacked leaf of a model.

    With ``include_absent_blocks`` (used for scope-'all' upload aliases), the
    None-slot block names are also emitted, pointing at the main slot's
    leaves — mirroring ``sync_shared_weights``'s module aliasing
    (mome.py:824-827) which duplicates the tied tensors under both names in
    the torch state_dict.
    """
    out: List[Tuple[Tuple[str, ...], str]] = []
    for i, modality in enumerate(cfg.modalities):
        s = str(i)
        if modality == "img":
            for leaf, tmpl in _IMG_EMB_LEAVES.items():
                out.append((("emb", s, leaf), tmpl.format(i=i)))
        elif modality == "txt":
            for leaf, tmpl in _TXT_EMB_LEAVES.items():
                out.append((("emb", s, leaf), tmpl.format(i=i)))

    colearn_attn = cfg.colearn_param == "attn" and cfg.is_multimodal
    attn_leaves = ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias")
    blk_leaves = _blk_leaves(cfg)
    for i, modality in enumerate(cfg.modalities):
        s = str(i)
        if modality is None:
            if include_absent_blocks and cfg.share_scope == "all":
                main = str(cfg.main_slot)
                for leaf, tmpl in blk_leaves.items():
                    out.append((("blk", main, leaf), tmpl.format(i=i)))
            continue
        for leaf, tmpl in blk_leaves.items():
            if colearn_attn and i != cfg.main_slot and leaf in attn_leaves:
                # tied to the main slot: both names exist, same leaf
                out.append((("blk", str(cfg.main_slot), leaf), tmpl.format(i=i)))
            else:
                out.append((("blk", s, leaf), tmpl.format(i=i)))

    out.append((("norm", "scale"), "norm.weight"))
    if cfg.block != "moonlight":            # RMSNorm has no bias
        out.append((("norm", "bias"), "norm.bias"))

    for i, task in enumerate(cfg.tasks):
        if task == "cls":
            out.append((("head", str(i), "kernel"), f"heads.{i}.head.weight"))
            out.append((("head", str(i), "bias"), f"heads.{i}.head.bias"))

    if include_aux and cfg.has_aux:
        main = cfg.main_slot
        for kind in cfg.aux_layer_kinds:
            layer = aux_layer_of_kind(cfg, kind)
            out.append((("aux", f"{kind}_aux"),
                        f"blockses.{main}.*.{layer}.aux_weight"))
            out.append((("aux", f"{kind}_scale"),
                        f"blockses.{main}.*.{layer}.cross_modal_scale"))
    return out


def required_param_names(cfg: MATConfig) -> List[Tuple[Tuple[str, ...], str]]:
    """Names exchanged with the server: state_dict minus None-slot blockses
    minus aux/cross_modal_scale keys (reference ``required_params``,
    mome.py:844-860)."""
    names = param_names(cfg, include_aux=False, include_absent_blocks=False)
    none_idx = [i for i, m in enumerate(cfg.modalities) if m is None]
    out = []
    for path, name in names:
        # dot-terminated prefix: "blockses.1" must not match "blockses.11"
        if any(f"blockses.{i}." in name for i in none_idx):
            continue
        out.append((path, name))
    return out


def upload_param_names(cfg: MATConfig) -> List[Tuple[Tuple[str, ...], str]]:
    """Names present in a client's upload (reference ``upload``,
    fedavgclient.py:158-184): the full state_dict — including scope-'all'
    alias names for tied None-slot blocks — with aux keys stripped and folded
    when ``with_aux`` (fold-in itself is ``fold_aux_into_upload`` in
    ``federation/aux.py``)."""
    return param_names(cfg, include_aux=False, include_absent_blocks=True)


def aux_param_names(cfg: MATConfig) -> List[Tuple[Tuple[str, ...], str]]:
    """Aux keys of present-modality blocks (reference ``aux_params``,
    mome.py:862-878)."""
    if not cfg.has_aux:
        raise ValueError("No aux params.")
    out = []
    main = cfg.main_slot
    for kind in cfg.aux_layer_kinds:
        layer = aux_layer_of_kind(cfg, kind)
        out.append(((("aux", f"{kind}_aux")),
                    f"blockses.{main}.*.{layer}.aux_weight"))
    return out


def get_by_path(params, path: Tuple[str, ...]):
    node = params
    for p in path:
        node = node[p]
    return node


def set_by_path(params, path: Tuple[str, ...], value):
    node = params
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value
