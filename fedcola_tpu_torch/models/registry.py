"""Model registry: the ``mome_*`` sizes (reference mome.py:924-1033) and
the per-dataset model construction of ``FedavgServer._init_model``
(fedavgserver.py:144-158).  Port of ``fedcola_tpu/models/registry.py``."""

from __future__ import annotations

from typing import Tuple

import torch

from fedcola_tpu_torch.config import (DATASET_2_MODALITY, DATASET_2_TASK,
                                      ExperimentConfig, NUM_CLASS, VOCAB_SIZES)
from fedcola_tpu_torch.models.mat import MATConfig, init_mat
from fedcola_tpu_torch.models.pretrained import load_pretrained_vit

# (embed_dim, depth, num_heads, pretrained timm source, img_size)
MODEL_SIZES = {
    "mome_small_patch16": (384, 12, 6, "vit_small_patch16_224", 224),
    "mome_tiny_patch16": (192, 12, 3, "vit_tiny_patch16_224", 224),
    "mome_small_patch16_224_in21k": (384, 12, 6, "vit_small_patch16_224_in21k", 224),
    "mome_base_patch16_224_ours": (768, 12, 12, "vit_small_patch16_224_ours", 224),
    "mome_toy_patch16_224": (4, 1, 2, None, 224),
    "mome_test_patch16_32": (8, 2, 2, "vit_test_patch16_32", 32),
    "mome_test16_patch16_32": (16, 2, 2, "vit_test16_patch16_32", 32),
}

# The moonlight block (models/moe.py): Moonlight-16B-A3B's decoder layer
# (huggingface.co/moonshotai/Moonlight-16B-A3B config.json, model_type
# deepseek_v3) at its published widths, cut to 5 layers (the dense layer
# and 4 MoE layers) and to the 8 of its 64 routed experts one chip of an
# eight-way expert-parallel deployment holds (experts 0-7); and a test
# width of the same shape.  MATConfig's field names, and the image size.
# Both recompute each layer in the backward (remat 'full'): at the
# published widths a client's training state and the harness's copies of
# the globals leave the activations too little of the card otherwise.
MOONLIGHT_SIZES = {
    "mome_moonlight_a3b": dict(
        embed_dim=2048, depth=5, num_heads=16, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        rope_theta=50000.0, dense_layers=1, dense_hidden=11264,
        moe_hidden=1408, router_experts=64, held_first=0, experts_held=8,
        top_k=6, shared_experts=2, routed_scale=2.446, rms_eps=1e-5,
        img_size=224, remat_policy="full"),
    "mome_moonlight_test": dict(
        embed_dim=64, depth=3, num_heads=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        rope_theta=50000.0, dense_layers=1, dense_hidden=128, moe_hidden=32,
        router_experts=16, held_first=0, experts_held=4, top_k=6,
        shared_experts=2, routed_scale=2.446, rms_eps=1e-5, img_size=32,
        remat_policy="full"),
}


def build_mat_config(model_name: str, cfg: ExperimentConfig,
                     dataset: str) -> MATConfig:
    if model_name in MOONLIGHT_SIZES:
        size = dict(MOONLIGHT_SIZES[model_name], block="moonlight")
    elif model_name in MODEL_SIZES:
        embed_dim, depth, num_heads, _, img_size = MODEL_SIZES[model_name]
        size = dict(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                    img_size=img_size)
    else:
        raise ValueError(f"unknown model {model_name!r}; registered: "
                         f"{sorted(MODEL_SIZES) + sorted(MOONLIGHT_SIZES)}")
    modality = DATASET_2_MODALITY[dataset]
    task = DATASET_2_TASK[dataset]
    nc = NUM_CLASS[dataset]
    if modality == "img":
        slots = dict(modalities=("img", None), tasks=(task, None),
                     num_classes=(nc, None))
    elif modality == "txt":
        slots = dict(modalities=(None, "txt"), tasks=(None, task),
                     num_classes=(None, nc))
    else:
        slots = dict(modalities=("img", "txt"), tasks=(task, task),
                     num_classes=(None, None))
    return MATConfig(
        patch_size=16,
        vocab_size=VOCAB_SIZES.get(dataset, cfg.vocab_size),
        max_text_len=cfg.seq_len,
        drop_path_rate=cfg.dropout,
        shared_param=cfg.shared_param,
        share_scope=cfg.share_scope,
        colearn_param=cfg.colearn_param,
        with_aux=cfg.with_aux,
        aux_trained=cfg.aux_trained,
        aux_attn_only=cfg.aux_attn_only,
        aux_mlp_only=cfg.aux_mlp_only,
        use_pallas=cfg.use_pallas,
        use_fused_mlp=cfg.use_pallas,
        compute_dtype=cfg.compute_dtype,
        **size, **slots,
    )


def create_model(model_name: str, cfg: ExperimentConfig, dataset: str,
                 gen: torch.Generator) -> Tuple[MATConfig, dict]:
    mat_cfg = build_mat_config(model_name, cfg, dataset)
    params = init_mat(mat_cfg, gen)
    if cfg.pretrained:
        if mat_cfg.block != "vit":
            raise ValueError(f"--pretrained loads a ViT; {model_name} has "
                             f"the {mat_cfg.block} block")
        params = load_pretrained_vit(mat_cfg, params,
                                     MODEL_SIZES[model_name][3])
    return mat_cfg, params
