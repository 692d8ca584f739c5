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


def build_mat_config(model_name: str, cfg: ExperimentConfig,
                     dataset: str) -> MATConfig:
    if model_name not in MODEL_SIZES:
        raise ValueError(f"unknown model {model_name!r}; "
                         f"registered: {sorted(MODEL_SIZES)}")
    embed_dim, depth, num_heads, _, img_size = MODEL_SIZES[model_name]
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
        img_size=img_size, patch_size=16,
        embed_dim=embed_dim, depth=depth, num_heads=num_heads,
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
        **slots,
    )


def create_model(model_name: str, cfg: ExperimentConfig, dataset: str,
                 gen: torch.Generator) -> Tuple[MATConfig, dict]:
    mat_cfg = build_mat_config(model_name, cfg, dataset)
    params = init_mat(mat_cfg, gen)
    if cfg.pretrained:
        params = load_pretrained_vit(mat_cfg, params,
                                     MODEL_SIZES[model_name][3])
    return mat_cfg, params
