"""Pretrained ViT import for the image tower (reference ``pretrain_vit``,
mome.py:788-816).  Port of ``fedcola_tpu/models/pretrained.py``.

The reference loads timm's ``vit_{tiny,small}_patch16_224`` checkpoint and
remaps ``patch_embed -> embeddings.{i}.embed``, ``blocks -> blockses.{i}``,
plus the cls / pos tokens (mome.py:801-813).  Here the same remap targets
the port's tree: torch ``[out, in]`` Linear weights transpose to ``[in,
out]`` kernels, and per-layer tensors stack on the depth axis.

Checkpoints are found on the machine, never downloaded, in this order:

1. the ``.npz`` / ``.pt`` file named by ``FEDCOLA_PRETRAIN_<SRC>`` (``SRC``
   the timm name upper-cased), or ``pretrain.pt`` in the working directory
   for the ``*ours*`` models (mome.py:794-799);
2. a file under ``~/.cache/torch/hub/checkpoints`` or
   ``~/.cache/huggingface`` whose name holds the timm name;
3. otherwise a warning, and training starts from the random init.

:func:`write_timm_vit_checkpoint` writes such a checkpoint (timm's layout,
random weights from a seed) for runs that have none.
"""

from __future__ import annotations

import logging
import os
import pickle
import zipfile
from typing import Optional

import numpy as np
import torch

from fedcola_tpu_torch.models.mat import MATConfig, Params

logger = logging.getLogger(__name__)

_BLOCK_KEYS = (  # port leaf, timm suffix, transposed
    ("norm1_scale", "norm1.weight", False), ("norm1_bias", "norm1.bias", False),
    ("qkv_kernel", "attn.qkv.weight", True), ("qkv_bias", "attn.qkv.bias", False),
    ("proj_kernel", "attn.proj.weight", True),
    ("proj_bias", "attn.proj.bias", False),
    ("norm2_scale", "norm2.weight", False), ("norm2_bias", "norm2.bias", False),
    ("fc1_kernel", "mlp.fc1.weight", True), ("fc1_bias", "mlp.fc1.bias", False),
    ("fc2_kernel", "mlp.fc2.weight", True), ("fc2_bias", "mlp.fc2.bias", False),
)


def _torch_vit_to_stack(sd, cfg: MATConfig, slot: str, params: Params) -> Params:
    """Remap a timm VisionTransformer state dict (name -> array or tensor)
    into a copy of ``params``; raises ``KeyError`` on a missing block key
    and ``ValueError`` on a tensor of the wrong shape."""

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    def fit(old, new, what):
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"{what}: checkpoint shape {tuple(new.shape)}, "
                             f"model {tuple(old.shape)}")
        return new.to(old.device, old.dtype).contiguous()

    emb = dict(params["emb"][slot])
    if "patch_embed.proj.weight" in sd:
        # [D, C, P, P] -> [P, P, C, D]
        emb["patch_kernel"] = t(sd["patch_embed.proj.weight"]).permute(2, 3, 1, 0)
        emb["patch_bias"] = t(sd["patch_embed.proj.bias"])
    if "cls_token" in sd:
        emb["cls"] = t(sd["cls_token"])
    if "pos_embed" in sd:
        emb["pos"] = t(sd["pos_embed"])
    emb = {k: fit(params["emb"][slot][k], v, f"emb.{k}")
           for k, v in emb.items()}

    blk = dict(params["blk"][slot])
    for leaf, suffix, transpose in _BLOCK_KEYS:
        rows = [t(sd[f"blocks.{j}.{suffix}"]) for j in range(cfg.depth)]
        blk[leaf] = fit(params["blk"][slot][leaf],
                        torch.stack([r.T if transpose else r for r in rows]),
                        f"blk.{leaf}")
    new = dict(params)
    new["emb"] = dict(params["emb"]); new["emb"][slot] = emb
    new["blk"] = dict(params["blk"]); new["blk"][slot] = blk
    # the shared final LayerNorm loads too: timm's top-level norm.weight /
    # norm.bias match MAT's `self.norm` by name under the reference's
    # load_state_dict(strict=False) (mome.py:813)
    if "norm.weight" in sd:
        new["norm"] = {k: fit(params["norm"][k], t(sd[name]), f"norm.{k}")
                       for k, name in (("scale", "norm.weight"),
                                       ("bias", "norm.bias"))}
    # not loaded, as in the reference: its 'ours' head remap 'head' ->
    # 'heads.head' (mome.py:796-799) names no MAT module (the heads are
    # 'heads.{i}.head.*'), so strict=False drops it and the heads keep
    # their random init there too

    # the aux weights start as copies of the main kernels (mome.py:768-786)
    # and the import overwrote those kernels: copy them again so that
    # W_eff == W at scale 0
    if cfg.has_aux and "aux" in params and int(slot) == cfg.main_slot:
        aux = dict(params["aux"])
        for kind in cfg.aux_layer_kinds:
            aux[f"{kind}_aux"] = blk[f"{kind}_kernel"].clone()
        new["aux"] = aux
    return new


def write_timm_vit_checkpoint(path: str, embed_dim: int, depth: int,
                              img_size: int = 224, patch_size: int = 16,
                              mlp_ratio: float = 4.0,
                              seed: int = 0) -> str:
    """Write a timm-``VisionTransformer``-layout state dict as ``.npz``
    (the key set ``_torch_vit_to_stack`` remaps) with timm-style random
    init: trunc-normal(0.02) kernels, zero biases, unit LayerNorm scales.
    The same numpy draws as the JAX package's writer, so the same bytes.

    It gives ``--pretrained`` a fixed local checkpoint (point
    ``FEDCOLA_PRETRAIN_<SRC>`` at the file), so that the import, the aux
    re-sync and training from loaded weights run without a download."""
    rng = np.random.RandomState(seed)
    D, H = embed_dim, int(embed_dim * mlp_ratio)
    n_tok = (img_size // patch_size) ** 2 + 1

    def tn(*shape):
        # numpy analog of timm's trunc_normal_(std=.02)
        return np.clip(rng.normal(0.0, 0.02, shape), -0.04, 0.04) \
            .astype(np.float32)

    sd = {
        "patch_embed.proj.weight": tn(D, 3, patch_size, patch_size),
        "patch_embed.proj.bias": np.zeros((D,), np.float32),
        "cls_token": tn(1, 1, D),
        "pos_embed": tn(1, n_tok, D),
        "norm.weight": np.ones((D,), np.float32),
        "norm.bias": np.zeros((D,), np.float32),
    }
    for j in range(depth):
        p = f"blocks.{j}."
        sd[p + "norm1.weight"] = np.ones((D,), np.float32)
        sd[p + "norm1.bias"] = np.zeros((D,), np.float32)
        sd[p + "attn.qkv.weight"] = tn(3 * D, D)
        sd[p + "attn.qkv.bias"] = np.zeros((3 * D,), np.float32)
        sd[p + "attn.proj.weight"] = tn(D, D)
        sd[p + "attn.proj.bias"] = np.zeros((D,), np.float32)
        sd[p + "norm2.weight"] = np.ones((D,), np.float32)
        sd[p + "norm2.bias"] = np.zeros((D,), np.float32)
        sd[p + "mlp.fc1.weight"] = tn(H, D)
        sd[p + "mlp.fc1.bias"] = np.zeros((H,), np.float32)
        sd[p + "mlp.fc2.weight"] = tn(D, H)
        sd[p + "mlp.fc2.bias"] = np.zeros((D,), np.float32)
    np.savez(path, **sd)
    return path


def _find_checkpoint(src_name: str) -> Optional[str]:
    env = os.environ.get(f"FEDCOLA_PRETRAIN_{src_name.upper()}")
    if env and os.path.exists(env):
        return env
    if "ours" in src_name and os.path.exists("pretrain.pt"):
        return "pretrain.pt"
    for cache_root in (os.path.expanduser("~/.cache/torch/hub/checkpoints"),
                       os.path.expanduser("~/.cache/huggingface")):
        if os.path.isdir(cache_root):
            for root, _, files in os.walk(cache_root):
                for f in files:
                    if src_name in f and f.endswith((".pth", ".pt", ".npz")):
                        return os.path.join(root, f)
    return None


def _read_state_dict(path: str):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return sd


def load_pretrained_vit(cfg: MATConfig, params: Params,
                        src_name: Optional[str]) -> Params:
    """Import the checkpoint of ``src_name`` into the image slot (the
    reference passes ['vit_small_patch16_224', None], mome.py:952); each
    leaf keeps its device and dtype.  Without an image slot, a source or a
    checkpoint that maps onto the model, ``params`` come back unchanged
    (with a warning where a checkpoint was missing or did not map)."""
    if src_name is None:
        return params
    img_slot = next((str(i) for i, m in enumerate(cfg.modalities)
                     if m == "img"), None)
    if img_slot is None:
        return params
    path = _find_checkpoint(src_name)
    if path is None:
        logger.warning(
            "pretrained checkpoint %s not found locally; proceeding from "
            "random init (no network downloads are attempted)", src_name)
        return params
    try:
        sd = _read_state_dict(path)
        new = _torch_vit_to_stack(sd, cfg, img_slot, params)
    except (OSError, KeyError, ValueError, RuntimeError,
            pickle.UnpicklingError, zipfile.BadZipFile) as e:
        # the cache walk matches by file name, so a file of another format
        # or model can land here
        logger.warning(
            "pretrained checkpoint %s at %s could not be remapped (%s); "
            "proceeding from random init", src_name, path, e)
        return params
    logger.info("loaded pretrained %s from %s", src_name, path)
    return new
