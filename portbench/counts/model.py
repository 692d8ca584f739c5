"""Model FLOPs: the matrix products and attention products of one tower's
forward over one sequence (2 operations a multiply-add), from the
configuration's widths.  Training counts 3 forwards a row; recomputation,
the optimizer, LayerNorm, softmax and the data path are not counted.

Per layer of width D, MLP width F, sequence N: qkv 6ND², proj 2ND², fc1
and fc2 4NDF, q.kᵀ and p.v 4N²D.  The image tower adds the patch
embedding, 2·(N-1)·P²C·D; a classification head adds 2·D·classes.
At mome_small (D 384, F 1536, 12 layers): an image forward is 9.2
GFLOP, a 40-token text forward 1.73, so a training img+txt pair is
3 x (9.20 + 1.73) = 32.8.
"""

from __future__ import annotations


def tokens(config: dict, tower: str) -> int:
    """Sequence length of a tower: patches + CLS, or the text length."""
    if tower == "img":
        return (config["img_size"] // config["patch_size"]) ** 2 + 1
    return int(config["max_text_len"])


def forward_flops(config: dict, tower: str, classes: int = 0) -> float:
    D = config["embed_dim"]
    F = int(round(D * config["mlp_ratio"]))
    N = tokens(config, tower)
    layer = 8.0 * N * D * D + 4.0 * N * D * F + 4.0 * N * N * D
    total = config["depth"] * layer + 2.0 * D * classes
    if tower == "img":
        P, C = config["patch_size"], config["in_chans"]
        total += 2.0 * (N - 1) * P * P * C * D
    return total


def towers(modality: str):
    return {"img": ("img",), "txt": ("txt",), "img+txt": ("img", "txt")}[
        modality]


def train_row_flops(config: dict, modality: str, classes: int = 0) -> float:
    """One training row (a sample, or an image-caption pair): 3 forwards."""
    return 3.0 * sum(forward_flops(config, t, classes)
                     for t in towers(modality))
