"""The MAT of FedCola (reference mome.py): the architecture of every
configuration that names none.  Its plain reference is
``portbench/reference/mat.py``; its kernel routes are the port's fused
attention and MLP sublayers (``fused``) and its flash attention
(``flash``).

Model FLOPs: the matrix products and attention products of one tower's
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

from functools import partial

from portbench.arch import Route
from portbench.counts.kernels import attn_bwd, attn_fwd, flash_bwd, \
    flash_fwd, mlp_bwd, mlp_fwd
from portbench.counts.peaks import least_seconds
from portbench.reference.mat import AUX_KINDS, contrastive, cross_entropy, \
    fold_aux, forward, layout, model_spec, \
    preprocess as _preprocess  # noqa: F401

# ------------------------------------------------------------ model side --


def preprocess(spec, x):
    return _preprocess(x, spec.img_size)


def data_shapes(config: dict) -> dict:
    return {"pixels": int(config["img_size"]),
            "vocab": int(config["vocab_size"]),
            "text_len": int(config["max_text_len"])}


# ------------------------------------------------------- federation side --

ATTN_LEAVES = ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias")


def shared_leaf(path) -> bool:
    """The attention leaves of a block stack."""
    return path[0] == "blk" and path[-1] in ATTN_LEAVES


def exchanged(path) -> bool:
    return path[0] == "aux"


def has_aux(spec) -> bool:
    return spec.has_aux


def exchange_aux(spec, tree: dict, src_spec, src_tree: dict) -> None:
    """A uni-modal model's aux kernels take the other modality's new
    main kernels."""
    src = src_tree["blk"][str(src_spec.main_slot)]
    for k in AUX_KINDS:
        tree["aux"][f"{k}_aux"] = src[f"{k}_kernel"]


def parts(path: tuple, t):
    """The parameters a leaf holds, as the reference model names them: a
    block stack's leaf (``blk``, ``aux``: a leading ``depth`` axis) layer
    by layer, and a qkv kernel or bias as its q, k and v thirds."""
    if path[0] not in ("blk", "aux") or t.dim() == 1:
        yield path, t
        return
    for layer in range(t.shape[0]):
        x = t[layer]
        if path[-1].startswith("qkv"):
            for name, third in zip("qkv", x.chunk(3, dim=-1)):
                yield path + (layer, name), third
        else:
            yield path + (layer,), x


def copy_of(tree: dict, path: tuple):
    """An aux kernel starts as the main stack's kernel of its kind (the
    published init of the aux reparameterisation); an aux model is
    uni-modal: one block stack."""
    (main,) = tree["blk"].values()
    return main[path[-1].replace("_aux", "_kernel")]


# ---------------------------------------------------------------- counts --

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


def layers(config: dict, tower: str):
    """Every layer of a tower is one kind, the configuration's."""
    return [(config["depth"], config)]


def layer_least(route: str, rows: int, n: int, N: int, config: dict,
                train: bool) -> float:
    """The least seconds of one layer's calls of ``route`` (``fused``:
    rows 1-4, or 1e and 3e in evaluation; ``flash``: rows 11 and 12, or
    11e) over ``rows`` valid sequences of ``n`` stacked clients."""
    D, H = config["embed_dim"], config["num_heads"]
    F = int(round(D * config["mlp_ratio"]))
    if route == "fused":
        calls = [attn_fwd(rows, n, N, D, H, train),
                 mlp_fwd(rows, n, N, D, F, train)]
        if train:
            calls += [attn_bwd(rows, n, N, D, H), mlp_bwd(rows, n, N, D, F)]
    elif route == "flash":
        calls = [flash_fwd(rows * H, N, D // H)]
        if train:
            calls.append(flash_bwd(rows * H, N, D // H))
    else:
        raise ValueError(route)
    return sum(least_seconds(o, b) for o, b in calls)


def routes():
    return {"fused": Route(("fc_attn_fwd", "fc_attn_bwd", "fc_mlp_fwd",
                            "fc_mlp_bwd", "fc_attn_bwd_recompute",
                            "fc_mlp_bwd_nores"),
                           partial(layer_least, "fused")),
            "flash": Route(("fc_flash_fwd", "fc_flash_bwd"),
                           partial(layer_least, "flash"))}


# --------------------------------------------------------------- program --

def program_flags(config: dict):
    """The configuration's model, text length, DropPath rate and
    precision on the program's command line."""
    return ["--model_name", config["model_name"],
            "--seq_len", str(config["max_text_len"]),
            "--dropout", str(config["drop_path_rate"]),
            "--vocab_size", str(config["vocab_size"]),
            "--compute_dtype", config["compute_dtype"]]


def program_check(config: dict) -> dict:
    """The program's ``MATConfig`` at the configuration's widths."""
    c = config
    return {"embed_dim": c["embed_dim"], "depth": c["depth"],
            "num_heads": c["num_heads"], "img_size": c["img_size"],
            "patch_size": c["patch_size"], "in_chans": c["in_chans"],
            "max_text_len": c["max_text_len"],
            "drop_path_rate": c["drop_path_rate"],
            "compute_dtype": c["compute_dtype"],
            "hidden_dim": int(round(c["embed_dim"] * c["mlp_ratio"])),
            "vocab_size": c["vocab_size"]}
