"""CLI entry point of the PyTorch port: the flags of the JAX package's
``main.py`` (reference main.py:17-53, 59-284) plus ``--device``.

    python -m fedcola_tpu_torch.main <reference flags> [--device cuda|cpu]

R rounds of ``server.update()``, ``server.evaluate`` every ``eval_every``
rounds and after the last, then the results JSON and the final ``.npz``
checkpoint and one reference-format ``<ds>.pt`` state dict per dataset
under ``<result_path>/<exp_name>/``.  ``--checkpoint_every N`` also saves
every N rounds to ``<result_path>/<exp_name>/ckpt``; a run that finds that
directory resumes from it.  ``--profile_every N`` traces the update of
every N-th round (``<log_path>/trace_round<r>/trace.json``).  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# The scripts/coco.sh FedCola line (scripts/coco.sh:28-29) at full
# mome_small width, cut to synthetic data, two clients per group
# (--Ks 4 4 4 --Cs 0.5), --E 1 --debug and two rounds; no pretrained
# weights or BERT vocab.  chip_smoke.py and profile_round.py run it.
MAIN_PATH_FLAGS = (
    "--exp_name", "FedCola", "--algorithm", "fedavg",
    "--shared_param", "attn", "--share_scope", "modality",
    "--colearn_param", "none", "--compensation", "--with_aux",
    "--aux_trained", "--seed", "1", "--multi-task",
    "--datasets", "CIFAR100", "AG_NEWS", "Coco", "Coco",
    "--modalities", "img", "txt", "img+txt", "img+txt",
    "--Ks", "4", "4", "4", "--test_size", "-1", "--split_type", "diri",
    "--cncntrtn", "0.5", "--model_name", "mome_small_patch16",
    "--resize", "224", "--imnorm", "--eval_type", "global",
    "--eval_every", "1", "--eval_metrics", "acc1", "--R", "2",
    "--Cs", "0.5", "--E", "1", "--B", "96", "--beta1", "0",
    "--optimizer", "AdamW", "--lr", "1e-4", "--lr_decay", "0.99",
    "--lr_decay_step", "1", "--criterion", "CrossEntropyLoss",
    "--equal_sampled", "--eval_batch_size", "512", "--dropout", "0.1",
    "--synthetic_data", "--debug", "--device", "cuda")

# The same line at mome_tiny width (D=192, 3 heads, depth 12): off the
# fused kernels' 128 grid, so attention runs through the flash kernels.
MOME_TINY_FLAGS = tuple(
    "mome_tiny_patch16" if prev == "--model_name" else flag
    for prev, flag in zip(("",) + MAIN_PATH_FLAGS, MAIN_PATH_FLAGS))

_FEDCOLA_SHARING = ("--shared_param", "attn", "--share_scope", "modality",
                    "--colearn_param", "none", "--compensation",
                    "--with_aux", "--aux_trained")


def _baseline(exp_name: str, algorithm: str, sharing, *extra) -> tuple:
    """``MAIN_PATH_FLAGS`` (width, depth, data, cuts) with another line's
    name, algorithm, sharing flags and extra flags."""
    flags = list(MAIN_PATH_FLAGS)
    at = flags.index(_FEDCOLA_SHARING[0])
    flags[at:at + len(_FEDCOLA_SHARING)] = sharing
    flags[flags.index("--exp_name") + 1] = exp_name
    flags[flags.index("--algorithm") + 1] = algorithm
    return tuple(flags) + extra


# The baselines scripts/coco.sh runs beside FedCola (:30, :32, :34) and
# the FedAdam line of scripts/evidence_fedopt.sh:51, cut as MAIN_PATH_FLAGS
# is; CreamFL's public set is synthetic (seed 999) like the client data.
_NO_SHARING = ("--shared_param", "none", "--share_scope", "dataset",
               "--colearn_param", "none")
FEDIOT_FLAGS = _baseline(
    "FedIoT", "fediot", ("--shared_param", "blocks", "--share_scope",
                         "modality_exact", "--colearn_param", "none"))
FEDPROX_FLAGS = _baseline("FedProx", "fedprox", _NO_SHARING, "--mu", "0.001")
CREAMFL_FLAGS = _baseline(
    "CreamFL", "creamfl", _NO_SHARING, "--interintra_weight", "1",
    "--kd_weight", "1e-7", "--num_pub_samples", "500",
    "--no_mm_contrastive", "--pub_batch_size", "128")
FEDADAM_FLAGS = _baseline("FedAdam_coco", "fedadam", _FEDCOLA_SHARING,
                          "--server_lr", "0.1")


# The long-text line: scripts/evidence_medabstracts.sh (two MedicalAbstracts
# text populations, fedavg, mome_small, B=96, --eval_metrics acc1 f1) with
# whole abstracts, --seq_len 512 (the BERT vocabulary's position limit), on
# synthetic data, cut as MAIN_PATH_FLAGS is: --Ks 4 --C 0.5 --E 1 --debug
# --R 2 --eval_every 1, and --Cs 0.5 beside --C, since --equal_sampled
# samples each dataset's clients by --Cs: two clients a round.  Its text
# stacks run the attention kernels at N = 512, past the resident kernels'
# 256: the streamed variants.
MEDABS_LONG_FLAGS = (
    "--exp_name", "FedAVG_med", "--algorithm", "fedavg",
    "--shared_param", "none", "--share_scope", "dataset",
    "--colearn_param", "none", "--seed", "1", "--multi-task",
    "--datasets", "MedicalAbstracts", "MedicalAbstracts",
    "--modalities", "txt", "txt", "--Ks", "4", "--test_size", "-1",
    "--split_type", "diri", "--cncntrtn", "0.5",
    "--model_name", "mome_small_patch16", "--seq_len", "512",
    "--eval_type", "global", "--eval_every", "1",
    "--eval_metrics", "acc1", "f1", "--R", "2", "--C", "0.5",
    "--Cs", "0.5", "--E", "1",
    "--B", "96", "--beta1", "0", "--optimizer", "AdamW", "--lr", "1e-4",
    "--lr_decay", "0.99", "--lr_decay_step", "1",
    "--criterion", "CrossEntropyLoss", "--equal_sampled",
    "--eval_batch_size", "512", "--synthetic_data", "--debug",
    "--device", "cuda")


def fixture_flags(coco: str, cifar: str, agnews: str) -> tuple:
    """The scripts/coco.sh FedCola line with its own data flags (``COMMON``,
    scripts/coco.sh:13-21: ``--pretrained --use_bert_tokenizer`` and
    path-backed ``--data_paths``) on the fixture roots of
    ``data/fixtures.py``, cut as ``MAIN_PATH_FLAGS`` is.  ``--pretrained``
    reads the checkpoint named by ``FEDCOLA_PRETRAIN_<SRC>`` (see
    ``models/pretrained.py``)."""
    flags = [f for f in MAIN_PATH_FLAGS if f != "--synthetic_data"]
    return tuple(flags) + ("--pretrained", "--use_bert_tokenizer",
                           "--data_paths", cifar, agnews, coco, coco)


class JsonlWriter:
    """Per-round metrics as JSON lines under ``--result_path``."""

    def __init__(self, cfg):
        os.makedirs(cfg.result_path, exist_ok=True)
        self._f = open(os.path.join(cfg.result_path,
                                    f"{cfg.exp_name}_metrics.jsonl"), "a")

    def log(self, payload, step):
        from fedcola_tpu_torch.utils.logging import json_sanitize
        self._f.write(json.dumps({"round": step, **{
            k: json_sanitize(float(v)) for k, v in payload.items()}}) + "\n")
        self._f.flush()

    def finish(self):
        self._f.close()


def main(argv=None):
    """Run the configured rounds; returns the server (its ``results`` hold
    every round's metrics)."""
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.data.loaders import load_federated_data
    from fedcola_tpu_torch.federation.server import (create_server,
                                                     resolve_device)
    from fedcola_tpu_torch.utils.logging import set_logger
    from fedcola_tpu_torch.utils.profiling import round_trace
    from fedcola_tpu_torch.utils.seeding import set_seed

    cfg = parse_args(argv)
    resolve_device(cfg)
    if cfg.wandb:
        raise NotImplementedError("--wandb is not ported; metrics go to "
                                  "<result_path>/<exp_name>_metrics.jsonl")
    os.makedirs(cfg.log_path, exist_ok=True)
    logger = set_logger(os.path.join(
        cfg.log_path, f"{cfg.exp_name}_{time.strftime('%y%m%d_%H%M%S')}.log"))
    logger.info("fedcola_tpu_torch starting: %s",
                " ".join(sys.argv[1:] if argv is None else argv))
    set_seed(cfg.seed)

    data = load_federated_data(cfg, np.random.RandomState(cfg.seed))
    server = create_server(cfg, data, JsonlWriter(cfg))
    ckpt_dir = os.path.join(cfg.result_path, cfg.exp_name, "ckpt")
    if os.path.isdir(ckpt_dir):
        server.load_checkpoint(ckpt_dir)
        logger.info("resumed from checkpoint at round %d", server.round)
    for r in range(server.round + 1, cfg.R + 1):
        server.round = r
        with round_trace(cfg.profile_every > 0 and r % cfg.profile_every == 0,
                         cfg.log_path, r):
            server.update()
        if (cfg.eval_every > 0 and r % cfg.eval_every == 0) or r == cfg.R:
            server.evaluate([])
        if cfg.checkpoint_every and r % cfg.checkpoint_every == 0:
            server.save_checkpoint(ckpt_dir)
    server.finalize()
    return server


if __name__ == "__main__":
    main()
