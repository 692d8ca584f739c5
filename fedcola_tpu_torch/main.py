"""CLI entry point of the PyTorch port: the flags of the JAX package's
``main.py`` (reference main.py:17-53, 59-284) plus ``--device``.

    python -m fedcola_tpu_torch.main <reference flags> [--device cuda|cpu]

R rounds of ``server.update()``, ``server.evaluate`` every ``eval_every``
rounds and after the last, then the results JSON and the final ``.npz``
checkpoint and one reference-format ``<ds>.pt`` state dict per dataset
under ``<result_path>/<exp_name>/``; ``--wandb`` logs the metrics to wandb
too when it is installed.  ``--checkpoint_every N`` also saves
every N rounds to ``<result_path>/<exp_name>/ckpt``; a run that finds that
directory resumes from it.  ``--profile_every N`` traces every N-th round,
its update and its evaluation (``<log_path>/trace_round<r>/trace.json``:
the kernels, and every span of the round as an ``fc_<name>`` range).
Runs on the card unless ``--device cpu`` is given.

``--mesh_shape`` / ``--mesh_axes`` (``parallel/mesh.py``) start one rank
per mesh device on this host and return when all have ended; with
``--dist_coordinator host:port --dist_num_processes P --dist_process_id i``
each of P processes runs the ranks of its own devices.  On one card or the
CPU, ``FEDCOLA_VIRTUAL_DEVICES=k`` presents k devices:

    FEDCOLA_VIRTUAL_DEVICES=4 python -m fedcola_tpu_torch.main --device cpu \\
        --mesh_shape 2 2 --mesh_axes clients data <flags>

``--mesh_axes clients model`` (or a third axis) adds Megatron tensor
parallelism inside each client's group update.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

# The scripts/coco.sh FedCola line at its own population and length
# (scripts/coco.sh:13-22, :26): 12 + 12 + 8 clients, --Cs 0.25, whole
# shards for --E 5 epochs at B=96, 30 rounds, no --debug.  Left out:
# --pretrained (no ViT checkpoint ships with the repo) and --data_paths,
# which ``population_flags`` adds.
POPULATION_FLAGS = (
    "--exp_name", "FedCola", "--algorithm", "fedavg",
    "--shared_param", "attn", "--share_scope", "modality",
    "--colearn_param", "none", "--compensation", "--with_aux",
    "--aux_trained", "--seed", "1", "--multi-task",
    "--datasets", "CIFAR100", "AG_NEWS", "Coco", "Coco",
    "--modalities", "img", "txt", "img+txt", "img+txt",
    "--Ks", "12", "12", "8", "--test_size", "-1", "--split_type", "diri",
    "--cncntrtn", "0.5", "--model_name", "mome_small_patch16",
    "--resize", "224", "--imnorm", "--eval_type", "global",
    "--eval_every", "1", "--eval_metrics", "acc1", "--R", "30",
    "--Cs", "0.25", "--E", "5", "--B", "96", "--beta1", "0",
    "--optimizer", "AdamW", "--lr", "1e-4", "--lr_decay", "0.99",
    "--lr_decay_step", "1", "--criterion", "CrossEntropyLoss",
    "--use_bert_tokenizer", "--equal_sampled", "--eval_batch_size", "512",
    "--device", "cuda")


def cut(flags, changes: dict) -> tuple:
    """``flags`` with each flag of ``changes`` given the values there (a
    string, or a tuple of them; ``()`` for a switch): a flag not in
    ``flags`` is added at the end, and ``None`` takes the flag out with its
    values.  A flag's values are the tokens up to the next ``--`` one."""
    flags = list(flags)
    for flag, values in changes.items():
        values = [values] if isinstance(values, str) else list(values or ())
        new = [] if changes[flag] is None else [flag, *values]
        if flag not in flags:
            flags += new
            continue
        at = flags.index(flag)
        end = at + 1
        while end < len(flags) and not flags[end].startswith("--"):
            end += 1
        flags[at:end] = new
    return tuple(flags)


# The scripts/coco.sh FedCola line (scripts/coco.sh:28-29) at full
# mome_small width, cut to synthetic data, two clients per group
# (--Ks 4 4 4 --Cs 0.5), --E 1 --debug and two rounds; no pretrained
# weights or BERT vocab.  chip_smoke.py runs it; ``--profile_every N``
# traces its rounds (``python3 -m portbench.run --workload
# coco-pop.mome_small --trace 1`` traces the line at its population).
MAIN_PATH_FLAGS = cut(POPULATION_FLAGS, {
    "--Ks": ("4", "4", "4"), "--R": "2", "--Cs": "0.5", "--E": "1",
    "--use_bert_tokenizer": None, "--dropout": "0.1",
    "--synthetic_data": (), "--debug": ()})

# The same line at mome_tiny width (D=192, 3 heads, depth 12): off the
# fused kernels' 128 grid, so attention runs through the flash kernels.
MOME_TINY_FLAGS = cut(MAIN_PATH_FLAGS, {"--model_name": "mome_tiny_patch16"})

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
    return cut(MAIN_PATH_FLAGS, {
        "--synthetic_data": None, "--pretrained": (),
        "--use_bert_tokenizer": (),
        "--data_paths": (cifar, agnews, coco, coco)})


def population_flags(coco: str, cifar: str, agnews: str) -> tuple:
    """``POPULATION_FLAGS`` on the dataset roots given.  A root without the
    dataset's files loads its synthetic stand-in (2000 train, 500 test
    rows; ``data/loaders.py``), as the img and txt groups of the JAX
    package's 100-round run at this population did
    (docs/evidence/fedcola_100round_pathbacked_v5e.json: Coco on
    ``coco_fixture(root, 1000, 250, 224)``)."""
    return POPULATION_FLAGS + ("--data_paths", cifar, agnews, coco, coco)


# The scripts/flickr.sh FedCola line (scripts/flickr.sh:13-26, :29): the
# coco.sh populations with Flickr30k as the img+txt dataset, --C 0.25,
# B=112.  The last --datasets entry (Coco) only names the server's eval
# model (config.client_datasets drops it).  Left out: --pretrained and
# --data_paths, which ``flickr_flags`` adds.
FLICKR_FLAGS = cut(POPULATION_FLAGS, {
    "--datasets": ("CIFAR100", "AG_NEWS", "Flickr30k", "Coco"),
    "--Cs": None, "--C": "0.25", "--B": "112"})


def flickr_flags(flickr: str, coco: str, cifar: str, agnews: str) -> tuple:
    """``FLICKR_FLAGS`` on the dataset roots given (flickr.sh's
    ``--data_paths``)."""
    return FLICKR_FLAGS + ("--data_paths", cifar, agnews, flickr, coco)


class WandbWriter:
    """Per-round metrics as JSON lines under ``--result_path``, and with
    ``--wandb`` to wandb as well (root ``main.py`` ``WandbWriter``,
    reference main.py:305): when wandb cannot be imported or started, the
    JSON lines alone."""

    def __init__(self, cfg):
        self._wandb = None
        if cfg.wandb:
            try:
                import wandb
                wandb.init(project="fedcola_tpu", name=cfg.exp_name,
                           config=None)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 — the JSONL still records
                logging.getLogger("fedcola_tpu_torch").warning(
                    "--wandb: wandb unavailable (%s: %s); metrics go to the "
                    "JSONL only", type(e).__name__, e)
        os.makedirs(cfg.result_path, exist_ok=True)
        self._f = open(os.path.join(cfg.result_path,
                                    f"{cfg.exp_name}_metrics.jsonl"), "a")

    def log(self, payload, step):
        from fedcola_tpu_torch.utils.logging import json_sanitize
        self._f.write(json.dumps({"round": step, **{
            k: json_sanitize(float(v)) for k, v in payload.items()}}) + "\n")
        self._f.flush()
        if self._wandb:
            self._wandb.log(payload, step=step)

    def finish(self):
        self._f.close()
        if self._wandb:
            self._wandb.finish()


def main(argv=None):
    """Run the configured rounds.  Returns the server (its ``results`` hold
    every round's metrics) of a one-device run or of a process that is one
    mesh rank; a process that starts several ranks returns None when they
    have all ended (rank 0 writes the results, checkpoints and exports)."""
    import torch
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.federation.server import resolve_device
    from fedcola_tpu_torch.parallel.mesh import plan_launch

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_args(argv)
    launch = plan_launch(cfg, resolve_device(cfg).type)
    if launch is None:
        return _run(cfg, argv)
    if launch.local == 1:
        return _rank(0, argv, launch)
    # one process per local mesh device; CUDA needs spawn, not fork.  A
    # rank that fails stops the others and raises here.
    torch.multiprocessing.start_processes(
        _rank, args=(argv, launch), nprocs=launch.local,
        start_method="spawn")
    return None


def _rank(local_index: int, argv, launch):
    """One mesh rank: join the process group, run, leave it."""
    import torch
    from fedcola_tpu_torch.config import parse_args
    cfg = parse_args(argv)
    if launch.device_type == "cpu":
        # the process's threads (the host's cores, or OMP_NUM_THREADS),
        # shared among its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // launch.local))
    plan = launch.join(local_index)
    try:
        return _run(cfg, argv, plan)
    finally:
        plan.close()


def _run(cfg, argv, plan=None):
    from fedcola_tpu_torch.data.loaders import load_federated_data
    from fedcola_tpu_torch.federation.server import create_server
    from fedcola_tpu_torch.utils.logging import set_logger
    from fedcola_tpu_torch.utils.profiling import round_trace
    from fedcola_tpu_torch.utils.seeding import set_seed

    rank = plan.rank if plan is not None else 0
    multi = plan is not None and plan.is_multiprocess
    os.makedirs(cfg.log_path, exist_ok=True)
    logger = set_logger(os.path.join(
        cfg.log_path, f"{cfg.exp_name}_{time.strftime('%y%m%d_%H%M%S')}"
        f"{f'_rank{rank}' if rank else ''}.log"),
        tag=f"[rank {rank}] " if multi else "")
    logger.info("fedcola_tpu_torch starting: %s", " ".join(argv))
    if plan is not None:
        logger.info("[MESH] %s", plan.describe())
        if plan.model_axis > 1:
            logger.info(
                "[MESH] model axis %d: Megatron tensor parallelism in the "
                "group updates; a sharded attention runs the rank's heads "
                "through the flash kernels (rows 11 / 12), a sharded MLP "
                "its hidden columns through the no-residual item kernels "
                "(rows 3e / 6; the plain MLP off the 128 grid), one "
                "all-reduce a sublayer; evaluation with whole weights",
                plan.model_axis)
        if cfg.algorithm == "creamfl":
            B, d = cfg.pub_batch_size, plan.data_axis
            where = [f"{B // d} of {B} public rows a rank"
                     if plan.splits_batch(B) else
                     f"the whole public batch of {B} on every data rank"
                     ] if d > 1 else []
            if plan.model_axis > 1:
                where.append("on the rank's shards of the model axis")
            logger.info(
                "[MESH] CreamFL: the public steps and the feature "
                "extraction run each group's client blocks%s; the public "
                "features are all-gathered; the public logits, the "
                "aggregation and the distillation run replicated on every "
                "rank", "".join(", " + w for w in where))
    set_seed(cfg.seed)

    data = load_federated_data(cfg, np.random.RandomState(cfg.seed))
    server = create_server(cfg, data, WandbWriter(cfg) if rank == 0 else None,
                           plan)
    ckpt_dir = os.path.join(cfg.result_path, cfg.exp_name, "ckpt")
    if os.path.isdir(ckpt_dir):
        server.load_checkpoint(ckpt_dir)
        logger.info("resumed from checkpoint at round %d", server.round)
    if plan is not None:
        plan.check_same_round(server.round, ckpt_dir)
    for r in range(server.round + 1, cfg.R + 1):
        server.round = r
        with round_trace(cfg.profile_every > 0 and r % cfg.profile_every == 0,
                         cfg.log_path, r):
            server.update()
            if (cfg.eval_every > 0 and r % cfg.eval_every == 0) \
                    or r == cfg.R:
                server.evaluate([])
        if cfg.checkpoint_every and r % cfg.checkpoint_every == 0 \
                and rank == 0:
            server.save_checkpoint(ckpt_dir)
    if multi:
        stats = plan.gather_object(_rank_stats(server))
        server.mesh_stats = {"mesh": plan.mesh_dict,
                             "backend": plan.backend, "ranks": stats}
    if rank == 0:
        server.finalize()
    return server


def _rank_stats(server) -> dict:
    """What one rank of a mesh run did: its device, staged bytes, peak
    device memory, round and eval seconds, and kernel launches."""
    import torch
    from fedcola_tpu_torch.ops import kernels
    cuda = server.device.type == "cuda"
    rounds = sorted(r for r in server.results if isinstance(r, int))
    return {
        "rank": server.plan.rank,
        "device": f"cuda:{torch.cuda.current_device()}" if cuda else "cpu",
        "staged_bytes": server._resident_bytes,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()
        if cuda else None,
        "round_seconds": [server.results[r].get("round_seconds")
                          for r in rounds],
        "eval_seconds": [server.results[r].get("eval_seconds")
                         for r in rounds],
        "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
    }


if __name__ == "__main__":
    main()
