"""Experiment configuration: CLI-compatible with the reference's ``main.py``.

The reference drives everything through an argparse namespace with ~100 flags
(reference ``main.py:59-284``) plus a validation pass (``src/utils.py:184-281``).
We keep the same flag names and defaults so the reference's ``scripts/coco.sh``
and ``scripts/flickr.sh`` run unmodified, but store them in a typed dataclass.

Framework additions are grouped at the bottom (device, kernel toggle,
client-batch chunking); they all have safe defaults.  This is the PyTorch
port's copy of the JAX package's parser with one flag added, ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import List, Optional

logger = logging.getLogger(__name__)


# Dataset-derived constants (reference src/server/fedavgserver.py:33-92).
DATASET_2_TASK = {
    "MedMNIST": "cls",
    "CIFAR100": "cls",
    "AG_NEWS": "cls",
    "MTSamples": "cls",
    "MedicalAbstracts": "cls",
    "Flickr30k": "rtv",
    "Coco": "rtv",
}

DATASET_2_MODALITY = {
    "MedMNIST": "img",
    "CIFAR100": "img",
    "AG_NEWS": "txt",
    "MTSamples": "txt",
    "MedicalAbstracts": "txt",
    "Flickr30k": "img+txt",
    "Coco": "img+txt",
}

NUM_CLASS = {
    "CIFAR100": 100,
    "AG_NEWS": 4,
    "MedMNIST": 11,
    "MTSamples": 40,
    "MedicalAbstracts": 5,
    "Flickr30k": None,
    "Coco": None,
}

# Per-dataset WordPiece vocab sizes (reference fedavgserver.py:89-92).
VOCAB_SIZES = {
    "Flickr30k": 7732,
    "MedicalAbstracts": 20264,
}

# Task -> local criterion (reference fedavgserver.py:76-80).  The reference
# instantiates the multimodal ContrastiveLossWithTemperature *per batch*
# (fedavgclient.py:95), so its learnable temperature is re-initialised every
# step and is effectively the fixed CLIP init 1/0.07.
TASK_2_CRITERION = {
    "cls": "CrossEntropyLoss",
    "img+txt": "ContrastiveLoss",
    "rtv": "ContrastiveLoss",
}


@dataclass
class ExperimentConfig:
    """All experiment knobs.  Field names == reference flag names."""

    # -- bookkeeping (main.py:64-77)
    goal: Optional[str] = None
    exp_name: str = "exp"
    seed: int = 5959
    server_device: str = "tpu"
    data_path: str = "./data"
    modality: str = "img"
    log_path: str = "./log"
    result_path: str = "./result"
    use_tb: bool = False
    tb_port: int = 6006
    tb_host: str = "0.0.0.0"
    distributed: bool = False
    mm_distributed: bool = False
    mp: bool = False

    # -- dataset (main.py:85-112)
    dataset: str = "MedicalAbstracts"
    test_size: float = 0.2
    rawsmpl: float = 1.0
    resize: Optional[int] = None
    crop: Optional[int] = None
    imnorm: bool = False
    randrot: Optional[int] = None
    randhf: Optional[float] = None
    randvf: Optional[float] = None
    randjit: Optional[float] = None
    split_type: str = "iid"
    mincls: int = 2
    cncntrtn: float = 0.1

    # -- multi-task FL (main.py:117-146)
    multi_task: bool = False
    debug: bool = False
    pretrained: bool = False
    datasets: List[str] = field(default_factory=list)
    data_paths: List[str] = field(default_factory=list)
    modalities: List[str] = field(default_factory=list)
    Ks: List[int] = field(default_factory=lambda: [1])
    Cs: List[float] = field(default_factory=lambda: [0.25])
    shared_param: str = "none"        # none | attn | blocks | mlp
    share_scope: str = "dataset"      # dataset | modality | modality_exact | all
    colearn_param: str = "none"       # none | attn | blocks
    compensation: bool = False
    reduce_samples: int = 50000
    reduce_test_samples: int = -1
    reduce_samples_seg_scale: float = -1
    reduce_samples_cls_scale: float = -1
    num_thread: int = 1
    num_transformer_layers: int = 12
    equal_sampled: bool = False
    warmup_modality: str = "none"
    warmup_rounds: int = 5
    freeze_modality: str = "none"
    freeze_rounds: int = 5
    out_modality_scales: List[float] = field(default_factory=lambda: [1.0])
    fedavg_eval: bool = False

    # -- FedCola aux (main.py:174-177)
    with_aux: bool = False
    aux_trained: bool = False
    aux_attn_only: bool = False
    aux_mlp_only: bool = False

    flickr_train_all: bool = False
    v_epoch: int = 5
    supervised: bool = False
    train_as_val: bool = False

    # -- CreamFL (main.py:194-206)
    pub_data_dir: str = "data/coco/all_images/"
    pub_anno_path: str = "data/coco/annotations/captions_val2014.json"
    num_pub_samples: int = 500
    pub_batch_size: int = 64
    p_lr: float = 1e-4
    interintra_weight: float = 0.5
    kd_weight: float = 0.3
    no_mm_contrastive: bool = False
    mm_scale: float = 100.0  # parsed but unused in the reference (main.py:211)

    # -- model (main.py:219-233)
    model_name: str = "mome_small_patch16"
    hidden_size: int = 64
    dropout: float = 0.1
    use_model_tokenizer: bool = False
    use_bert_tokenizer: bool = False
    vocab_size: int = 30522
    use_pt_model: bool = False
    seq_len: int = 40
    num_layers: int = 2
    num_embeddings: int = 1000
    embedding_size: int = 512
    init_type: str = "kaiming"
    init_gain: float = 1.0

    # -- algorithm / eval (main.py:239-253)
    algorithm: str = "fedavg"         # fedavg|fedprox|fediot|creamfl|fedsgd|fedavgm|fedadam|fedyogi|fedadagrad
    eval_type: str = "both"           # local | global | both
    eval_fraction: float = 1.0
    eval_every: int = 1
    eval_metrics: List[str] = field(default_factory=lambda: ["acc1"])

    # -- FL hyperparameters (main.py:259-278)
    K: int = 100
    R: int = 1000
    C: float = 0.1
    E: int = 5
    B: int = 10
    eval_batch_size: int = 64
    beta1: float = 0.0                # server momentum factor
    no_shuffle: bool = False
    optimizer: str = "SGD"            # SGD | Adam | AdamW (torch.optim names)
    max_grad_norm: float = 0.0
    weight_decay: float = 0.0
    momentum: float = 0.0
    nesterov: bool = False
    lr: float = 0.01
    lr_decay: float = 1.0
    lr_decay_step: int = 20
    criterion: str = "CrossEntropyLoss"
    mu: float = 0.01                  # fedprox proximal coefficient

    # -- framework knobs (new; not in the reference)
    # cuda runs the hand-written kernels; cpu runs their plain versions
    device: str = "cuda"
    # accepted for flag compatibility with the JAX package; the port has no
    # mesh or multi-host mode yet and refuses a non-default value
    mesh_shape: Optional[List[int]] = None
    mesh_axes: List[str] = field(default_factory=lambda: ["clients"])
    dist_coordinator: Optional[str] = None
    dist_num_processes: Optional[int] = None
    dist_process_id: Optional[int] = None
    use_pallas: bool = True                  # fused kernels (--no_pallas: off)
    train_chunk_steps: int = 8               # steps scanned per device program
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    checkpoint_every: int = 0                # 0 = only final (reference parity)
    profile_every: int = 0                   # torch.profiler trace every N rounds
    detect_anomaly: bool = False             # non-finite loss raises at once
    moment_dtype: str = "float32"            # Adam moment storage (bfloat16 halves opt-state HBM)
    # FedOpt-family server step size.  None = this round's --lr (the
    # reference's dormant classes share the one lr kwarg), but the FedOpt
    # paper (Reddi et al. 2021) tunes the server lr separately (~0.1-1);
    # at the canonical client lr 1e-4 the adaptive step caps per-element
    # movement at ~1e-4/round, far slower than plain averaging
    server_lr: Optional[float] = None
    # FedOpt adaptivity floor tau (framework extension like --server_lr:
    # the upstream classes read kwargs.get('tau') no caller supplies and
    # the upstream CLI can't reach them — src/utils.py:206-214 demands
    # beta1>0 then dereferences an undefined args.beta2)
    server_tau: float = 1e-3
    synthetic_data: bool = False             # synthetic data plane (benchmarks)
    wandb: bool = False
    num_classes: Optional[int] = None        # filled by the data plane

    # ---------------------------------------------------------------- helpers
    def task_of(self, dataset: str) -> str:
        return DATASET_2_TASK[dataset]

    def modality_of(self, dataset: str) -> str:
        return DATASET_2_MODALITY[dataset]

    def vocab_size_of(self, dataset: str) -> int:
        return VOCAB_SIZES.get(dataset, 30522)

    @property
    def client_datasets(self) -> List[str]:
        """Datasets holding clients (reference drops the last, server-eval,
        entry: fedavgserver.py:145)."""
        if not self.datasets:
            return [self.dataset]
        return self.datasets[:-1]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _add_reference_flags(p: argparse.ArgumentParser) -> None:
    """Register every reference flag with identical names/defaults
    (reference main.py:59-284)."""
    add = p.add_argument
    add("--goal", type=str, default=None)
    add("--exp_name", type=str, default="exp")
    add("--seed", type=int, default=5959)
    add("--server_device", type=str, default="tpu")
    add("--data_path", type=str, default="./data")
    add("--modality", type=str, default="img")
    add("--log_path", type=str, default="./log")
    add("--result_path", type=str, default="./result")
    add("--use_tb", action="store_true")
    add("--tb_port", type=int, default=6006)
    add("--tb_host", type=str, default="0.0.0.0")
    add("--distributed", action="store_true")
    add("--mm_distributed", action="store_true")
    add("--mp", action="store_true")
    add("--dataset", type=str, default="MedicalAbstracts")
    add("--test_size", type=float, default=0.2)
    add("--rawsmpl", type=float, default=1.0)
    add("--resize", type=int, default=None)
    add("--crop", type=int, default=None)
    add("--imnorm", action="store_true")
    add("--randrot", type=int, default=None)
    add("--randhf", type=float, default=None)
    add("--randvf", type=float, default=None)
    add("--randjit", type=float, default=None)
    add("--split_type", type=str, default="iid")
    add("--mincls", type=int, default=2)
    add("--cncntrtn", type=float, default=0.1)
    add("--multi-task", dest="multi_task", action="store_true")
    add("--debug", action="store_true")
    add("--pretrained", action="store_true")
    add("--datasets", type=str, nargs="+", default=[])
    add("--data_paths", type=str, nargs="+", default=[])
    add("--modalities", type=str, nargs="+", default=[])
    add("--Ks", type=int, nargs="+", default=[1])
    add("--Cs", type=float, nargs="+", default=[0.25])
    # None sentinels (resolved to none/dataset post-parse) so an explicitly
    # passed default is distinguishable from an omitted flag — the fediot
    # alias must not rewrite a deliberate `--shared_param none`
    add("--shared_param", type=str, default=None)
    add("--share_scope", type=str, default=None)
    add("--colearn_param", type=str, default="none")
    add("--compensation", action="store_true")
    add("--reduce_samples", type=int, default=50000)
    add("--reduce_test_samples", type=int, default=-1)
    add("--reduce_samples_seg_scale", type=float, default=-1)
    add("--reduce_samples_cls_scale", type=float, default=-1)
    add("--num_thread", type=int, default=1)
    add("--num_transformer_layers", type=int, default=12)
    add("--equal_sampled", action="store_true")
    add("--warmup_modality", type=str, default="none")
    add("--warmup_rounds", type=int, default=5)
    add("--freeze_modality", type=str, default="none")
    add("--freeze_rounds", type=int, default=5)
    # reference parses this with eval() (main.py:282-284); we parse safely
    add("--out_modality_scales", type=str, default="[1]")
    add("--fedavg_eval", action="store_true")
    add("--with_aux", action="store_true")
    add("--aux_trained", action="store_true")
    add("--aux_attn_only", action="store_true")
    add("--aux_mlp_only", action="store_true")
    add("--flickr_train_all", action="store_true")
    add("--v_epoch", type=int, default=5)
    add("--supervised", action="store_true")
    add("--train_as_val", action="store_true")
    add("--pub_data_dir", type=str, default="data/coco/all_images/")
    add("--pub_anno_path", type=str, default="data/coco/annotations/captions_val2014.json")
    add("--num_pub_samples", type=int, default=500)
    add("--pub_batch_size", type=int, default=64)
    add("--p_lr", type=float, default=1e-4)
    add("--interintra_weight", type=float, default=0.5)
    add("--kd_weight", type=float, default=0.3)
    add("--no_mm_contrastive", action="store_true")
    add("--mm_scale", type=float, default=100)
    add("--model_name", type=str, default="mome_small_patch16")
    add("--hidden_size", type=int, default=64)
    add("--dropout", type=float, default=0.1)
    add("--use_model_tokenizer", action="store_true")
    add("--use_bert_tokenizer", action="store_true")
    add("--vocab_size", type=int, default=30522)
    add("--use_pt_model", action="store_true")
    add("--seq_len", type=int, default=40)
    add("--num_layers", type=int, default=2)
    add("--num_embeddings", type=int, default=1000)
    add("--embedding_size", type=int, default=512)
    add("--init_type", type=str, default="kaiming")
    add("--init_gain", type=float, default=1.0)
    add("--algorithm", type=str, default="fedavg")
    add("--eval_type", type=str, default="both")
    add("--eval_fraction", type=float, default=1.0)
    add("--eval_every", type=int, default=1)
    add("--eval_metrics", type=str, nargs="+", default=["acc1"])
    add("--K", type=int, default=100)
    add("--R", type=int, default=1000)
    add("--C", type=float, default=0.1)
    add("--E", type=int, default=5)
    add("--B", type=int, default=10)
    add("--eval_batch_size", type=int, default=64)
    add("--beta1", type=float, default=0.0)
    add("--no_shuffle", action="store_true")
    add("--optimizer", type=str, default="SGD")
    add("--max_grad_norm", type=float, default=0.0)
    add("--weight_decay", type=float, default=0.0)
    add("--momentum", type=float, default=0.0)
    add("--nesterov", action="store_true")
    add("--lr", type=float, default=0.01)
    add("--lr_decay", type=float, default=1.0)
    add("--lr_decay_step", type=int, default=20)
    add("--criterion", type=str, default="CrossEntropyLoss")
    add("--mu", type=float, default=0.01)


def _add_framework_flags(p: argparse.ArgumentParser) -> None:
    add = p.add_argument
    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    add("--mesh_shape", type=int, nargs="+", default=None)
    add("--mesh_axes", type=str, nargs="+", default=["clients"])
    add("--dist_coordinator", type=str, default=None)
    add("--dist_num_processes", type=int, default=None)
    add("--dist_process_id", type=int, default=None)
    add("--no_pallas", dest="use_pallas", action="store_false")
    add("--train_chunk_steps", type=int, default=8)
    add("--param_dtype", type=str, default="float32")
    add("--compute_dtype", type=str, default="bfloat16")
    add("--checkpoint_every", type=int, default=0)
    add("--profile_every", type=int, default=0)
    add("--detect_anomaly", action="store_true")
    add("--server_lr", type=float, default=None)
    add("--server_tau", type=float, default=1e-3)
    add("--moment_dtype", type=str, default="float32",
        choices=["float32", "bfloat16"])
    add("--synthetic_data", action="store_true")
    add("--wandb", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="fedcola_tpu_torch: multi-modal federated learning "
                    "in PyTorch on CUDA",
        allow_abbrev=False,
    )
    _add_reference_flags(p)
    _add_framework_flags(p)
    return p


def parse_args(argv=None) -> ExperimentConfig:
    ns = build_parser().parse_args(argv)
    d = vars(ns)
    # out_modality_scales: reference uses eval() (main.py:282); parse via json
    raw = d.get("out_modality_scales", "[1]")
    if isinstance(raw, str):
        parsed = json.loads(raw)
        # the reference's eval() tolerates a bare scalar ('1'); match it
        if not isinstance(parsed, list):
            parsed = [parsed]
        d["out_modality_scales"] = [float(x) for x in parsed]
    # resolve the None sentinels, remembering which flags the user passed
    explicit = {k for k in ("shared_param", "share_scope")
                if d.get(k) is not None}
    if d.get("shared_param") is None:
        d["shared_param"] = "none"
    if d.get("share_scope") is None:
        d["share_scope"] = "dataset"
    cfg = ExperimentConfig(**{k: v for k, v in d.items()
                              if k in {f.name for f in dataclasses.fields(ExperimentConfig)}})
    return check_args(cfg, explicit_flags=explicit)


def check_args(cfg: ExperimentConfig,
               explicit_flags: Optional[set] = None) -> ExperimentConfig:
    """Validation + derived settings (reference src/utils.py:184-281 and
    main.py:282-284, fedavgserver.py:137-142).

    ``explicit_flags`` (from parse_args) names sharing flags the user passed
    on the CLI; directly-constructed configs leave it None, in which case
    default *values* are treated as unset (the pre-round-4 behavior).
    """
    if cfg.aux_attn_only and cfg.aux_mlp_only:
        raise ValueError("Both aux_attn_only and aux_mlp_only cannot be True "
                         "(reference mome.py:773-775).")
    if cfg.algorithm == "fedsgd":
        cfg.E = 1  # fedsgd implies a single local epoch (src/utils.py:236-239)
    if cfg.optimizer not in ("SGD", "Adam", "AdamW"):
        raise ValueError(f"Unsupported optimizer {cfg.optimizer!r}; "
                         "supported: SGD, Adam, AdamW")
    known_criteria = {"CrossEntropyLoss", "BCEWithLogitsLoss",
                      "PainlessBCEWithLogitsLoss", "Seq2SeqLoss",
                      "ContrastiveLoss", "MCSoftContrastiveLoss", "SegLoss"}
    dist = (cfg.dist_coordinator, cfg.dist_num_processes,
            cfg.dist_process_id)
    if any(v is not None for v in dist) and not all(v is not None
                                                   for v in dist):
        raise ValueError(
            "--dist_coordinator/--dist_num_processes/--dist_process_id "
            "must be set together (multi-host DCN initialization)")
    if cfg.use_model_tokenizer:
        # the reference gates this flag on legacy text-classification
        # models and asserts out otherwise (data.py:173-181:
        # ``assert args.model_name in ['DistilBert','SqueezeBert',
        # 'MobileBert']``) — every mome_* MAT model fails that assert, so
        # the flag is unusable in the multimodal path upstream too; reject
        # loudly instead of silently ignoring it
        raise ValueError(
            "--use_model_tokenizer is not supported for MAT models: the "
            "reference restricts it to DistilBert/SqueezeBert/MobileBert "
            "(src/loaders/data.py:173-181) and would assert out for "
            f"{cfg.model_name!r}; use --use_bert_tokenizer with a "
            "per-dataset vocab.txt instead")
    if cfg.criterion not in known_criteria:
        raise ValueError(f"Unsupported criterion {cfg.criterion!r}; "
                         f"supported: {sorted(known_criteria)} "
                         "(reference validates against torch.nn names, "
                         "src/utils.py:212-230)")
    # FedIoT is DEFINED by its sharing rule (reference README.md:70:
    # shared_param=blocks, share_scope=modality_exact on fedavg machinery;
    # the upstream fediot modules are missing, so the algorithm name alone
    # carries no behavior).  The canonical scripts pass the two flags
    # explicitly; when a bare `--algorithm fediot` leaves both unset, apply
    # the documented alias rather than silently running plain-FedAvg
    # sharing under a FedIoT label.  Runs BEFORE the compensation check so
    # `--algorithm fediot --compensation` validates against the effective
    # share_scope (modality_exact), which compensation supports.
    if cfg.algorithm == "fediot":
        unset = ((explicit_flags is not None
                  and not ({"shared_param", "share_scope"} & explicit_flags))
                 or (explicit_flags is None and cfg.shared_param == "none"
                     and cfg.share_scope == "dataset"))
        if unset:
            cfg.shared_param, cfg.share_scope = "blocks", "modality_exact"
            logger.info("[CONFIG] fediot: applied the documented sharing "
                        "alias shared_param=blocks share_scope="
                        "modality_exact (reference README.md:70)")
        elif cfg.shared_param == "none" and cfg.share_scope == "dataset":
            logger.warning(
                "[CONFIG] fediot with explicit --shared_param none "
                "--share_scope dataset: honoring the explicit flags — this "
                "runs plain-FedAvg sharing under the fediot label (the "
                "documented fediot rule is shared_param=blocks "
                "share_scope=modality_exact, reference README.md:70)")
    if (cfg.compensation and cfg.share_scope in ("dataset", "task")
            and cfg.algorithm != "creamfl"):
        # the reference's compensation branch only normalises for
        # all/modality/modality_exact (fedavgserver.py:640-651); with any
        # other share_scope every parameter name is left unassigned and
        # the accumulate loop skips it (fedavgserver.py:657-668) — the
        # global model silently never changes.  Reject the dead
        # combination loudly instead of training nothing.  (CreamFL has
        # its own compensation normaliser that handles every scope,
        # creamflserver.py:276-279, so it is exempt.)
        raise ValueError(
            f"--compensation with --share_scope {cfg.share_scope} "
            "aggregates NOTHING in the reference (its compensation "
            "branch only handles all/modality/modality_exact and skips "
            "unassigned params) — use --share_scope modality/"
            "modality_exact/all, or drop --compensation")
    if cfg.criterion == "Seq2SeqLoss":
        raise ValueError(
            "Seq2SeqLoss needs [B, L, V] sequence logits, which no MAT "
            "head emits — upstream its is_seq2seq flag only fires for "
            "dead dataset branches (src/utils.py:249-252) and a MAT run "
            "would crash in the loss; the op itself lives on in "
            "ops.losses.seq2seq_ce")
    # binary-classification rewrite (src/utils.py:259-261): the reference
    # runs check_args AFTER data loading, when args.num_classes holds the
    # LAST dataset's class count — a binary final dataset flips the global
    # criterion to BCEWithLogitsLoss (heads still come from the NUM_CLASS
    # table, fedavgserver.py:151-155; PainlessBCE absorbs the shapes).
    # INTENTIONAL divergence: the reference rewrites unconditionally, so a
    # user-supplied non-CE criterion (e.g. Seq2SeqLoss) on a binary final
    # dataset is silently discarded; we only rewrite the CE default and
    # honor an explicit criterion choice
    if (cfg.datasets and NUM_CLASS.get(cfg.datasets[-1]) == 2
            and cfg.criterion == "CrossEntropyLoss"):
        cfg.criterion = "BCEWithLogitsLoss"
    # a dataset name may appear at most once among the CLIENT entries:
    # clients of one name share a single TaskDataset (the resident data
    # plane stages that one object) and the servers key groups, global
    # models, and aggregation by name — duplicated entries would merge
    # into one group anyway (upstream too: global_models/raw_tests are
    # name-keyed dicts, fedavgserver.py:145-155), so ask for the
    # equivalent single entry instead of failing deep in round 1
    seen: set = set()
    for d in cfg.client_datasets:
        if d in seen:
            raise ValueError(
                f"dataset {d!r} appears more than once among the client "
                "entries of --datasets; use a single entry with the "
                "summed K (same population: the server keys models and "
                "aggregation by dataset name)")
        seen.add(d)
    if cfg.seq_len < 2:
        raise ValueError(f"--seq_len {cfg.seq_len} is too short: every "
                         "encoding carries [CLS] and [SEP]")
    # broadcast per-dataset sampling fractions (fedavgserver.py:137-142);
    # a partial list (neither 1 nor one-per-client-dataset) would
    # silently truncate in the server's zip and KeyError in round 1
    n_client_datasets = max(len(cfg.client_datasets), 1)

    def _broadcast(name, vals):
        if len(vals) == 1:
            return list(vals) * n_client_datasets
        if len(vals) != n_client_datasets:
            raise ValueError(
                f"--{name} has {len(vals)} entries but there are "
                f"{n_client_datasets} client datasets; pass one value or "
                "one per client dataset")
        return list(vals)

    cfg.Cs = _broadcast("Cs", cfg.Cs)
    # broadcast out_modality_scales (main.py:282-284 broadcasts to
    # len(modalities)-1; we broadcast to the number of client datasets, which
    # is what _aggregate indexes with: fedavgserver.py:816)
    cfg.out_modality_scales = _broadcast("out_modality_scales",
                                         cfg.out_modality_scales)
    if cfg.multi_task:
        cfg.Ks = _broadcast("Ks", cfg.Ks)
        cfg.K = int(sum(cfg.Ks[:n_client_datasets]))
    return cfg
