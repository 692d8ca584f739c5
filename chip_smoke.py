"""Drive the PyTorch port on one NVIDIA GPU and hold every kernel against
its plain version.

    python3 chip_smoke.py            # all phases, one card

Phases (each raises on failure; the run then exits non-zero and prints no
result line):

1. card     name and power limit (nvidia-smi), torch and CUDA versions;
            TF32 off for matmuls and cuDNN.
2. build    every CUDA source of fedcola_tpu_torch/csrc, compiled in
            parallel into build/kernels/ (seconds printed); the SASS of
            mlp_fwd.o, mlp_bwd.o, attn_fwd.o and attn_bwd.o must hold wgmma
            (HGMMA) and TMA load (UTMALDG) instructions, the bf16 fused
            route's Hopper mainloop, attn_fwd.o and attn_bwd.o also
            mma.sync (HMMA), their resident per-head kernels, and so must
            flash_fwd.o and flash_bwd.o (the per-head forward and backward
            cores); every instantiation of the streamed per-head kernels
            (N > 256: attn_fwd_head_stream_kernel and the backward's row
            and column kernels, csrc/attn_wgmma.cuh) must hold HGMMA and
            UTMALDG in its own SASS; none of these kernels may spill.
3. kernels  each kernel wrapper against its plain PyTorch version at every
            shape its paths give it, N in {197, 40}: the fused kernels at
            mome_small's training shape (n=2 clients, B=96, D=384, H=6) and
            central eval (eval flags of kernels 1 and 3; n=1, B=500); the
            recompute backward kernels of the remat policies at the same
            training shape; flash attention at mome_tiny's training shape
            (n=2, B=96, H=3, hd=64) and its eval forward (n=1, B=500); in
            float32 (max|d| <= 1e-4 * max(1, max|ref|)) and bfloat16
            (max|d| / max|ref| <= 3e-2), forward outputs, P, cat and every
            gradient; the rows-mode MLP kernels at that batch flattened
            (n=2, rows = 96*N, D=384, F=1536); every bf16 entry point (the
            four MLP forwards and four backwards, the attention forward in
            its training and eval variants and its two backwards, the two
            flash kernels) called twice gives the same bits; median times
            and achieved TFLOP/s of the kernel,
            the plain version and a library call (torch.matmul +
            F.scaled_dot_product_attention / F.layer_norm / F.gelu, one
            call sequence per client, so host launches count in it; SDPA
            alone for flash attention).  Kernels 1-4 also at CreamFL's
            distillation shape (n=1, B=128 public rows, a dout on every
            token).  Past the resident kernels' 256 keys, where every
            attention kernel streams the keys: rows 1, 1e, 2, 5, 11, 11e
            and 12 (and the MLP rows, whose products do not depend on N)
            at N = 257 and 512, bfloat16 at the same shapes and float32
            at B = 8, every output and gradient, bitwise repeats in both
            dtypes; the fused rows at N = 1536 (n=2, B=4) and the flash
            rows at N = 1024 (n=2, B=8); bf16 at N = 512 timed; the route at
            N = 1025 (flash: ``attention_xla``, no launch; fused: its
            kernel).  Rows 3e and 6 also at a [tp] rank's shape (hidden
            768 of 1536, a zero b2), both dtypes, bf16 N=197 timed.
            Rows 1-4 also at [population]'s three-client stacks (n=3,
            B=96) and [flickr]'s B=112 (n=2), N in {197, 40}, both
            dtypes, untimed.  The fused optimizer step (opt_update.cu,
            no Pallas kernel) at the coco.sh population's three group
            shapes (CIFAR100 n=3, AG_NEWS n=3, Coco n=2 at mome_small):
            three masked AdamW steps within 1e-6 of max|ref| of the plain
            loop, then the kernel, the plain loop and
            torch.optim.AdamW(fused=True) timed over steps back to back,
            beside the bound of 28 bytes an element.  The routed
            experts' grouped GEMM (moe_gemm.cu, no Pallas kernel;
            ``check_moe``) at the moonlight cell's two step shapes (D
            2048, F 1408, 8 held of 64 experts, top-6; one client's image
            step, 96 x 197 tokens, and text step, 96 x 40, a random
            routing): forward and backward against the plain versions
            within the bf16 tolerance, y also in float32, a second call
            the same bits; both steps timed beside the plain version, a
            bf16 torch.matmul sequence a group and the bound.  At the
            same steps the dispatch and combine row kernels (moe_rows.cu,
            no Pallas kernel; ``_check_moe_rows``): bit for bit against
            their plain versions (dw within 1e-5 of its norm), padding
            rows zero, nothing read past the last group, a second call
            the same bits, one ``moe_fused`` count a call; timed beside
            the plain version, PyTorch over the live rows and the bound
            on the live rows' bytes.
4. model    the port's MAT forward and backward on the card (kernels) vs
            on the CPU (plain versions), small float32 models on the fused
            route (D=128) and the flash route (D=96); and on the card the
            remat policies 'kernel', 'save_attn' and 'full' against each
            other (D=128).
5. main     two rounds of the scripts/coco.sh FedCola line through
            ``fedcola_tpu_torch.main`` at full mome_small width (D=384,
            depth 12, B=96), synthetic data, two clients per group; every
            group must train on the resident data plane (its train set
            staged on the card; so in every line below but [resident]),
            the staged bytes and the peak device memory printed.
   resident the same two rounds with FEDCOLA_RESIDENT_BUDGET=0 (every
            batch copied from the host) in the same process: each round's
            training loss and every eval result bitwise equal to [main]'s;
            both runs' round_seconds and eval_seconds.
6. tiny     the same line at mome_tiny width (D=192, 3 heads, depth 12):
            attention through the flash kernels, no fused attention or
            MLP kernel; the optimizer step on its kernel.
   moonlight one round of the same line at mome_moonlight_a3b
            (Moonlight-16B-A3B's block at its published widths, about 1 B
            parameters a dataset; ``--Cs 0.25``: one client of each
            dataset; no dropout): both grouped-GEMM entry points, the
            four row kernels (as many launches as the round's
            ``moe_fused``) and the optimizer step launch, no fused
            attention, MLP or flash kernel.
   bound    for the mome_small and the mome_tiny line each: the same two
            rounds of training from the same seed on the card (kernels)
            and on the CPU (plain versions), at full width and depth with
            --B 4 and --dropout 0 (see ``loss_bound``); a round's training
            loss may differ by at most 1e-3 relative.
   baselines the coco.sh baselines at mome_small width through the entry
            point, two rounds each: FedIoT, FedProx, CreamFL (public set of
            500 synthetic pairs, batches of 128) and the FedAdam line of
            scripts/evidence_fedopt.sh; each launches the four fused
            training kernels; ``loss_bound`` for the FedProx and the
            CreamFL line (the latter with --num_pub_samples 20
            --pub_batch_size 20 on both devices); CreamFL's public set
            must be staged.
   retrieval COCO retrieval eval at mome_small on an in-memory test set of
            1000 unique 224 px images with 5 captions each (a deduplicated
            store): the unique-image split against the joint per-row
            forward (FEDCOLA_EVAL_UNIQUE_IMAGES=0), features within 3e-2
            of max|ref|, the 5k and 1k recalls within one image or caption
            per direction; both extraction times.
   local    one round of the FedCola line with --eval_type both
            --test_size 0.2: clients_evaluated_out present and finite,
            local eval's seconds.
   augment  one round with --crop 224 --randhf 0.5: resident, finite
            loss; the augmentation's apply on the card against the CPU
            with the same draws (equal; within 1 uint8 level where a
            resize runs).
   fixtures the coco.sh FedCola line as written (``main.fixture_flags``:
            ``--pretrained --use_bert_tokenizer``, path-backed
            ``--data_paths``) at mome_small width on fixtures written by
            ``data/fixtures.py`` at scripts/evidence_pretrained.sh's sizes
            and a ViT-small checkpoint from ``write_timm_vit_checkpoint``:
            the image towers (and the aux copies) hold the checkpoint at
            init; ``loss_bound``; three rounds, the third traced
            (``--profile_every 3``): every group resident, the four fused
            training kernels launched, text on the native encoder, Coco
            staged as a deduplicated image store (so retrieval takes the
            unique-image split), the towers moved off the checkpoint, each
            ``<ds>.pt`` loaded with ``weights_only`` maps back to the final
            weights bit for bit, and the trace names the ``fc_*`` ranges;
            writing, load, staging, export and trace sizes printed.
   flickr   the scripts/flickr.sh FedCola line (``main.FLICKR_FLAGS``:
            Flickr30k trains the img+txt clients, B=112, ``--C``) at
            mome_small width on Flickr30k / CIFAR100 / AG_NEWS fixtures
            written here, cut as [fixtures] cuts the coco.sh line (``--Ks 4
            4 4 --C 0.5 --E 1 --debug --R 2``): ``loss_bound``, two rounds,
            every group resident, rows 1-4 launched.
   population the scripts/coco.sh FedCola line at its own population and
            length (``main.POPULATION_FLAGS``: 12 + 12 + 8 clients, --Cs
            0.25, whole shards for --E 5 epochs at B=96, no --debug) for 15
            rounds at full mome_small width, eval every round: Coco on the
            JAX package's 100-round fixture (1000 path-backed 224 px
            images), CIFAR100 / AG_NEWS synthetic stand-ins; every round's
            sections, group losses and Coco r@1sum beside the JAX run's
            (docs/evidence/fedcola_100round_pathbacked_v5e.json), peak
            memory, staged bytes, the launches of rows 1-4; every loss
            finite, r@1sum at round 15 at least 1.0 and above round 5's.
            Then ``loss_bound`` on the same line without --debug at a
            small population (``--Ks 4 4 4 --Cs 0.5 --E 2``, chunks of two
            steps, fixtures of 10 COCO images and 52 CIFAR100 / AG_NEWS
            rows) in float32, 1e-4 relative: round 1's groups must be
            ragged, run past one chunk an epoch and end on partial
            batches, and rows 1-4 must launch.
7. remat    two local steps of the img+txt group update at mome_small
            (n=2, B=96) under each remat policy: finite losses that agree
            with 'kernel' to bfloat16 tolerance, peak memory per policy.
8. rows     the rows-mode MLP through its public functions
            (fused_mlp_sublayer, fused_mlp) on every layer of both stacks
            of the mome_small Coco img+txt model, n=2 clients, B=96
            flattened: output and every gradient against the item
            sublayer on the unflattened batch, and fused_mlp against its
            plain version, in bfloat16.

9. long     the long-text line (``main.MEDABS_LONG_FLAGS``: the
            MedicalAbstracts line of scripts/evidence_medabstracts.sh at
            ``--seq_len 512``, mome_small full width and depth, B=96):
            ``loss_bound``, two rounds (round and eval seconds, acc1 and
            f1, staged bytes, peak memory), one group update under
            'save_attn' (row 5 at N = 512) and one mome_tiny round of the
            same line (rows 11, 11e and 12 at N = 512); every attention
            launch of the phase is at N = 512, and each of rows 1, 1e, 2,
            3, 3e, 4, 5, 6, 11 and 12 must launch.
10. mesh    the device mesh on the one card, two ranks sharing it over
            gloo (``FEDCOLA_VIRTUAL_DEVICES=2``): [main]'s line with
            ``--mesh_shape 2`` (spawned; both ranks start with
            ``build/kernels/`` removed and the build must run once) and
            with ``--mesh_shape 1 2 --mesh_axes clients data`` as two
            ``--dist_*`` processes, each held against [main]'s losses,
            eval results and final weights by ``MESH_BOUNDS`` (bit for
            bit or not is printed); two planted faults, each of which the
            gates ``FAULT_GATES`` names must reject; every rank must
            launch rows 1-4 and the eval rows; each run's backend and
            every rank's staged bytes, peak memory, round and eval
            seconds and launches beside the card's name and power limit;
            the float32 products that differ between one client and two
            stacked; ``graft_entry.dryrun_multichip(4)`` on the card (four
            ranks, each launching rows 1-4); every collective of the mesh
            in a one-rank NCCL group against the identity.
11. tp      the ``model`` axis (Megatron tensor parallelism): [main]'s
            line with ``--mesh_shape 1 2 --mesh_axes clients model`` as two
            ``--dist_*`` processes sharing the card over gloo, each rank on
            3 of the 6 heads (rows 11 / 12) and 768 of the 1536 hidden
            columns (rows 3e / 6), held against [main] by ``MESH_BOUNDS``;
            every rank must launch rows 11, 12, 3e, 6 and the eval row 1e,
            and neither fused training backward (rows 2, 4); the planted
            fault ``FAULT_SKIP_ENTER``, which the gates ``FAULT_GATES``
            names must reject; ``graft_entry.dryrun_multichip(8)`` on the
            card (2 x 2 x 2 clients x data x model, eight ranks).
12. creamfl-mesh  CreamFL under the mesh: [baselines]' CreamFL line
            (``main.CREAMFL_FLAGS``) with ``--mesh_shape 2`` (spawned) and
            ``--mesh_shape 1 2 --mesh_axes clients data`` (two ``--dist_*``
            processes: 48 of 96 task rows, 64 of 128 public rows a rank),
            each held against [baselines]' one-device CreamFL run by
            ``MESH_BOUNDS``; the planted fault ``FAULT_OWN_FEATURES``, which
            the gates ``FAULT_GATES`` names must reject, and its readings
            with the replication check off; every rank must launch rows
            1-4 and the eval rows; every rank's figures as in [mesh].

The CPU sides of the loss bounds run in one background process from the
script's start (``CpuBounds``; they need no card) and are collected where
each bound is read.  Phases 5 to 9 (and resident, local, augment,
fixtures, flickr, population) each zero the launch counters just before
and read them just after; a kernel's launches are those of the path that
runs it.  The
[mesh], [tp] and [creamfl-mesh] ranks are processes of their own, which
count from zero.  The second-to-last line is a JSON object with one entry
per kernel (the bf16 N=197 training-shape times, under "eval" the
eval-shape times of the kernels central eval runs, under "distill" those
of kernels 1-4 at the distillation shape, and under "long" and
"long_eval" the N = 512 times at the training and eval shapes, "long"
with the [long] phase's launches; under "tp" rows 3e / 6 at a [tp] rank's
shape; under "mesh_launches" each [mesh] run's launches per rank, under
"creamfl_mesh_launches" each genuine [creamfl-mesh] run's, under
"tp_launches" the [tp] run's launches of rows 11, 12, 3e and 6 per rank;
under "population_launches" the [population] run's of rows 1-4);
the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12    # dense, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # non-tensor-core float32
H100_BYTES = 3.35e12        # HBM3

# entry point: (source, TPU kernel it replaces, the path that launches it)
KERNEL_INFO = {
    "attn_fwd": ("fedcola_tpu_torch/csrc/attn_fwd.cu",
                 "fedcola_tpu/ops/fused_attention.py:546", "main"),
    "attn_bwd": ("fedcola_tpu_torch/csrc/attn_bwd.cu",
                 "fedcola_tpu/ops/fused_attention.py:586", "main"),
    "mlp_fwd": ("fedcola_tpu_torch/csrc/mlp_fwd.cu",
                "fedcola_tpu/ops/fused_mlp.py:684", "main"),
    "mlp_bwd": ("fedcola_tpu_torch/csrc/mlp_bwd.cu",
                "fedcola_tpu/ops/fused_mlp.py:720", "main"),
    "attn_bwd_recompute": ("fedcola_tpu_torch/csrc/attn_bwd.cu",
                           "fedcola_tpu/ops/fused_attention.py:488", "remat"),
    "mlp_bwd_nores": ("fedcola_tpu_torch/csrc/mlp_bwd.cu",
                      "fedcola_tpu/ops/fused_mlp.py:720", "remat"),
    "flash_fwd": ("fedcola_tpu_torch/csrc/flash_fwd.cu",
                  "fedcola_tpu/ops/flash_attention.py:129", "tiny"),
    "flash_bwd": ("fedcola_tpu_torch/csrc/flash_bwd.cu",
                  "fedcola_tpu/ops/flash_attention.py:164", "tiny"),
    "mlp_fwd_rows": ("fedcola_tpu_torch/csrc/mlp_fwd.cu",
                     "fedcola_tpu/ops/fused_mlp.py:166", "rows"),
    "mlp_bwd_rows": ("fedcola_tpu_torch/csrc/mlp_bwd.cu",
                     "fedcola_tpu/ops/fused_mlp.py:197", "rows"),
    "mlp_ln_fwd_rows": ("fedcola_tpu_torch/csrc/mlp_fwd.cu",
                        "fedcola_tpu/ops/fused_mlp.py:385", "rows"),
    "mlp_ln_bwd_rows": ("fedcola_tpu_torch/csrc/mlp_bwd.cu",
                        "fedcola_tpu/ops/fused_mlp.py:418", "rows"),
    # no Pallas kernel: the JAX package's update, fused by XLA
    "opt_update": ("fedcola_tpu_torch/csrc/opt_update.cu", "none", "main"),
    # no kernel in the JAX package, which has no MoE layer
    "moe_gemm_fwd": ("fedcola_tpu_torch/csrc/moe_gemm.cu", "none",
                     "moonlight"),
    "moe_gemm_bwd": ("fedcola_tpu_torch/csrc/moe_gemm.cu", "none",
                     "moonlight"),
    "moe_dispatch_fwd": ("fedcola_tpu_torch/csrc/moe_rows.cu", "none",
                         "moonlight"),
    "moe_combine_fwd": ("fedcola_tpu_torch/csrc/moe_rows.cu", "none",
                        "moonlight"),
    "moe_dispatch_bwd": ("fedcola_tpu_torch/csrc/moe_rows.cu", "none",
                         "moonlight"),
    "moe_combine_bwd": ("fedcola_tpu_torch/csrc/moe_rows.cu", "none",
                        "moonlight"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median per-call device time from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_back_to_back_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the per-call device time of ``calls`` calls
    issued back to back: where the host issues a call faster than the card
    runs it, the card's time alone."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def check_sass(kernels) -> None:
    """The bf16 MLP and attention forwards and backwards run on wgmma fed
    by TMA, the resident per-head attention kernels (the fused forward's and
    backward's, flash attention's forward and backward) on mma.sync, and
    the streamed per-head kernels (N > 256) on wgmma fed by TMA: count
    those opcodes in the SASS of their object files and, for each streamed
    kernel instantiation, in its own SASS; print the registers, stack,
    static shared and local memory of each Hopper GEMM and head kernel
    instantiation, and fail if one of them spills (a stack frame or local
    memory)."""
    import re
    from pathlib import Path
    tool = str(Path(kernels._nvcc()).parent / "cuobjdump")
    wgmma = ("HGMMA", "UTMALDG")
    want = {"mlp_fwd.o": wgmma, "mlp_bwd.o": wgmma,
            "attn_fwd.o": wgmma + ("HMMA",), "attn_bwd.o": wgmma + ("HMMA",),
            "flash_fwd.o": wgmma + ("HMMA",),
            "flash_bwd.o": wgmma + ("HMMA",), "moe_gemm.o": wgmma}
    # the mangled template arguments: ILi64ELi2EE is <64, 2>
    pattern = re.compile(r"(sm90_gemm_kernel|moe_gemm_kernel|"
                         r"attn_bwd_head_kernel|"
                         r"attn_fwd_head_kernel|attn_fwd_head_stream_kernel|"
                         r"attn_bwd_head_rows_stream_kernel|"
                         r"attn_bwd_head_cols_stream_kernel)"
                         r"I((?:L[ib]\d+E)+)E")
    name_of = lambda m: f"{m.group(1)}<" + ",".join(
        re.findall(r"\d+", m.group(2))) + ">"
    streamed = 0
    for name, ops in want.items():
        obj = str(kernels.BUILD_DIR / name)
        run = lambda flag: subprocess.run(
            [tool, flag, obj], capture_output=True, text=True,
            check=True).stdout
        sass = run("-sass")
        counts = {op: sass.count(op) for op in ops}
        log(f"[build] {name} SASS: " +
            ", ".join(f"{n} {op}" for op, n in counts.items()))
        if not all(counts.values()):
            raise AssertionError(f"{name} lacks wgmma, TMA or mma: {counts}")
        # each streamed kernel's own SASS ("Function : <name>" opens it)
        for part in sass.split("Function : ")[1:]:
            m = pattern.search(part.split("\n", 1)[0])
            if not m or "_stream_kernel" not in m.group(1):
                continue
            streamed += 1
            own = {op: part.count(op) for op in wgmma}
            if not all(own.values()):
                raise AssertionError(f"{name_of(m)} in {name} lacks wgmma "
                                     f"or TMA: {own}")
        kernel = None
        for line in run("-res-usage").splitlines():
            if "Function" in line:
                m = pattern.search(line)
                kernel = m and name_of(m)
            elif kernel and "REG:" in line:
                usage = dict(f.split(":") for f in line.split()[:4])
                log(f"[build] {name} {kernel} {' '.join(line.split()[:4])}")
                if int(usage["LOCAL"]) or int(usage["STACK"]):
                    raise AssertionError(f"{kernel} spills: {line.strip()}")
                kernel = None
    log(f"[build] {streamed} streamed kernel instantiations, each with "
        f"HGMMA and UTMALDG in its SASS")
    if not streamed:
        raise AssertionError("no streamed head kernel in the SASS")


# ------------------------------------------------------------- kernels ----

def _tensors(seed, shapes, dtype, dev):
    """Random inputs from numpy (seeded); LN params and s stay float32."""
    import numpy as np
    import torch
    r = np.random.RandomState(seed)
    out = {}
    for name, (shape, scale, kind) in shapes.items():
        if kind == "s":
            a = r.choice([0.0, 1.0 / 0.9], size=shape)
        elif kind == "g":
            a = r.rand(*shape) + 0.5
        else:
            a = r.randn(*shape) * scale
        t = torch.from_numpy(a.astype(np.float32)).to(dev)
        out[name] = t if kind in ("s", "g", "b") else t.to(dtype)
    return out


def _compare(got, ref, dtype, what):
    """Per-tensor tolerance; returns the largest absolute difference."""
    import torch
    worst = 0.0
    for name, g, r in zip(what, got, ref):
        g, r = g.float(), r.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        d = (g - r).abs().max().item()
        m = r.abs().max().item()
        if dtype == torch.float32:
            ok = d <= 1e-4 * max(1.0, m)
            rel = d / max(1.0, m)
        else:
            ok = d <= 3e-2 * m
            rel = d / max(m, 1e-30)
        if not ok:
            raise AssertionError(
                f"{name} ({dtype}): max|d| {d:.3e} vs max|ref| {m:.3e} "
                f"(scaled error {rel:.3e}) exceeds the tolerance")
        worst = max(worst, d)
    return worst


def _same_bits(fn, args, first, name):
    """A second call of a kernel gives the first call's bits (no atomics
    on any path, float32 or bfloat16)."""
    import torch
    again = fn(*args)
    for a, b in zip(first, [again] if torch.is_tensor(again) else again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: a second call differs")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bound(flops, nbytes, dtype):
    import torch
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _attn_inputs(n, B, N, dtype, dev):
    D = 384
    return _tensors(11 + N + B, {
        "x": ((n, B, N, D), 1.0, "a"), "s": ((n, B), 0, "s"),
        "lns": ((n, D), 0, "g"), "lnb": ((n, D), 0.1, "b"),
        "wqkv": ((n, D, 3 * D), D ** -0.5, "a"),
        "bqkv": ((n, 3 * D), 0.1, "a"),
        "wproj": ((n, D, D), D ** -0.5, "a"), "bproj": ((n, D), 0.1, "a"),
        "da": ((n, B, N, D), 1.0, "a")}, dtype, dev)


def _mlp_inputs(n, B, N, dtype, dev, Fh=4 * 384):
    D = 384
    return _tensors(23 + N + B, {
        "x": ((n, B, N, D), 1.0, "a"), "s": ((n, B), 0, "s"),
        "lns": ((n, D), 0, "g"), "lnb": ((n, D), 0.1, "b"),
        "w1": ((n, D, Fh), D ** -0.5, "a"), "b1": ((n, Fh), 0.1, "a"),
        "w2": ((n, Fh, D), Fh ** -0.5, "a"), "b2": ((n, D), 0.1, "a"),
        "do": ((n, B, N, D), 1.0, "a")}, dtype, dev)


def lib_attn(x, s, lns, lnb, wqkv, bqkv, wproj, bproj, H=6):
    """The attention sublayer as torch.matmul + F.layer_norm +
    F.scaled_dot_product_attention: the library yardstick."""
    import torch
    import torch.nn.functional as F
    n, B, N, D = x.shape
    outs = []
    for c in range(n):
        h = F.layer_norm(x[c], (D,), lns[c].to(x.dtype), lnb[c].to(x.dtype),
                         1e-5)
        qkv = torch.matmul(h, wqkv[c]) + bqkv[c]
        q, k, v = (u.reshape(B, N, H, D // H).transpose(1, 2)
                   for u in qkv.split(D, -1))
        o = F.scaled_dot_product_attention(q, k, v)
        a = torch.matmul(o.transpose(1, 2).reshape(B, N, D), wproj[c]) \
            + bproj[c]
        outs.append(a if s is None
                    else x[c] + s[c][:, None, None].to(x.dtype) * a)
    return torch.stack(outs)


def lib_mlp(x, s, lns, lnb, w1, b1, w2, b2):
    """The MLP sublayer as torch.matmul + F.layer_norm + F.gelu (no
    F.layer_norm when lns is None: the rows-mode MLP without LN)."""
    import torch
    import torch.nn.functional as F
    D = x.shape[-1]
    outs = []
    for c in range(x.shape[0]):
        h = x[c] if lns is None else F.layer_norm(
            x[c], (D,), lns[c].to(x.dtype), lnb[c].to(x.dtype), 1e-5)
        m = torch.matmul(F.gelu(torch.matmul(h, w1[c]) + b1[c]), w2[c]) \
            + b2[c]
        outs.append(m if s is None
                    else x[c] + s[c][:, None, None].to(x.dtype) * m)
    return torch.stack(outs)


def check_attention(N, dtype, dev, timing, n=2, B=96):
    """Kernels 1 and 2 at a training shape (the group update's n=2, B=96;
    the distillation's n=1, B=128): kernel 1 with the training flags
    (save, residual) and the eval flags (neither), kernel 2 from the plain
    version's saves with a random dout on every token."""
    import torch
    from fedcola_tpu_torch.ops import fused_attention as fa
    D, H = 384, 6
    t = _attn_inputs(n, B, N, dtype, dev)
    if not bool((t["s"] != 0).any()):
        raise AssertionError(f"n={n}, B={B}, N={N}: every DropPath scale "
                             f"is 0, so the backward would check nothing")
    w = [t[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")]
    res = {}
    got = fa.attn_fwd(t["x"], t["s"], *w, H, save=True)
    ref = fa.attn_fwd_plain(t["x"], t["s"], *w, H, save=True)
    err1 = _compare(got, ref, dtype, ("out", "P", "cat"))
    _same_bits(fa.attn_fwd, (t["x"], t["s"], *w, H, True), got, "attn_fwd")
    got_e = fa.attn_fwd(t["x"], None, *w, H, save=False)[0]
    ref_e = fa.attn_fwd_plain(t["x"], None, *w, H, save=False)[0]
    err1 = max(err1, _compare([got_e], [ref_e], dtype, ("out_eval",)))
    _same_bits(lambda *a: fa.attn_fwd(*a)[0], (t["x"], None, *w, H, False),
               [got_e], "attn_fwd (eval)")
    P, cat = ref[1], ref[2]
    args2 = (t["x"], t["s"], *w[:5], P, cat, t["da"], H)
    got2 = fa.attn_bwd(*args2)
    ref2 = fa.attn_bwd_plain(*args2)
    err2 = _compare(got2, ref2, dtype, ("dx", "dlns", "dlnb", "dwqkv",
                                        "dbqkv", "dwproj", "dbproj"))
    _same_bits(fa.attn_bwd, args2, got2, "attn_bwd")
    res["attn_fwd"] = {"max_abs_err": err1}
    res["attn_bwd"] = {"max_abs_err": err2}
    if not timing:
        return res
    M = B * N
    fl1 = n * (2.0 * M * 4 * D * D + 4.0 * B * N * N * D)
    by1 = _nbytes(t["x"], t["s"], *w, *got)
    # the backward recomputes qkv from x (qkv is not among its inputs)
    fl2 = n * (22.0 * M * D * D + 8.0 * B * N * N * D)
    by2 = _nbytes(t["x"], t["s"], *w[:5], P, cat, t["da"], *got2)
    lib_in = [t["x"].clone().requires_grad_(True), t["s"]] + \
        [u.clone().requires_grad_(True) for u in w]
    lib_out = lib_attn(*lib_in)
    grads_of = [lib_in[0]] + lib_in[2:]
    res["attn_fwd"].update(
        ms=time_ms(lambda: fa.attn_fwd(t["x"], t["s"], *w, H, save=True)),
        plain_ms=time_ms(lambda: fa.attn_fwd_plain(t["x"], t["s"], *w, H)),
        library_ms=time_ms(lambda: lib_attn(*lib_in)),
        flops=fl1, bytes=by1)
    res["attn_bwd"].update(
        ms=time_ms(lambda: fa.attn_bwd(*args2)),
        plain_ms=time_ms(lambda: fa.attn_bwd_plain(*args2)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, grads_of, t["da"], retain_graph=True)),
        flops=fl2, bytes=by2)
    return res


def check_mlp(N, dtype, dev, timing, n=2, B=96):
    """Kernels 3 and 4 at a training shape (as ``check_attention``):
    kernel 3 with and without the residual join."""
    import torch
    from fedcola_tpu_torch.ops import fused_mlp as fm
    D = 384
    Fh = 4 * D
    t = _mlp_inputs(n, B, N, dtype, dev)
    w = [t[k] for k in ("lns", "lnb", "w1", "b1", "w2", "b2")]
    res = {}
    got = fm.mlp_fwd(t["x"], t["s"], *w)
    ref = fm.mlp_fwd_plain(t["x"], t["s"], *w)
    err3 = _compare([got], [ref], dtype, ("out",))
    _same_bits(fm.mlp_fwd, (t["x"], t["s"], *w), [got], "mlp_fwd")
    got_e = fm.mlp_fwd(t["x"], None, *w)
    ref_e = fm.mlp_fwd_plain(t["x"], None, *w)
    err3 = max(err3, _compare([got_e], [ref_e], dtype, ("out_eval",)))
    _same_bits(fm.mlp_fwd, (t["x"], None, *w), [got_e], "mlp_fwd (eval)")
    args4 = (t["x"], t["s"], *w[:5], t["do"])
    got4 = fm.mlp_bwd(*args4)
    ref4 = fm.mlp_bwd_plain(*args4)
    err4 = _compare(got4, ref4, dtype, ("dx", "dlns", "dlnb", "dw1", "db1",
                                        "dw2", "db2"))
    _same_bits(fm.mlp_bwd, args4, got4, "mlp_bwd")
    res["mlp_fwd"] = {"max_abs_err": err3}
    res["mlp_bwd"] = {"max_abs_err": err4}
    if not timing:
        return res
    M = B * N
    fl3 = n * 4.0 * M * D * Fh
    by3 = _nbytes(t["x"], t["s"], *w, got)
    # fc1 recomputed, then dh, dW1, dW2 and dx: five M x D x 4D products
    fl4 = n * 10.0 * M * D * Fh
    by4 = _nbytes(t["x"], t["s"], *w[:5], t["do"], *got4)
    lib_in = [t["x"].clone().requires_grad_(True), t["s"]] + \
        [u.clone().requires_grad_(True) for u in w]
    lib_out = lib_mlp(*lib_in)
    grads_of = [lib_in[0]] + lib_in[2:]
    res["mlp_fwd"].update(
        ms=time_ms(lambda: fm.mlp_fwd(t["x"], t["s"], *w)),
        plain_ms=time_ms(lambda: fm.mlp_fwd_plain(t["x"], t["s"], *w)),
        library_ms=time_ms(lambda: lib_mlp(*lib_in)),
        flops=fl3, bytes=by3)
    res["mlp_bwd"].update(
        ms=time_ms(lambda: fm.mlp_bwd(*args4)),
        plain_ms=time_ms(lambda: fm.mlp_bwd_plain(*args4)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, grads_of, t["do"], retain_graph=True)),
        flops=fl4, bytes=by4)
    return res


def _lib_grad_timer(lib, t, wnames, dout):
    """Time torch autograd through a library composition: the gradients
    of every input the kernel differentiates."""
    import torch
    lib_in = [t["x"].clone().requires_grad_(True), None] + \
        [t[k].clone().requires_grad_(True) for k in wnames]
    lib_out = lib(*lib_in)
    grads_of = [lib_in[0]] + lib_in[2:]
    return time_ms(lambda: torch.autograd.grad(lib_out, grads_of, dout,
                                               retain_graph=True))


def check_remat(N, dtype, dev, timing, n=2, B=96):
    """Kernels 5 and 6, the backward of the remat policies, at the
    training shape (n=2, B=96): the recompute attention backward and the
    MLP backward without residual."""
    from fedcola_tpu_torch.ops import fused_attention as fa
    from fedcola_tpu_torch.ops import fused_mlp as fm
    D, H = 384, 6
    ta = _attn_inputs(n, B, N, dtype, dev)
    wa = [ta[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj")]
    args5 = (ta["x"], *wa, ta["da"], H)
    got5 = fa.attn_bwd_recompute(*args5)
    ref5 = fa.attn_bwd_recompute_plain(*args5)
    names = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj")
    res = {"attn_bwd_recompute": {"max_abs_err": _compare(got5, ref5, dtype,
                                                          names)}}
    _same_bits(fa.attn_bwd_recompute, args5, got5, "attn_bwd_recompute")
    del ref5
    tm = _mlp_inputs(n, B, N, dtype, dev)
    wm = [tm[k] for k in ("lns", "lnb", "w1", "b1", "w2")]
    args6 = (tm["x"], None, *wm, tm["do"])
    got6 = fm.mlp_bwd(*args6)
    ref6 = fm.mlp_bwd_plain(*args6)
    res["mlp_bwd_nores"] = {"max_abs_err": _compare(
        got6, ref6, dtype, ("dx", "dlns", "dlnb", "dw1", "db1", "dw2",
                            "db2"))}
    _same_bits(fm.mlp_bwd, args6, got6, "mlp_bwd_nores")
    del ref6
    if not timing:
        return res
    M = B * N
    Fh = 4 * D
    res["attn_bwd_recompute"].update(
        ms=time_ms(lambda: fa.attn_bwd_recompute(*args5)),
        plain_ms=time_ms(lambda: fa.attn_bwd_recompute_plain(*args5)),
        library_ms=_lib_grad_timer(lib_attn, ta, ("lns", "lnb", "wqkv",
                                                  "bqkv", "wproj", "bproj"),
                                   ta["da"]),
        # kernel 2's products plus the recomputed q.k^T and P.v
        flops=n * (22.0 * M * D * D + 12.0 * B * N * N * D),
        bytes=_nbytes(ta["x"], *wa, ta["da"], *got5))
    res["mlp_bwd_nores"].update(
        ms=time_ms(lambda: fm.mlp_bwd(*args6)),
        plain_ms=time_ms(lambda: fm.mlp_bwd_plain(*args6)),
        library_ms=_lib_grad_timer(lib_mlp, tm, ("lns", "lnb", "w1", "b1",
                                                 "w2", "b2"), tm["do"]),
        flops=n * 10.0 * M * D * Fh,
        bytes=_nbytes(tm["x"], *wm, tm["do"], *got6))
    return res


# [tp]'s hidden width a rank: mome_small's 1536 over a model axis of 2
TP_HIDDEN = 768


def check_tp_mlp(N, dtype, dev, timing, n=2, B=96):
    """Kernels 3e and 6 at [tp]'s shape: one model rank's MLP of
    mome_small (n=2, B=96, D=384, hidden ``TP_HIDDEN``) with the zero b2
    the Megatron route gives it (``models/mat.py`` ``mlp_partial``)."""
    import torch
    from fedcola_tpu_torch.ops import fused_mlp as fm
    D = 384
    t = _mlp_inputs(n, B, N, dtype, dev, Fh=TP_HIDDEN)
    t["b2"] = torch.zeros_like(t["b2"])
    w = [t[k] for k in ("lns", "lnb", "w1", "b1", "w2", "b2")]
    got = fm.mlp_fwd(t["x"], None, *w)
    res = {"mlp_fwd": {"max_abs_err": _compare(
        [got], [fm.mlp_fwd_plain(t["x"], None, *w)], dtype, ("out",))}}
    _same_bits(fm.mlp_fwd, (t["x"], None, *w), [got], "mlp_fwd (tp)")
    args6 = (t["x"], None, *w[:5], t["do"])
    got6 = fm.mlp_bwd(*args6)
    res["mlp_bwd_nores"] = {"max_abs_err": _compare(
        got6, fm.mlp_bwd_plain(*args6), dtype,
        ("dx", "dlns", "dlnb", "dw1", "db1", "dw2", "db2"))}
    _same_bits(fm.mlp_bwd, args6, got6, "mlp_bwd_nores (tp)")
    if not timing:
        return res
    M = B * N
    with torch.no_grad():
        res["mlp_fwd"].update(
            ms=time_ms(lambda: fm.mlp_fwd(t["x"], None, *w)),
            plain_ms=time_ms(lambda: fm.mlp_fwd_plain(t["x"], None, *w)),
            library_ms=time_ms(lambda: lib_mlp(t["x"], None, *w)),
            flops=n * 4.0 * M * D * TP_HIDDEN,
            bytes=_nbytes(t["x"], *w, got))
    res["mlp_bwd_nores"].update(
        ms=time_ms(lambda: fm.mlp_bwd(*args6)),
        plain_ms=time_ms(lambda: fm.mlp_bwd_plain(*args6)),
        library_ms=_lib_grad_timer(lib_mlp, t, ("lns", "lnb", "w1", "b1",
                                                "w2", "b2"), t["do"]),
        flops=n * 10.0 * M * D * TP_HIDDEN,
        bytes=_nbytes(t["x"], *w[:5], t["do"], *got6))
    return res


def check_rows(N, dtype, dev, timing):
    """Rows 7-10, the rows-mode MLP, at the training batch flattened: n=2
    clients, rows = 96*N (18,912 and 3,840), D=384, F=1536."""
    import torch
    from fedcola_tpu_torch.ops import fused_mlp as fm
    n, D = 2, 384
    Fh, M = 4 * D, 96 * N
    t = _mlp_inputs(n, 96, N, dtype, dev)
    for k in ("x", "do"):
        t[k] = t[k].reshape(n, M, D)
    x, do = t["x"], t["do"]
    ln = [t["lns"], t["lnb"]]
    w = [t[k] for k in ("w1", "b1", "w2", "b2")]
    grads = ("dx", "dw1", "db1", "dw2", "db2")
    cases = {
        "mlp_fwd_rows": (fm.mlp_fwd_rows, fm.mlp_fwd_rows_plain, (x, *w),
                         ("out",), 4.0),
        "mlp_bwd_rows": (fm.mlp_bwd_rows, fm.mlp_bwd_rows_plain,
                         (x, *w[:3], do), grads, 10.0),
        "mlp_ln_fwd_rows": (fm.mlp_ln_fwd_rows, fm.mlp_ln_fwd_rows_plain,
                            (x, *ln, *w), ("out",), 4.0),
        "mlp_ln_bwd_rows": (fm.mlp_ln_bwd_rows, fm.mlp_ln_bwd_rows_plain,
                            (x, *ln, *w[:3], do),
                            ("dx", "dlns", "dlnb") + grads[1:], 10.0),
    }
    res = {}
    for name, (kern, plain, args, what, per_mdf) in cases.items():
        got, ref = kern(*args), plain(*args)
        if torch.is_tensor(got):
            got, ref = [got], [ref]
        res[name] = {"max_abs_err": _compare(got, ref, dtype, what)}
        del ref
        _same_bits(kern, args, got, name)
        if timing:
            # fc1 and fc2 forward; the backward recomputes fc1, then dh,
            # dW1, dW2 and dx: five rows x D x F products
            res[name].update(
                ms=time_ms(lambda: kern(*args)),
                plain_ms=time_ms(lambda: plain(*args)),
                flops=n * per_mdf * M * D * Fh, bytes=_nbytes(*args, *got))
    if not timing:
        return res
    no_ln = lambda x_, s_, *w_: lib_mlp(x_, s_, None, None, *w_)
    with torch.no_grad():
        res["mlp_fwd_rows"]["library_ms"] = time_ms(
            lambda: no_ln(x, None, *w))
        res["mlp_ln_fwd_rows"]["library_ms"] = time_ms(
            lambda: lib_mlp(x, None, *ln, *w))
    res["mlp_bwd_rows"]["library_ms"] = _lib_grad_timer(
        no_ln, t, ("w1", "b1", "w2", "b2"), do)
    res["mlp_ln_bwd_rows"]["library_ms"] = _lib_grad_timer(
        lib_mlp, t, ("lns", "lnb", "w1", "b1", "w2", "b2"), do)
    return res


def _flash_inputs(n, B, N, dtype, dev):
    H, hd = 3, 64
    return _tensors(31 + N + B, {k: ((n, B, H, N, hd), 1.0, "a")
                                 for k in ("q", "k", "v", "do")}, dtype, dev)


def _sdpa(q, k, v, scale):
    """F.scaled_dot_product_attention over [n*B, H, N, hd]: the library
    yardstick of flash attention."""
    import torch.nn.functional as F
    sh = q.shape
    q4, k4, v4 = (t.reshape((-1,) + tuple(sh[-3:])) for t in (q, k, v))
    return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)


def check_flash(N, dtype, dev, timing, n=2, B=96):
    """Kernels 11 and 12 at mome_tiny's training shape (n=2, B=96, H=3,
    hd=64): one launch covers all n*B*H pairs."""
    import torch
    from fedcola_tpu_torch.ops import flash_attention as fl
    t = _flash_inputs(n, B, N, dtype, dev)
    q, k, v, do = (t[x] for x in ("q", "k", "v", "do"))
    scale = 64 ** -0.5
    got = fl.flash_fwd(q, k, v, scale)
    res = {"flash_fwd": {"max_abs_err": _compare(
        [got], [fl.flash_fwd_plain(q, k, v, scale)], dtype, ("o",))}}
    _same_bits(fl.flash_fwd, (q, k, v, scale), [got], "flash_fwd")
    gotb = fl.flash_bwd(q, k, v, do, scale)
    res["flash_bwd"] = {"max_abs_err": _compare(
        gotb, fl.flash_bwd_plain(q, k, v, do, scale), dtype,
        ("dq", "dk", "dv"))}
    _same_bits(fl.flash_bwd, (q, k, v, do, scale), gotb, "flash_bwd")
    if not timing:
        return res
    pairs = q.numel() // (N * 64)
    lib_in = [u.clone().requires_grad_(True) for u in (q, k, v)]
    lib_out = _sdpa(*lib_in, scale)
    do4 = do.reshape(lib_out.shape)
    with torch.no_grad():
        res["flash_fwd"].update(
            ms=time_ms(lambda: fl.flash_fwd(q, k, v, scale)),
            plain_ms=time_ms(lambda: fl.flash_fwd_plain(q, k, v, scale)),
            library_ms=time_ms(lambda: _sdpa(q, k, v, scale)),
            flops=4.0 * pairs * N * N * 64, bytes=_nbytes(q, k, v, got))
    res["flash_bwd"].update(
        ms=time_ms(lambda: fl.flash_bwd(q, k, v, do, scale)),
        plain_ms=time_ms(lambda: fl.flash_bwd_plain(q, k, v, do, scale)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, lib_in, do4, retain_graph=True)),
        # recomputed q.k^T, then dP, dV, dQ and dK
        flops=10.0 * pairs * N * N * 64, bytes=_nbytes(q, k, v, do, *gotb))
    return res


def check_eval(N, dtype, dev, timing, B=500):
    """Kernels 1 and 3 with the eval flags (no saves, no residual), and the
    flash forward (mome_tiny), at the central evaluation's shape: the
    unstacked global model (n=1) on one batch of min(--eval_batch_size
    512, 500 synthetic test rows) = 500."""
    import torch
    from fedcola_tpu_torch.ops import flash_attention as fl
    from fedcola_tpu_torch.ops import fused_attention as fa
    from fedcola_tpu_torch.ops import fused_mlp as fm
    n, D, H = 1, 384, 6
    ta = _attn_inputs(n, B, N, dtype, dev)
    wa = [ta[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")]
    got = fa.attn_fwd(ta["x"], None, *wa, H, save=False)[0]
    ref = fa.attn_fwd_plain(ta["x"], None, *wa, H, save=False)[0]
    res = {"attn_fwd": {"max_abs_err": _compare(
        [got], [ref], dtype, ("out_eval",))}}
    del ref
    _same_bits(lambda *a: fa.attn_fwd(*a)[0], (ta["x"], None, *wa, H, False),
               [got], "attn_fwd (eval)")
    tm = _mlp_inputs(n, B, N, dtype, dev)
    wm = [tm[k] for k in ("lns", "lnb", "w1", "b1", "w2", "b2")]
    got_m = fm.mlp_fwd(tm["x"], None, *wm)
    ref_m = fm.mlp_fwd_plain(tm["x"], None, *wm)
    res["mlp_fwd"] = {"max_abs_err": _compare(
        [got_m], [ref_m], dtype, ("out_eval",))}
    del ref_m
    _same_bits(fm.mlp_fwd, (tm["x"], None, *wm), [got_m], "mlp_fwd (eval)")
    tf = _flash_inputs(n, B, N, dtype, dev)
    fq, fk, fv = (tf[x] for x in ("q", "k", "v"))
    got_f = fl.flash_fwd(fq, fk, fv, 0.125)
    res["flash_fwd"] = {"max_abs_err": _compare(
        [got_f], [fl.flash_fwd_plain(fq, fk, fv, 0.125)], dtype, ("o",))}
    _same_bits(fl.flash_fwd, (fq, fk, fv, 0.125), [got_f], "flash_fwd")
    if not timing:
        return res
    M = B * N
    with torch.no_grad():
        res["attn_fwd"].update(
            ms=time_ms(lambda: fa.attn_fwd(ta["x"], None, *wa, H,
                                           save=False)),
            plain_ms=time_ms(lambda: fa.attn_fwd_plain(
                ta["x"], None, *wa, H, save=False)),
            library_ms=time_ms(lambda: lib_attn(ta["x"], None, *wa, H)),
            flops=n * (2.0 * M * 4 * D * D + 4.0 * B * N * N * D),
            bytes=_nbytes(ta["x"], *wa, got))
        res["mlp_fwd"].update(
            ms=time_ms(lambda: fm.mlp_fwd(tm["x"], None, *wm)),
            plain_ms=time_ms(lambda: fm.mlp_fwd_plain(tm["x"], None, *wm)),
            library_ms=time_ms(lambda: lib_mlp(tm["x"], None, *wm)),
            flops=n * 4.0 * M * D * 4 * D,
            bytes=_nbytes(tm["x"], *wm, got_m))
        res["flash_fwd"].update(
            ms=time_ms(lambda: fl.flash_fwd(fq, fk, fv, 0.125)),
            plain_ms=time_ms(lambda: fl.flash_fwd_plain(fq, fk, fv, 0.125)),
            library_ms=time_ms(lambda: _sdpa(fq, fk, fv, 0.125)),
            flops=4.0 * fq.numel() * N, bytes=_nbytes(fq, fk, fv, got_f))
    return res


LONG_N = 512                # the long-text line's --seq_len


def _report(name, shape, dtype, N, r, timing):
    """One [kernels] line: the error, and with ``timing`` the times, the
    bound and the achieved rate."""
    line = (f"[kernels] {name:18s} {shape:9s} {str(dtype)[6:]:8s} N={N:4d} "
            f"max|d|={r['max_abs_err']:.3e}")
    if timing:
        bound, by = _bound(r["flops"], r["bytes"], dtype)
        r.update(bound_ms=bound, bound_by=by)
        line += (f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                 f"library_ms={r['library_ms']:.4f} bound_ms={bound:.4f} "
                 f"({by}) ms/bound={r['ms'] / bound:.1f} "
                 f"ms/library={r['ms'] / r['library_ms']:.1f} "
                 f"TFLOP/s={r['flops'] / r['ms'] / 1e9:.1f}")
    log(line)


def phase_kernels():
    """Every kernel against its plain version at every shape its path
    gives it (rows 1-4 also at [population]'s n=3 and [flickr]'s B=112
    stacks, untimed).  Returns, per kernel, the bf16 N=197 training-shape
    measurements (the image stack, the main path's largest shape), the
    bf16 N=197 eval-shape ones under "eval", the distillation-shape ones
    under "distill", [tp]'s rank shape under "tp", the bf16 N=512 ones (the long-text line, the keys
    streamed) under "long" and "long_eval", and the worst absolute error
    of all its comparisons."""
    import functools
    import torch
    dev = torch.device("cuda")
    distill = dict(n=1, B=128)
    measured, worst = {}, {}

    def record(res, shape, dtype, N, timing, key=None):
        for name, r in res.items():
            worst[name] = max(worst.get(name, 0.0), r["max_abs_err"])
            _report(name, shape, dtype, N, r, timing)
            if timing and key:
                measured[key(name)] = r

    for dtype in (torch.float32, torch.bfloat16):
        timing = dtype == torch.bfloat16
        for N in (197, 40):
            for shape, check in (
                    ("train", check_attention), ("train", check_mlp),
                    ("train", check_remat), ("train", check_flash),
                    ("rows", check_rows), ("eval", check_eval),
                    ("distill", functools.partial(check_attention,
                                                  **distill)),
                    ("distill", functools.partial(check_mlp, **distill)),
                    ("tp", check_tp_mlp)):
                key = None
                if N == 197:
                    key = ((lambda k, s=shape: f"{k}:{s}")
                           if shape in ("eval", "distill", "tp") else str)
                record(check(N, dtype, dev, timing), shape, dtype, N, timing,
                       key)
                torch.cuda.empty_cache()
            # [population]'s three-client stacks and [flickr]'s B = 112:
            # checked, not timed
            for shape, kw in (("n=3,B=96", dict(n=3)),
                              ("n=2,B=112", dict(B=112))):
                for check in (check_attention, check_mlp):
                    record(check(N, dtype, dev, False, **kw), shape, dtype,
                           N, False)
                torch.cuda.empty_cache()
    check_long_kernels(dev, record)
    measured["opt_update"] = check_opt(dev, record)
    measured.update(check_moe(dev, record))
    for name in worst:
        measured[name]["max_abs_err"] = worst[name]
        for shape in ("eval", "distill", "long", "long_eval", "tp",
                      "text"):
            if f"{name}:{shape}" in measured:
                measured[name][shape] = measured.pop(f"{name}:{shape}")
    return measured


def check_long_kernels(dev, record):
    """Past the resident kernels' 256 keys, where every attention kernel
    streams the keys: rows 1, 1e, 2, 5, 11, 11e and 12 (and the MLP rows
    3, 3e, 4 and 6, whose products do not depend on N) at N = 257 (the
    edge) and 512 (the long line), in bfloat16 at the path's shapes and
    in float32 (the CUDA-core kernels) at B = 8, forward and every
    gradient, each called twice for the same bits; bf16 at N = 512 timed
    ("long": training shape, "long_eval": central eval's).  Then the far
    ends at a batch small enough for the plain versions' memory: the fused
    rows at N = 1536 (n=2, B=4), the flash rows at N = 1024 (n=2, B=8).
    Last, the route at N = 1025: the flash route runs ``attention_xla``
    (no flash launch), the fused route its kernel."""
    import torch
    from fedcola_tpu_torch.ops import flash_attention as fl
    from fedcola_tpu_torch.ops import fused_attention as fa
    from fedcola_tpu_torch.ops import kernels
    from fedcola_tpu_torch.ops.attention import attention_xla
    for dtype in (torch.float32, torch.bfloat16):
        small = dtype == torch.float32
        for N in (257, LONG_N):
            timing = dtype == torch.bfloat16 and N == LONG_N
            for shape, check in (("long", check_attention),
                                 ("long", check_mlp), ("long", check_remat),
                                 ("long", check_flash),
                                 ("long_eval", check_eval)):
                size = {} if not small else (
                    dict(B=8) if check is check_eval else dict(n=2, B=8))
                record(check(N, dtype, dev, timing, **size), shape, dtype, N,
                       timing, lambda k, s=shape: f"{k}:{s}")
                torch.cuda.empty_cache()
        for N, check, size in ((1536, check_attention, dict(n=2, B=4)),
                               (1536, check_remat, dict(n=2, B=4)),
                               (1024, check_flash, dict(n=2, B=8))):
            record(check(N, dtype, dev, False, **size), "far", dtype, N,
                   False)
            torch.cuda.empty_cache()
    # the route past MAX_FUSED_SEQ
    N = fl.MAX_FUSED_SEQ + 1
    t = _flash_inputs(1, 2, N, torch.bfloat16, dev)
    leaves = [t[k].clone().requires_grad_(True) for k in ("q", "k", "v")]
    kernels.reset_launches()
    o = fl.flash_attention(*leaves, 0.125)
    grads = torch.autograd.grad(o, leaves, t["do"])
    ref = attention_xla(*leaves, 0.125)
    same = torch.equal(o, ref) and all(
        torch.equal(a, b) for a, b in
        zip(grads, torch.autograd.grad(ref, leaves, t["do"])))
    flash_launches = kernels.LAUNCHES["flash_fwd"] + \
        kernels.LAUNCHES["flash_bwd"]
    ta = _attn_inputs(1, 2, N, torch.bfloat16, dev)
    wa = [ta[k] for k in ("lns", "lnb", "wqkv", "bqkv", "wproj", "bproj")]
    out = fa.attn_fwd(ta["x"], None, *wa, 6, save=False)[0]
    log(f"[kernels] route N={N}: flash route launches {flash_launches} "
        f"kernels and equals attention_xla bitwise ({same}); fused route "
        f"launches attn_fwd {kernels.LAUNCHES['attn_fwd']} time(s), "
        f"finite {bool(torch.isfinite(out.float()).all())}")
    if flash_launches or not same or kernels.LAUNCHES["attn_fwd"] != 1:
        raise AssertionError(f"route at N={N}: {dict(kernels.LAUNCHES)}")


# the coco.sh population's groups whose optimizer step [kernels] times:
# (dataset, clients sampled a round), mome_small, AdamW with f32 moments
OPT_GROUPS = (("CIFAR100", 3), ("AG_NEWS", 3), ("Coco", 2))
OPT_BYTES = 28              # p, g, m, v read; p, m, v written (float32)
OPT_FLOPS = 15              # AdamW's operations an element


def check_opt(dev, record):
    """The fused optimizer step (``fc_opt_update``) at the three coco.sh
    population group shapes (``OPT_GROUPS``: mome_small's leaves under
    ``main.POPULATION_FLAGS``, stacked over the group's clients): three
    steps under a mask that leaves a client out against the plain loop
    (within 1e-6 of max|ref|, counters equal), then timed beside the plain
    loop, one ``torch.optim.AdamW(fused=True)`` step over the same leaves
    (the yardstick; the port never calls it) and the bytes bound, each a
    step's device time over steps issued back to back (the wrapper's host
    work, about 0.2 ms a step, overlaps the kernel's).  Returns
    the Coco group's measurements with every group's under "groups"."""
    import torch
    from fedcola_tpu_torch import main as m
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.models.mat import init_mat, tree_leaves, tree_map
    from fedcola_tpu_torch.models.registry import build_mat_config
    from fedcola_tpu_torch.parallel import optim
    cfg = parse_args(list(m.POPULATION_FLAGS))
    spec = optim.make_optimizer_spec(cfg)
    lr = cfg.lr
    groups = {}
    for ds, n in OPT_GROUPS:
        mcfg = build_mat_config(cfg.model_name, cfg, ds)
        with torch.device("meta"):
            shapes = tree_map(lambda a: (n,) + tuple(a.shape),
                              init_mat(mcfg, torch.Generator()))
        gen = torch.Generator(device=dev).manual_seed(n)
        params = tree_map(lambda s: torch.randn(
            s, device=dev, generator=gen) * 0.02, shapes)
        grads = tree_map(lambda p: torch.randn(
            p.shape, device=dev, generator=gen) * 1e-3, params)
        state = optim.init_opt_state(spec, params, n)
        ref_p = tree_map(lambda a: a.clone(), params)
        ref_s = tree_map(lambda a: a.clone(), state)
        sv = torch.tensor([c != 1 for c in range(n)], device=dev)
        for _ in range(3):
            optim.opt_update(spec, params, grads, state, lr, step_valid=sv)
            optim.opt_update_plain(spec, ref_p, grads, ref_s, lr,
                                   step_valid=sv)
        worst = 0.0
        for a, b in zip(tree_leaves(params) + tree_leaves(state),
                        tree_leaves(ref_p) + tree_leaves(ref_s)):
            if a.dtype == torch.int32:
                if not torch.equal(a, b):
                    raise AssertionError(f"opt_update {ds}: counters differ")
                continue
            d = (a - b).abs().max().item()
            if d > 1e-6 * b.abs().max().item():
                raise AssertionError(f"opt_update {ds}: max|d| {d:.3e} "
                                     f"vs max|ref| "
                                     f"{b.abs().max().item():.3e}")
            worst = max(worst, d)
        del ref_p, ref_s
        elements = sum(p.numel() for p in tree_leaves(params))
        ms = time_back_to_back_ms(lambda: optim.opt_update(
            spec, params, grads, state, lr))
        plain_ms = time_back_to_back_ms(lambda: optim.opt_update_plain(
            spec, params, grads, state, lr))
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in tree_leaves(params)]
        for p, g in zip(leaves, tree_leaves(grads)):
            p.grad = g
        lib = torch.optim.AdamW(leaves, lr=lr, betas=(spec.beta1,
                                                      spec.beta2),
                                eps=spec.eps, weight_decay=spec.weight_decay,
                                fused=True)
        library_ms = time_back_to_back_ms(lib.step)
        del lib, leaves, params, grads, state
        r = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, flops=OPT_FLOPS * elements,
                 bytes=OPT_BYTES * elements)
        record({"opt_update": r}, f"{ds},n={n}", torch.float32, 0, True)
        log(f"[kernels] opt_update {ds} n={n}: {elements} elements, "
            f"{len(tree_leaves(shapes))} leaves, "
            f"ms/plain={ms / plain_ms:.3f}")
        groups[ds] = r
        torch.cuda.empty_cache()
    main = dict(groups["Coco"])
    main["groups"] = {ds: {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for ds, r in groups.items()}
    return main


# Moonlight-16B-A3B's routed experts as the coco-pop1.moonlight_a3b_mat
# cell runs them: D, the expert width, the experts held here of the
# router's, top-k; one client, B 96, at the image and the text length
MOE_D, MOE_F, MOE_HELD, MOE_ROUTER, MOE_K, MOE_B = 2048, 1408, 8, 64, 6, 96


def _moe_library(xp, ws, po, dy=None, h=None, g=None, u=None):
    """bf16 ``torch.matmul`` a group over the same buffer: the forward's
    three products and the SiLU-mul, or (given ``dy`` and the forward's
    ``h``, ``g``, ``u``) the backward's five products and its SiLU-mul
    backward."""
    import torch
    wg, wu, wd = ws
    outs = []
    for e in range(len(po) - 1):
        a, b = po[e], po[e + 1]
        x = xp[a:b]
        if dy is None:
            outs.append((torch.nn.functional.silu(x @ wg[e])
                         * (x @ wu[e])) @ wd[e])
            continue
        dh = dy[a:b] @ wd[e].T
        sig = torch.sigmoid(g[a:b])
        dg = dh * u[a:b] * sig * (1 + g[a:b] * (1 - sig))
        du = dh * g[a:b] * sig
        outs += [dg @ wg[e].T + du @ wu[e].T, x.T @ dg, x.T @ du,
                 h[a:b].T @ dy[a:b]]
    return outs


MOE_ROWS = ("moe_dispatch_fwd", "moe_combine_fwd", "moe_dispatch_bwd",
            "moe_combine_bwd")


def _moe_rows_library(name, t):
    """The same function in PyTorch over the live rows alone (``t``: the
    live rows' tokens ``tok``, weights ``wr`` and pairs ``rp``, a token
    row of zeros appended to ``xpad`` and ``dpad``): a gather, an
    ``index_add_`` or a gather and a row sum."""
    import torch
    T, D = t["x"].shape
    if name == "moe_dispatch_fwd":
        return t["xpad"][t["tok"]]
    if name == "moe_combine_fwd":
        return torch.zeros(T + 1, D, device=t["x"].device).index_add_(
            0, t["tok"], t["yl"].float() * t["wr"][:, None])
    if name == "moe_dispatch_bwd":
        return torch.zeros(T + 1, D, device=t["x"].device).index_add_(
            0, t["tok"], t["dl"].float()).bfloat16()
    d = t["dpad"][t["tok"]]
    dw = torch.zeros(t["P"] + 1, device=d.device).index_copy_(
        0, t["rp"], (t["yl"].float() * d).sum(-1))
    return (d * t["wr"][:, None]).bfloat16(), dw


def _check_moe_rows(plan, x, gen, dev):
    """The dispatch and combine row kernels (``csrc/moe_rows.cu``) at one
    step of the cell against their plain versions: xp, the combine, dx and
    dyp bit for bit on rows ``[0, poff[G])``, dw within 1e-5 of its norm;
    the padding rows of xp and dyp zero; ``yp`` and ``dxp`` NaN past
    ``poff[G]`` (nothing there is read); a second call's bits; one
    ``moe_fused`` count a call.  Timed beside the plain version, the live
    rows' PyTorch sequence (``_moe_rows_library``) and the bound on the
    bytes the live rows need (counted on the card): each input byte read
    once, each output byte written once."""
    import torch
    from fedcola_tpu_torch.ops import kernels, moe_gemm
    from fedcola_tpu_torch.utils import profiling
    T, D = x.shape
    k, cap, P = plan.k, plan.cap, plan.pair_row.numel()
    L = int(plan.poff[-1])
    held = plan.pair_row.view(T, k) < cap
    R, U = int(held.sum()), int(held.any(1).sum())
    live = plan.row_pair[:L] < P
    pad = ~live
    yp = torch.randn(cap, D, generator=gen, device=dev).bfloat16()
    dxp = torch.randn(cap, D, generator=gen, device=dev).bfloat16()
    yp[L:] = float("nan")
    dxp[L:] = float("nan")
    w = torch.rand(T, k, generator=gen, device=dev) + 0.05
    dout = torch.randn(T, D, generator=gen, device=dev)
    pr, rp, po = plan.pair_row, plan.row_pair, plan.poff
    calls = {
        "moe_dispatch_fwd": (moe_gemm.dispatch_kernel,
                             moe_gemm.dispatch_plain, (x, pr, rp, po, k)),
        "moe_combine_fwd": (moe_gemm.combine_kernel, moe_gemm.combine_plain,
                            (yp, w, pr, k)),
        "moe_dispatch_bwd": (moe_gemm.dispatch_bwd_kernel,
                             moe_gemm.dispatch_bwd_plain, (dxp, pr, k)),
        "moe_combine_bwd": (moe_gemm.combine_bwd_kernel,
                            moe_gemm.combine_bwd_plain,
                            (dout, yp, w, pr, rp, po, k))}
    tok = torch.where(live, rp[:L] // k, torch.full_like(rp[:L], T))
    lib = dict(x=x, xpad=torch.cat([x, x.new_zeros(1, D)]), tok=tok,
               wr=torch.cat([w.reshape(P), w.new_zeros(1)])[rp[:L]],
               rp=rp[:L], yl=yp[:L], dl=dxp[:L], P=P,
               dpad=torch.cat([dout, dout.new_zeros(1, D)]))
    nbytes = {
        "moe_dispatch_fwd": U * D * 2 + L * 8 + L * D * 2,
        "moe_combine_fwd": R * D * 2 + P * 12 + T * D * 4,
        "moe_dispatch_bwd": R * D * 2 + P * 8 + T * D * 2,
        "moe_combine_bwd": U * D * 4 + R * D * 2 + P * 12 + L * 8
        + L * D * 2 + P * 4}
    flops = {"moe_dispatch_fwd": 0.0, "moe_combine_fwd": 2.0 * R * D,
             "moe_dispatch_bwd": 1.0 * R * D,
             "moe_combine_bwd": 3.0 * R * D}
    # the outputs that are the buffer: only rows [0, poff[G]) are written
    buffer_out = {"moe_dispatch_fwd": 0, "moe_combine_bwd": 0}

    def trim(out):
        out = list(out) if isinstance(out, tuple) else [out]
        return [t[:L] if t.shape[0] == cap else t for t in out]

    res = {}
    for name, (kern, plain, args) in calls.items():
        timer = profiling.Timer()
        before = kernels.LAUNCHES[name]
        with timer.recording():
            got = trim(kern(*args))
        if timer.counters.get("moe_fused") != 1 or \
                kernels.LAUNCHES[name] != before + 1:
            raise AssertionError(f"{name}: moe_fused "
                                 f"{timer.counters.get('moe_fused')}, "
                                 f"launches {kernels.LAUNCHES[name]}")
        want = trim(plain(*args))
        if name in buffer_out and (got[buffer_out[name]][pad] != 0).any():
            raise AssertionError(f"{name}: a padding row is not zero")
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if name == "moe_combine_bwd" and i == 1:
                rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
                if not rel <= 1e-5:
                    raise AssertionError(f"{name}: dw differs by {rel:.3e} "
                                         f"of its norm")
                err = (a - b).abs().max().item()
            elif not torch.equal(a, b):
                raise AssertionError(f"{name}: output {i} differs from the "
                                     f"plain version's bits")
        _same_bits(lambda *a: trim(kern(*a)), args, got, name)
        res[name] = dict(
            max_abs_err=err, flops=flops[name], bytes=nbytes[name],
            ms=time_ms(lambda: kern(*args)),
            plain_ms=time_ms(lambda: plain(*args), iters=3, warmup=1),
            library_ms=time_ms(lambda: _moe_rows_library(name, lib)))
    log(f"[kernels] moe rows: {T} tokens, {U} with a held expert, {R} "
        f"routed rows, {L} buffer rows of {cap}")
    return res


def check_moe(dev, record):
    """The routed experts' grouped GEMM (``fc_moe_gemm_fwd`` /
    ``fc_moe_gemm_bwd``, csrc/moe_gemm.cu) at the moonlight cell's two
    step shapes (``MOE_*``: one client's image step, 96 x 197 tokens, and
    text step, 96 x 40), a routing drawn at random (top-6 of 64, about
    0.75 held experts a token): the forward (y, h and the kept g, u) and
    the backward (dX and the three per-expert dW) against the plain
    versions on the same bf16 buffer and weights, y in bfloat16 (the
    line's) and at the text step in float32 too, every output within
    ``_compare``'s bf16 tolerance; a second call gives the same bits.
    Both bf16 steps timed beside the plain version, a bf16
    ``torch.matmul`` sequence a group (``_moe_library``) and the bound on
    the rows routed (forward 6 R D F operations, backward 12 R D F).
    Then the dispatch and combine row kernels at the same steps
    (``_check_moe_rows``).  Returns the image step's measurements, the text
    step's under "text"."""
    import torch
    from fedcola_tpu_torch.ops import moe_gemm
    D, Fh, held = MOE_D, MOE_F, MOE_HELD
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    for step, N in (("img", 197), ("txt", 40)):
        T = MOE_B * N
        idx = torch.rand(1, T, MOE_ROUTER, generator=gen,
                         device=dev).topk(MOE_K, -1).indices
        plan = moe_gemm.route_plan(idx, 0, held)
        x = torch.randn(T, D, generator=gen, device=dev).bfloat16()
        xp = moe_gemm.dispatch(x, plan)
        ws = [(torch.randn(held, a, b, generator=gen, device=dev)
               * a ** -0.5).bfloat16() for a, b in ((D, Fh), (D, Fh),
                                                    (Fh, D))]
        po = plan.poff.tolist()
        live = po[-1]

        def rows(ts, live=live, cap=plan.cap):
            # the buffer's rows past the last group are left unwritten
            return [t[:live] if t.shape[0] == cap else t for t in ts]
        dy = torch.zeros(plan.cap, D, device=dev, dtype=torch.bfloat16)
        dy[:live] = torch.randn(live, D, generator=gen,
                                device=dev).bfloat16()
        R = int(plan.counts.sum())
        res = {}
        for out_dtype in ((torch.bfloat16, torch.float32) if step == "txt"
                          else (torch.bfloat16,)):
            fargs = (xp, *ws, plan.poff, True, out_dtype)
            got = moe_gemm.glu_fwd_kernel(*fargs)
            ref = moe_gemm.glu_fwd_plain(*fargs)
            err = _compare(rows(got), rows(ref), torch.bfloat16,
                           ("y", "h", "g", "u"))
            _same_bits(lambda *a: rows(moe_gemm.glu_fwd_kernel(*a)), fargs,
                       rows(got), "moe_gemm_fwd")
            res.setdefault("moe_gemm_fwd", {"max_abs_err": 0.0})
            res["moe_gemm_fwd"]["max_abs_err"] = max(
                res["moe_gemm_fwd"]["max_abs_err"], err)
        _, h, g, u = got = moe_gemm.glu_fwd_kernel(xp, *ws, plan.poff, True,
                                                   torch.bfloat16)
        bargs = (dy, xp, *ws, g, u, plan.poff)
        gotb = moe_gemm.glu_bwd_kernel(*bargs)
        refb = moe_gemm.glu_bwd_plain(*bargs)
        err = _compare(rows(gotb), rows(refb), torch.bfloat16,
                       ("dx", "dwg", "dwu", "dwd"))
        _same_bits(lambda *a: rows(moe_gemm.glu_bwd_kernel(*a)), bargs,
                   rows(gotb), "moe_gemm_bwd")
        res["moe_gemm_bwd"] = {"max_abs_err": err}
        del got, ref, gotb, refb
        w_bytes = 3 * held * D * Fh * 2
        f = res["moe_gemm_fwd"]
        f.update(flops=6.0 * R * D * Fh,
                 bytes=w_bytes + 2 * R * D * 2 + 3 * R * Fh * 2,
                 ms=time_ms(lambda: moe_gemm.glu_fwd_kernel(
                     xp, *ws, plan.poff, True, torch.bfloat16)),
                 plain_ms=time_ms(lambda: moe_gemm.glu_fwd_plain(
                     xp, *ws, plan.poff, True, torch.bfloat16), iters=3,
                     warmup=1),
                 library_ms=time_ms(lambda: _moe_library(xp, ws, po)))
        b = res["moe_gemm_bwd"]
        b.update(flops=12.0 * R * D * Fh,
                 bytes=3 * w_bytes + 3 * R * D * 2 + 5 * R * Fh * 2,
                 ms=time_ms(lambda: moe_gemm.glu_bwd_kernel(*bargs)),
                 plain_ms=time_ms(lambda: moe_gemm.glu_bwd_plain(*bargs),
                                  iters=3, warmup=1),
                 library_ms=time_ms(lambda: _moe_library(
                     xp, ws, po, dy, h, g, u)))
        record(res, f"{step},n=1", torch.bfloat16, N, True)
        log(f"[kernels] moe_gemm {step} step: {T} tokens, routed rows {R} "
            f"({R / T:.3f} a token), buffer rows {live} of {plan.cap}")
        rows_res = _check_moe_rows(plan, x, gen, dev)
        record(rows_res, f"{step},n=1", torch.bfloat16, N, True)
        res.update(rows_res)
        for name, r in res.items():
            if step == "img":
                out[name] = r
            else:
                out[name]["text"] = {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        del xp, ws, dy, h, g, u, bargs
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- model ----

def _model_grads(cfg, params, inputs, dev):
    """Features and every leaf gradient of one training forward on ``dev``
    (DropPath draws from a generator seeded alike on every run)."""
    import torch
    from fedcola_tpu_torch.models import mat
    p = mat.tree_map(lambda a: a.detach().to(dev).requires_grad_(True),
                     params)
    fi, ft = mat.mat_apply(cfg, p, [a.to(dev) for a in inputs],
                           feat_out=True, train=True,
                           gen=torch.Generator(dev).manual_seed(0))
    loss = (fi * ft).sum() + fi.square().sum()
    grads = torch.autograd.grad(loss, mat.tree_leaves(p))
    return [fi.detach().cpu(), ft.detach().cpu()], [g.cpu() for g in grads]


def _agree_model(got, ref, what):
    """Features within 1e-4, every gradient within 1e-4 * max(1, max|ref|);
    returns the worst scaled gradient error."""
    for a, b in zip(got[0], ref[0]):
        d = (a - b).abs().max().item()
        assert d <= 1e-4, f"{what}: features differ by {d:.3e}"
    worst = 0.0
    for a, b in zip(got[1], ref[1]):
        d = (a - b).abs().max().item()
        m = b.abs().max().item()
        assert d <= 1e-4 * max(1.0, m), \
            f"{what}: gradient differs: {d:.3e} ({m:.3e})"
        worst = max(worst, d / max(1.0, m))
    return worst


def phase_model():
    """MAT forward + backward on the card (kernels) against the CPU (plain
    versions), small float32 multimodal models with colearn tying: the
    fused route (D=128) and the flash route (D=96, off the 128 grid).  Then
    the remat policies against each other on the card (D=128, DropPath
    on)."""
    import numpy as np
    import torch
    from fedcola_tpu_torch.models import mat
    from fedcola_tpu_torch.ops import kernels
    r = np.random.RandomState(0)
    inputs = [torch.from_numpy(r.randn(4, 64, 64, 3).astype(np.float32)),
              torch.from_numpy(r.randint(0, 50, (4, 12)).astype(np.int64))]
    base = mat.MATConfig(modalities=("img", "txt"), tasks=("rtv", "rtv"),
                         num_classes=(None, None), img_size=64, patch_size=16,
                         embed_dim=128, depth=2, num_heads=2, vocab_size=50,
                         max_text_len=12, colearn_param="attn",
                         use_fused_mlp=True, compute_dtype="float32")
    for route, cfg, used in (
            ("fused", base, ("attn_bwd", "mlp_bwd")),
            ("flash", base.replace(embed_dim=96), ("flash_fwd", "flash_bwd"))):
        params = mat.init_mat(cfg, torch.Generator().manual_seed(0))
        ref = _model_grads(cfg, params, inputs, "cpu")
        kernels.reset_launches()
        got = _model_grads(cfg, params, inputs, "cuda")
        assert all(kernels.LAUNCHES[k] > 0 for k in used), kernels.LAUNCHES
        worst = _agree_model(got, ref, route)
        log(f"[model] {route} route (D={cfg.embed_dim}) card vs CPU: "
            f"features and {len(ref[1])} gradients agree (worst scaled "
            f"gradient error {worst:.3e})")
    cfg = base.replace(drop_path_rate=0.2)
    params = mat.init_mat(cfg, torch.Generator().manual_seed(1))
    ref = _model_grads(cfg, params, inputs, "cuda")
    for policy in ("save_attn", "full"):
        kernels.reset_launches()
        got = _model_grads(cfg.replace(remat_policy=policy), params, inputs,
                           "cuda")
        assert kernels.LAUNCHES["attn_bwd_recompute"] > 0 and \
            kernels.LAUNCHES["mlp_bwd_nores"] > 0, kernels.LAUNCHES
        worst = _agree_model(got, ref, policy)
        log(f"[model] remat {policy!r} vs 'kernel' on the card: features "
            f"and {len(ref[1])} gradients agree (worst scaled gradient "
            f"error {worst:.3e})")


# ------------------------------------------------------ main and tiny ----

def run_line(tag: str, flags, resident: bool = True):
    """The rounds of a coco.sh line through the port's entry point; returns
    the launch counts of that run and the server.  With ``resident``, every
    group must have trained on the resident plane (its train set staged on
    the card)."""
    with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as out:
        return _run_line(tag, flags, out, resident)


def _run_line(tag, flags, out, resident):
    import math
    import torch
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.ops import kernels
    argv = list(flags) + ["--result_path", os.path.join(out, "result"),
                          "--log_path", os.path.join(out, "log")]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    server = port_main.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    if resident:
        host_fed = [ds for ds in server.cfg.client_datasets
                    if server._resident_cache.get(ds) is None]
        if host_fed:
            raise AssertionError(f"[{tag}] groups not resident: {host_fed}")
    for r in sorted(server.results):
        res = server.results[r]
        loss = res["clients_updated_summary"]["loss"]["avg"]
        if not math.isfinite(loss):
            raise AssertionError(f"round {r}: non-finite training loss {loss}")
        acc = {k[len("server_evaluated_"):]: v["metrics"]["acc1"]
               for k, v in res.items() if k.startswith("server_evaluated_")
               and "metrics" in v}
        r1 = {k[len("server_evaluated_"):]: v
              for k, v in res.items() if k.startswith("server_evaluated_")
              and "metrics" not in v}
        r1 = {k: v[f"{k} r@1sum"] for k, v in r1.items()}
        sections = {k: round(v, 3) for k, v in res["round_sections"].items()}
        log(f"[{tag}] round {r}: loss {loss:.4f} acc1 {acc} r@1sum {r1} "
            f"round_seconds {res['round_seconds']:.3f} "
            f"eval_seconds {res.get('eval_seconds', float('nan')):.3f} "
            f"round_sections {sections}")
    staged = {k: v is not None for k, v in server._resident_cache.items()}
    log(f"[{tag}] wall {wall:.1f}s, staged {server._resident_bytes / 1e6:.1f}"
        f" MB {staged}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return launches, server


def phase_main():
    """The mome_small line: the four fused kernels of the first slice."""
    from fedcola_tpu_torch import main as port_main
    loss_bound("main", port_main.MAIN_PATH_FLAGS)
    launches, server = run_line("main", port_main.MAIN_PATH_FLAGS)
    missing = [k for k in ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return launches, server.results, _global_weights(server)


def phase_tiny():
    """The mome_tiny line: attention through the flash kernels only."""
    from fedcola_tpu_torch import main as port_main
    loss_bound("tiny", port_main.MOME_TINY_FLAGS)
    launches, _ = run_line("tiny", port_main.MOME_TINY_FLAGS)
    if not (launches["flash_fwd"] and launches["flash_bwd"]
            and launches["opt_update"]):
        raise AssertionError(f"mome_tiny never launched flash or the "
                             f"optimizer step: {launches}")
    fused = {k: v for k, v in launches.items()
             if v and k.startswith(("attn", "mlp"))}
    if fused:
        raise AssertionError(f"mome_tiny launched fused kernels: {fused}")
    return launches


# the coco.sh FedCola line of [main] at mome_moonlight_a3b (the
# coco-pop1.moonlight_a3b_mat cell's model: about 1 B parameters a
# dataset), one client of each dataset, one round, no dropout (the cell's)
MOONLIGHT_FLAGS_CUT = {"--model_name": "mome_moonlight_a3b", "--Cs": "0.25",
                       "--R": "1", "--dropout": None}


def phase_moonlight():
    """One round of [main]'s line at mome_moonlight_a3b through the entry
    point: the routed experts on the grouped GEMM (both entry points
    launch), every dispatch and combine pass on its row kernel (the four
    launch, as many as the rounds' ``moe_fused``), the optimizer step on
    its kernel, no fused attention or MLP kernel (MLA runs on SDPA, the
    dense and shared experts on cuBLAS)."""
    from fedcola_tpu_torch import main as port_main
    launches, server = run_line("moonlight", port_main.cut(
        port_main.MAIN_PATH_FLAGS, MOONLIGHT_FLAGS_CUT))
    if not (launches["moe_gemm_fwd"] and launches["moe_gemm_bwd"]
            and launches["opt_update"]):
        raise AssertionError(f"the moonlight line never launched the "
                             f"grouped GEMM or the optimizer step: "
                             f"{launches}")
    # every dispatch and combine pass took its row kernel: the rounds'
    # moe_fused counts them, and no pass ran outside a round
    rows = sum(launches[k] for k in MOE_ROWS)
    fused = sum(r["round_counters"].get("moe_fused", 0)
                for r in server.results.values())
    log(f"[moonlight] row kernel launches {rows} "
        f"({', '.join(f'{k} {launches[k]}' for k in MOE_ROWS)}), "
        f"moe_fused {fused}")
    if not all(launches[k] for k in MOE_ROWS) or fused != rows:
        raise AssertionError(f"the moonlight line's dispatch and combine: "
                             f"{rows} row kernel launches, moe_fused "
                             f"{fused}")
    fused = {k: v for k, v in launches.items()
             if v and k.startswith(("attn", "mlp", "flash"))}
    if fused:
        raise AssertionError(f"the moonlight line launched {fused}")
    return launches


def _creamfl_bound_flags():
    """[baselines]' CreamFL bound: 20 public pairs on both devices (the CPU
    side over 500 pairs at depth 12 would take minutes), in one batch: each
    public and distillation step is one more AdamW step whose rounding the
    round-2 loss carries, and five a pass (batches of 4) took it past the
    bound."""
    from fedcola_tpu_torch import main as port_main
    return port_main.CREAMFL_FLAGS + ("--num_pub_samples", "20",
                                      "--pub_batch_size", "20")


def phase_baselines():
    """The coco.sh baselines beside FedCola (FedIoT, FedProx, CreamFL) and
    the FedAdam line, each through the four fused training kernels; the
    loss bound of the FedProx and the CreamFL line.  Returns the launch
    counts of the four runs together, and the CreamFL run's results and
    final weights ([creamfl-mesh] reads its runs against them)."""
    from fedcola_tpu_torch import main as port_main
    loss_bound("fedprox", port_main.FEDPROX_FLAGS)
    loss_bound("creamfl", _creamfl_bound_flags())
    total = {}
    for tag, flags in (("fediot", port_main.FEDIOT_FLAGS),
                       ("fedprox", port_main.FEDPROX_FLAGS),
                       ("creamfl", port_main.CREAMFL_FLAGS),
                       ("fedadam", port_main.FEDADAM_FLAGS)):
        launches, server = run_line(tag, flags)
        missing = [k for k in ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
                   if launches[k] == 0]
        if missing:
            raise AssertionError(f"{tag} never launched {missing}")
        if tag == "creamfl":
            if server._pub_host_logged:
                raise AssertionError("creamfl: the public set was host-fed")
            creamfl = (server.results, _global_weights(server))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total, creamfl


# ------------------------------------------------------ resident plane ----

def phase_resident(resident_results):
    """[main] again with ``FEDCOLA_RESIDENT_BUDGET=0`` (every group and
    test set fed from the host), against [main]'s resident run in this
    process: the same batches, generator draws and kernels, so each round's
    training loss and every eval result must be bitwise equal.  Prints both
    runs' ``round_seconds`` and ``eval_seconds``."""
    from fedcola_tpu_torch import main as port_main
    os.environ["FEDCOLA_RESIDENT_BUDGET"] = "0"
    try:
        launches, server = run_line("resident", port_main.MAIN_PATH_FLAGS,
                                    resident=False)
    finally:
        del os.environ["FEDCOLA_RESIDENT_BUDGET"]
    if any(v is not None for v in server._resident_cache.values()):
        raise AssertionError("budget 0 staged a dataset")
    for r in sorted(resident_results):
        a, b = resident_results[r], server.results[r]
        keys = ["clients_updated_summary"] + sorted(
            k for k in a if k.startswith("server_evaluated_"))
        diff = [k for k in keys if a[k] != b.get(k)]
        log(f"[resident] round {r}: round_seconds resident "
            f"{a['round_seconds']:.3f} host-fed {b['round_seconds']:.3f}, "
            f"eval_seconds resident {a['eval_seconds']:.3f} host-fed "
            f"{b['eval_seconds']:.3f}; {len(keys)} results compared, "
            f"unequal: {diff}")
        if diff:
            raise AssertionError(f"round {r}: resident and host-fed runs "
                                 f"differ in {diff}")
    return launches


RETRIEVAL_IMAGES = 1000     # unique 224 px images, 5 captions each


def phase_retrieval():
    """COCO retrieval eval at mome_small on an in-memory COCO-shaped test
    set of ``RETRIEVAL_IMAGES`` unique images (a deduplicated store and its
    caption -> image row map on a TaskDataset, no image files): the
    unique-image split (the image tower once per unique image) against the
    joint per-row forward (``FEDCOLA_EVAL_UNIQUE_IMAGES=0``): features
    within the bf16 gate (3e-2 of max|ref|), the 5k and the 1k (n-fold)
    recalls within one image or caption per direction; both times."""
    import numpy as np
    import torch
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.data.datasets import TaskDataset
    from fedcola_tpu_torch.eval import retrieval
    from fedcola_tpu_torch.models.mat import tree_map
    from fedcola_tpu_torch.models.registry import create_model
    from fedcola_tpu_torch.parallel.client_update import GroupSpec
    cfg = parse_args(list(port_main.MAIN_PATH_FLAGS))
    mcfg, params = create_model(cfg.model_name, cfg, "Coco",
                                torch.Generator().manual_seed(cfg.seed))
    params = tree_map(lambda a: a.cuda(), params)
    n_img, px = RETRIEVAL_IMAGES, mcfg.img_size
    n = 5 * n_img
    r = np.random.RandomState(0)
    row = np.arange(n) // 5
    test = TaskDataset(
        name="Coco", task="rtv", modality="img+txt", num_classes=None, n=n,
        texts=r.randint(5, mcfg.vocab_size, (n, mcfg.max_text_len))
        .astype(np.int32), image_ids=row, ann_ids=np.arange(n),
        image_size=px,
        _image_store=r.randint(0, 256, (n_img, px, px, 3), np.uint8),
        _image_row=row)
    resident = {"img_store": torch.from_numpy(test._image_store).cuda(),
                "img_row": torch.from_numpy(row.astype(np.int32)).cuda(),
                "txt": torch.from_numpy(test.texts).cuda()}
    spec = GroupSpec(modality="img+txt", criterion="ContrastiveLoss",
                     imnorm=True)
    args = (mcfg, spec, params, test, cfg.eval_batch_size)
    out = {}
    for tag, unique in (("split", "1"), ("joint", "0")):
        os.environ["FEDCOLA_EVAL_UNIQUE_IMAGES"] = unique
        try:
            retrieval.extract_features(*args, np.random.RandomState(1),
                                       resident)      # warm-up
            torch.cuda.synchronize()
            t0 = time.time()
            feats = retrieval.extract_features(
                *args, np.random.RandomState(1), resident)
            torch.cuda.synchronize()
            secs = time.time() - t0
            scores = retrieval.evaluate(*args, rng=np.random.RandomState(1),
                                        resident=resident)
        finally:
            del os.environ["FEDCOLA_EVAL_UNIQUE_IMAGES"]
        out[tag] = feats, scores, secs
    (fs, ss, ts), (fj, sj, tj) = out["split"], out["joint"]
    worst = 0.0
    for name, a, b in (("image", fs[0], fj[0]), ("caption", fs[1], fj[1])):
        d = (a - b).abs().max().item() / b.abs().max().item()
        worst = max(worst, d)
        if not (a.shape == b.shape and d <= 3e-2):
            raise AssertionError(f"{name} features: split vs joint {d:.3e} "
                                 f"of max|ref| (shapes {a.shape}, {b.shape})")
    for a, b in zip(fs[2:], fj[2:]):
        if not np.array_equal(a, b):
            raise AssertionError("split and joint class vectors differ")
    per_fold = n_img // 5
    for block, imgs in ((None, n_img), ("n_fold", per_fold)):
        a = ss[block] if block else ss
        b = sj[block] if block else sj
        for d, q in (("i2t", imgs), ("t2i", 5 * imgs)):
            for k in ("recall_1", "recall_5", "recall_10"):
                if abs(a[d][k] - b[d][k]) > 1.0 / q + 1e-9:
                    raise AssertionError(
                        f"{block or '5k'} {d} {k}: split {a[d][k]} vs "
                        f"joint {b[d][k]}")
    log(f"[retrieval] {n_img} unique images, {n} captions: features split "
        f"vs joint max|d| / max|ref| {worst:.3e}; 5k r@1 i2t/t2i split "
        f"{ss['i2t']['recall_1']:.4f}/{ss['t2i']['recall_1']:.4f} joint "
        f"{sj['i2t']['recall_1']:.4f}/{sj['t2i']['recall_1']:.4f}; "
        f"extraction {ts:.3f}s split, {tj:.3f}s joint")


def phase_local():
    """One round of the FedCola line with ``--eval_type both --test_size
    0.2``: every client of the eval cohort evaluates the global model on
    its holdout, on the resident plane, a dataset's clients in one pass a
    step.  ``clients_evaluated_out`` must be there and finite."""
    import math
    from fedcola_tpu_torch import main as port_main
    launches, server = run_line("local", port_main.MAIN_PATH_FLAGS + (
        "--eval_type", "both", "--test_size", "0.2", "--R", "1"))
    res = server.results[1]
    out = res.get("clients_evaluated_out")
    if not out or not all(math.isfinite(v) for m in out.values()
                          for v in m.values()):
        raise AssertionError(f"clients_evaluated_out: {out}")
    log(f"[local] {out['loss']} acc1 {out.get('acc1')}; local eval "
        f"{res['local_eval_seconds']:.3f}s, central eval "
        f"{res['eval_seconds']:.3f}s")
    if not (launches["attn_fwd"] and launches["mlp_fwd"]):
        raise AssertionError(f"[local] no forward kernel: {launches}")
    return launches


def phase_augment():
    """One round of the FedCola line with ``--crop 224 --randhf 0.5``: crop
    and flips run on the card inside the resident gather, so every group
    stays resident; the loss is finite.  And the augmentation's apply on
    the card against the same call on the CPU with the same draws, on
    CIFAR-sized images resized to 224 (within 1 uint8 level) and on 224 px
    images (equal)."""
    import math
    import torch
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.parallel import client_update as cu
    flags = port_main.MAIN_PATH_FLAGS
    c = int(flags[flags.index("--resize") + 1])      # 224: the model's input
    launches, server = run_line("augment", flags + (
        "--crop", str(c), "--randhf", "0.5", "--R", "1"))
    spec, _, _ = server._group_aug_plan("CIFAR100",
                                        server._group_spec("CIFAR100"))
    if not (spec.device_aug and spec.aug_crop == c):
        raise AssertionError(f"augmentation not on the card: {spec}")
    loss = server.results[1]["clients_updated_summary"]["loss"]["avg"]
    if not math.isfinite(loss):
        raise AssertionError(f"[augment] non-finite loss {loss}")
    gen = torch.Generator("cuda").manual_seed(0)
    B = 2 * server.cfg.B
    for size, resize, tol in ((32, c, 1), (c, None, 0)):
        x = torch.randint(0, 256, (B, size, size, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        d = cu.draw_augment(B, (size, size), c, 0.5, 0.5, resize, gen)
        got = cu.apply_augment(x, d, c, resize)
        cpu = cu.AugDraws(*(t.cpu() for t in (d.ys, d.xs, d.hflip,
                                              d.vflip)))
        ref = cu.apply_augment(x.cpu(), cpu, c, resize)
        err = (got.cpu().int() - ref.int()).abs().max().item()
        log(f"[augment] apply on the card vs the CPU, {B} images {size} px "
            f"-> {c}: max |d| {err} levels (bound {tol})")
        if err > tol:
            raise AssertionError(f"device_augment card vs CPU: {err}")
    return launches


# ------------------------------------------------------------ fixtures ----

# scripts/evidence_pretrained.sh's sizes: Coco (train / test images, px),
# CIFAR100 and AG_NEWS (train / test rows)
FIXTURE_COCO = (1000, 250, 224)
FIXTURE_CIFAR = (4800, 1000)
FIXTURE_AGNEWS = (4800, 1000)
FIXTURE_TRAINING_KERNELS = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")


def _write_fixture_line(d):
    """The fixtures and the ViT-small checkpoint of [fixtures] under ``d``
    (seeded writers: the same bytes wherever they are written) and the
    coco.sh line on them; ``FEDCOLA_PRETRAIN_<SRC>`` set to the checkpoint.
    Returns the flags, the checkpoint, that variable's name and the
    seconds writing took (data, checkpoint)."""
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.data import fixtures
    from fedcola_tpu_torch.models.pretrained import write_timm_vit_checkpoint
    from fedcola_tpu_torch.models.registry import MODEL_SIZES
    t0 = time.time()
    coco = fixtures.coco_fixture(os.path.join(d, "coco"), *FIXTURE_COCO)
    cifar = fixtures.cifar100_fixture(os.path.join(d, "cifar"),
                                      *FIXTURE_CIFAR)
    agnews = fixtures.agnews_fixture(os.path.join(d, "agnews"),
                                     *FIXTURE_AGNEWS)
    t_data = time.time() - t0
    D, depth, _, src, px = MODEL_SIZES["mome_small_patch16"]
    ckpt = write_timm_vit_checkpoint(
        os.path.join(d, f"{src}.npz"), D, depth, img_size=px, seed=5)
    env = f"FEDCOLA_PRETRAIN_{src.upper()}"
    os.environ[env] = ckpt
    return (port_main.fixture_flags(coco, cifar, agnews), ckpt, env, t_data,
            time.time() - t0 - t_data)


def phase_fixtures():
    """The coco.sh FedCola line with its own data flags
    (``main.fixture_flags``: ``--pretrained --use_bert_tokenizer`` and
    path-backed ``--data_paths``) on fixtures written here by the port's
    writers, and a timm-layout ViT-small checkpoint written here too
    (``FEDCOLA_PRETRAIN_VIT_SMALL_PATCH16_224``).  ``loss_bound`` card
    against CPU, then three rounds with ``--profile_every 3`` (round 3
    traced).  Requires: every group resident, the four training kernels
    launched, captions on the native encoder, the image towers equal to the
    checkpoint at init and moved off it by training, Coco staged as a
    deduplicated image store (train and test, so retrieval takes the
    unique-image split), each ``<ds>.pt`` loading with ``weights_only`` and
    mapping back to the final global weights bit for bit, and a trace that
    names the kernel wrappers' ``fc_*`` ranges."""
    import numpy as np
    import torch
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.data.loaders import load_federated_data
    from fedcola_tpu_torch.models.mat import tree_leaves, tree_map
    from fedcola_tpu_torch.models.registry import MODEL_SIZES, create_model
    from fedcola_tpu_torch.models.torch_io import (from_torch_state_dict,
                                                   to_torch_state_dict)
    from fedcola_tpu_torch.native import tokenizer_fast
    with tempfile.TemporaryDirectory(prefix="fedcola_fixtures_") as d:
        flags, ckpt, env, t_data, t_ckpt = _write_fixture_line(d)
        depth = MODEL_SIZES["mome_small_patch16"][1]
        try:
            cfg = parse_args(list(flags))
            rows0 = tokenizer_fast.NATIVE_ROWS
            t0 = time.time()
            data = load_federated_data(cfg, np.random.RandomState(cfg.seed))
            t_load = time.time() - t0
            native = tokenizer_fast.NATIVE_ROWS - rows0
            log(f"[fixtures] written in {t_data:.1f}s (Coco {FIXTURE_COCO}, "
                f"CIFAR100 {FIXTURE_CIFAR}, AG_NEWS {FIXTURE_AGNEWS}), "
                f"checkpoint {os.path.getsize(ckpt) / 1e6:.1f} MB in "
                f"{t_ckpt:.1f}s; load + decode + tokenize {t_load:.1f}s, "
                f"{native} captions / rows on the native encoder")
            if native == 0:
                raise AssertionError("no text went through the native "
                                     "encoder")
            if data.server_eval["Coco"].image_paths is None:
                raise AssertionError("the Coco test set is not path-backed")
            with np.load(ckpt) as z:
                qkv = torch.from_numpy(np.stack(
                    [z[f"blocks.{j}.attn.qkv.weight"].T
                     for j in range(depth)]))
            for ds in ("CIFAR100", "Coco"):
                mcfg, params = create_model(
                    cfg.model_name, cfg, ds,
                    torch.Generator().manual_seed(cfg.seed))
                tower = params["blk"]["0"]["qkv_kernel"]
                if not torch.equal(tower, qkv):
                    raise AssertionError(f"{ds}: image tower is not the "
                                         f"checkpoint at init")
                if mcfg.has_aux and not torch.equal(
                        params["aux"]["qkv_aux"], qkv):
                    raise AssertionError(f"{ds}: aux not re-synced to the "
                                         f"loaded kernels")
            del data, params

            loss_bound("fixtures", flags)

            out = os.path.join(d, "run")
            rows0 = tokenizer_fast.NATIVE_ROWS
            launches, server = _run_line("fixtures", flags + (
                "--R", "3", "--profile_every", "3"), out, resident=True)
        finally:
            del os.environ[env]
        missing = [k for k in FIXTURE_TRAINING_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"[fixtures] never launched {missing}")
        if tokenizer_fast.NATIVE_ROWS == rows0:
            raise AssertionError("[fixtures] the run encoded no text on the "
                                 "native encoder")
        for key in ("Coco", "eval:Coco"):
            staged = server._resident_cache.get(key) or {}
            if "img_store" not in staged:
                raise AssertionError(f"[fixtures] {key} not staged as a "
                                     f"deduplicated image store: "
                                     f"{sorted(staged)}")
        n_test = server._resident_cache["eval:Coco"]["img_store"].shape[0]
        if n_test != FIXTURE_COCO[1]:
            raise AssertionError(f"[fixtures] {n_test} unique test images")
        for ds in ("CIFAR100", "Coco"):
            if torch.equal(server.global_params[ds]["blk"]["0"]
                           ["qkv_kernel"].cpu(), qkv):
                raise AssertionError(f"[fixtures] {ds} image tower never "
                                     f"moved off the checkpoint")
        ckpt_dir = os.path.join(out, "result", server.cfg.exp_name)
        for ds, params in server.global_params.items():
            sd = torch.load(os.path.join(ckpt_dir, f"{ds}.pt"),
                            map_location="cpu", weights_only=True)
            mcfg = server.model_cfgs[ds]
            back = from_torch_state_dict(
                mcfg, tree_map(torch.zeros_like, params), sd)
            if not all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(back), tree_leaves(params))):
                raise AssertionError(f"[fixtures] {ds}.pt does not map back "
                                     f"to the final global weights")
        torch.cuda.synchronize()
        t0 = time.time()
        for ds, params in server.global_params.items():
            torch.save(to_torch_state_dict(server.model_cfgs[ds], params),
                       os.path.join(d, f"export_{ds}.pt"))
        t_export = time.time() - t0
        pt_mb = sum(os.path.getsize(os.path.join(ckpt_dir, f"{ds}.pt"))
                    for ds in server.global_params) / 1e6
        trace = os.path.join(out, "log", "trace_round0003", "trace.json")
        with open(trace) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        wrappers = sorted(n for n in names if n.startswith("fc_"))
        log(f"[fixtures] .pt export {t_export:.2f}s ({pt_mb:.1f} MB, "
            f"{len(server.global_params)} files); round 3 traced (its "
            f"round_seconds include the profiler): "
            f"{os.path.getsize(trace) / 1e6:.1f} MB, ranges {wrappers}")
        if not {"fc_attn_fwd", "fc_mlp_fwd"} <= set(wrappers):
            raise AssertionError(f"[fixtures] the trace names no kernel "
                                 f"wrapper: {wrappers}")
    return launches


# ---------------------------------------------------- population, flickr ----

POPULATION_ROUNDS = 15
POPULATION_MIN_R1SUM = 1.0   # at round POPULATION_ROUNDS; chance is ~0.065
# the JAX package's run of this line on the same fixture (one TPU v5e; its
# Coco r@1sum a round is read beside the port's, a learning curve, no time)
POPULATION_REFERENCE = "docs/evidence/fedcola_100round_pathbacked_v5e.json"
FLICKR_FIXTURE = (200, 50, 224)     # Flickr30k train / test images, px
FLICKR_CLS = (1000, 200)            # CIFAR100 and AG_NEWS train / test rows


def _group_losses(server, res):
    """A round's average training loss of each dataset's sampled clients."""
    by_ds = {}
    for cid, m in res["clients_updated"].items():
        by_ds.setdefault(server.clients[int(cid)].dataset, []).append(
            m["loss"])
    return {ds: sum(v) / len(v) for ds, v in by_ds.items()}


def phase_population():
    """The scripts/coco.sh FedCola line at its own population and length
    (``main.POPULATION_FLAGS``: 12 + 12 + 8 clients, ``--Cs 0.25``, whole
    shards for ``--E 5`` epochs at B=96, no ``--debug``) for
    ``POPULATION_ROUNDS`` rounds, eval every round, at full mome_small
    width, bf16, remat 'kernel', resident: Coco path-backed on the
    ``coco_fixture(root, 1000, 250, 224)`` of the JAX package's 100-round
    run, CIFAR100 and AG_NEWS their synthetic stand-ins (no files under
    their roots), as in that run.  Prints every round's sections, each
    group's loss and Coco r@1sum beside the JAX run's.  Then
    ``loss_bound`` on the same line without ``--debug`` at a small
    population in float32 (``_population_bound_line``, ``LOSS_BOUND_F32``),
    its round-1 groups ragged, multi-chunk and ending on partial batches.
    Requires: every loss finite, r@1sum at the last round at least
    ``POPULATION_MIN_R1SUM`` and above round 5's, the bound, rows 1-4
    launched in both runs."""
    import math
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.data import fixtures
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, POPULATION_REFERENCE)) as f:
        jax_run = {int(r): v["server_evaluated_Coco"]["Coco r@1sum"]
                   for r, v in json.load(f).items()}
    with tempfile.TemporaryDirectory(prefix="fedcola_population_") as d:
        t0 = time.time()
        coco = fixtures.coco_fixture(os.path.join(d, "coco"), *FIXTURE_COCO)
        log(f"[population] Coco fixture {FIXTURE_COCO} written in "
            f"{time.time() - t0:.1f}s")
        flags = port_main.population_flags(
            coco, os.path.join(d, "no_cifar100"), os.path.join(d, "no_agnews"))
        launches, server = _run_line(
            "population", flags + ("--R", str(POPULATION_ROUNDS)),
            os.path.join(d, "run"), resident=True)
    r1 = {}
    for r in sorted(server.results):
        res = server.results[r]
        losses = _group_losses(server, res)
        r1[r] = res["server_evaluated_Coco"]["Coco r@1sum"]
        # _run_line has printed round_seconds, its sections, eval_seconds
        log(f"[population] round {r}: group losses "
            f"{ {k: round(v, 4) for k, v in losses.items()} }, Coco r@1sum "
            f"{r1[r]:.4f} (the JAX run: {jax_run[r]:.4f})")
        bad = [c for c, m in res["clients_updated"].items()
               if not math.isfinite(m["loss"])]
        if bad:
            raise AssertionError(f"[population] round {r}: non-finite "
                                 f"losses of clients {bad}")
    with tempfile.TemporaryDirectory(prefix="fedcola_population_") as d:
        rows, bound_launches = loss_bound("population",
                                          _population_bound_line(d))
    _full_epoch_shape("population", rows, LOSS_BOUND_B,
                      POPULATION_BOUND_CHUNK)
    missing = [k for k in FIXTURE_TRAINING_KERNELS if bound_launches[k] == 0]
    if missing:
        raise AssertionError(f"[population] bound: never launched {missing}")
    last = POPULATION_ROUNDS
    log(f"[population] launches of rows 1-4 (eval rows with 1 and 3): "
        f"{ {k: launches[k] for k in FIXTURE_TRAINING_KERNELS} }; staged "
        f"{server._resident_bytes / 1e6:.1f} MB")
    missing = [k for k in FIXTURE_TRAINING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[population] never launched {missing}")
    if not (r1[last] >= POPULATION_MIN_R1SUM and r1[last] > r1[5]):
        raise AssertionError(
            f"[population] Coco r@1sum {r1[last]} at round {last} (round 5: "
            f"{r1[5]}); required at least {POPULATION_MIN_R1SUM} and above "
            f"round 5's")
    return launches


# [population]'s loss bound: the line's own shape (whole shards for E
# epochs, no --debug) cut so that its CPU side fits the background worker:
# two clients a group, --E 2, chunks of two steps, and fixtures whose
# shards hold 5-15 rows, so that at LOSS_BOUND_B every round-1 group is
# ragged, runs past one chunk an epoch and ends its epochs on partial
# batches (its padded rows reach the kernels with no gradient).  In
# float32: at B=4 bf16 rounding alone moves a COCO client's contrastive
# loss by more than LOSS_BOUND, with or without padded rows (the bounds'
# per-client lines), so only float32 can tell an error in the padded rows
# from rounding
POPULATION_BOUND_COCO = (10, 4, 224)    # COCO train / test images, px
POPULATION_BOUND_CLS = (52, 8)          # CIFAR100 and AG_NEWS rows
POPULATION_BOUND_CHUNK = 2


def _population_bound_line(d):
    """The fixtures of [population]'s loss bound under ``d`` (seeded
    writers) and ``main.population_flags`` on them, cut as above."""
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.data import fixtures
    return port_main.cut(port_main.population_flags(
        fixtures.coco_fixture(os.path.join(d, "bound_coco"),
                              *POPULATION_BOUND_COCO),
        fixtures.cifar100_fixture(os.path.join(d, "bound_cifar"),
                                  *POPULATION_BOUND_CLS),
        fixtures.agnews_fixture(os.path.join(d, "bound_agnews"),
                                *POPULATION_BOUND_CLS)),
        {"--Ks": ("4", "4", "4"), "--Cs": "0.5", "--E": "2", "--R": "2",
         "--train_chunk_steps": str(POPULATION_BOUND_CHUNK),
         "--compute_dtype": "float32"})


def _full_epoch_shape(tag, rows, B, chunk):
    """Fails unless round 1's groups (``rows``: each dataset's sampled
    shards, in rows) are ragged in their steps an epoch at ``B``, some
    client runs more than ``chunk`` steps an epoch and some shard is not a
    multiple of ``B``."""
    steps = {ds: [-(-n // B) for n in v] for ds, v in rows.items()}
    log(f"[{tag}] bound: round 1 shards {rows} rows, {steps} steps an "
        f"epoch (B={B}, chunks of {chunk})")
    if not (all(len(set(v)) > 1 for v in steps.values())
            and max(max(v) for v in steps.values()) > chunk
            and any(n % B for v in rows.values() for n in v)):
        raise AssertionError(f"[{tag}] the bound's groups lost the full-"
                             f"epoch shape: {steps} steps an epoch")


def _write_flickr_line(d):
    """The fixtures of [flickr] under ``d`` (seeded writers) and the
    flickr.sh line on them, cut as ``main.fixture_flags`` cuts the coco.sh
    line: two clients a group, ``--E 1 --debug``, two rounds."""
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.data import fixtures
    return port_main.cut(port_main.flickr_flags(
        fixtures.flickr_fixture(os.path.join(d, "flickr"), *FLICKR_FIXTURE),
        os.path.join(d, "coco"),       # names the eval model; never read
        fixtures.cifar100_fixture(os.path.join(d, "cifar"), *FLICKR_CLS),
        fixtures.agnews_fixture(os.path.join(d, "agnews"), *FLICKR_CLS)),
        {"--Ks": ("4", "4", "4"), "--C": "0.5", "--E": "1", "--R": "2",
         "--debug": ()})


def phase_flickr():
    """The scripts/flickr.sh FedCola line (``main.FLICKR_FLAGS``: Flickr30k
    trains the img+txt clients at B=112, ``--C 0.25``) at mome_small width
    on fixtures written here, cut as [fixtures] cuts the coco.sh line
    (``--Ks 4 4 4 --C 0.5 --E 1 --debug --R 2``): ``loss_bound`` card
    against CPU, then two rounds: every group resident, rows 1-4 launched,
    Flickr30k's r@1sum finite."""
    import math
    with tempfile.TemporaryDirectory(prefix="fedcola_flickr_") as d:
        t0 = time.time()
        flags = _write_flickr_line(d)
        log(f"[flickr] fixtures written in {time.time() - t0:.1f}s "
            f"(Flickr30k {FLICKR_FIXTURE}, CIFAR100 / AG_NEWS {FLICKR_CLS})")
        loss_bound("flickr", flags)
        launches, server = _run_line("flickr", flags, os.path.join(d, "run"),
                                     resident=True)
    if server.cfg.B != 112 or "Flickr30k" not in server._resident_cache:
        raise AssertionError(f"[flickr] B {server.cfg.B}, staged "
                             f"{sorted(server._resident_cache)}")
    r1 = server.results[2]["server_evaluated_Flickr30k"]["Flickr30k r@1sum"]
    if not math.isfinite(r1):
        raise AssertionError(f"[flickr] Flickr30k r@1sum {r1}")
    missing = [k for k in FIXTURE_TRAINING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"[flickr] never launched {missing}")
    return launches


# ---------------------------------------------------------------- long ----

def _long_remat_step(flags):
    """One group update of the long line's text group (n=2 clients, one
    step of B=96 at N = 512) under remat 'save_attn', where the attention
    backward is row 5 (``fc_attn_bwd_recompute``) and the MLP's row 6.
    Returns the launch counts."""
    import math
    import numpy as np
    import torch
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.models.mat import stack_clients, tree_map
    from fedcola_tpu_torch.models.registry import create_model
    from fedcola_tpu_torch.ops import kernels
    from fedcola_tpu_torch.parallel.client_update import GroupSpec, run_chunk
    from fedcola_tpu_torch.parallel.optim import (init_opt_state,
                                                  make_optimizer_spec)
    cfg = parse_args(list(flags))
    mcfg, params = create_model(cfg.model_name, cfg, "MedicalAbstracts",
                                torch.Generator().manual_seed(cfg.seed))
    n, S, B = 2, 1, cfg.B
    r = np.random.RandomState(0)
    chunk = {"x": r.randint(0, mcfg.vocab_size,
                            (n, S, B, mcfg.max_text_len)).astype(np.int32),
             "y": r.randint(0, 5, (n, S, B)).astype(np.int64),
             "valid": np.ones((n, S, B), bool),
             "step_valid": np.ones((n, S), bool)}
    stacked = tree_map(lambda a: a.cuda().requires_grad_(True),
                       stack_clients(params, n))
    opt = make_optimizer_spec(cfg)
    state = init_opt_state(opt, stacked, n)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ls, _, _ = run_chunk(mcfg.replace(remat_policy="save_attn"),
                         GroupSpec(modality="txt",
                                   criterion="CrossEntropyLoss"),
                         opt, stacked, state, chunk, cfg.lr,
                         torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    losses = ls.float().cpu().flatten().tolist()
    log(f"[long] 'save_attn' group update at N={mcfg.max_text_len}: losses "
        f"{losses} in {time.time() - t0:.2f}s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[long] save_attn: non-finite loss {losses}")
    return launches


def phase_long():
    """The long-text line (``main.MEDABS_LONG_FLAGS``: the
    MedicalAbstracts line of scripts/evidence_medabstracts.sh at
    ``--seq_len 512``, mome_small at full width and depth, B=96): its loss
    bound, two rounds, one 'save_attn' group update, and one mome_tiny
    round of the same line (the flash route at N = 512).  Every attention
    launch here is at N = 512 (a text-only model at 512 tokens).  Returns
    the launch counts of the four runs together."""
    import math
    from fedcola_tpu_torch import main as port_main
    flags = port_main.MEDABS_LONG_FLAGS
    loss_bound("long", flags)
    launches, server = run_line("long", flags)
    mcfg = server.model_cfgs["MedicalAbstracts"]
    if mcfg.modalities != (None, "txt") or mcfg.max_text_len != LONG_N:
        raise AssertionError(f"[long] model {mcfg.modalities} at "
                             f"{mcfg.max_text_len} tokens")
    for r in sorted(server.results):
        m = server.results[r]["server_evaluated_MedicalAbstracts"]["metrics"]
        log(f"[long] round {r}: acc1 {m['acc1']} f1 {m['f1']}")
        if not all(math.isfinite(v) for v in (m["acc1"], m["f1"])):
            raise AssertionError(f"[long] round {r}: metrics {m}")
    total = dict(launches)
    for k, v in _long_remat_step(flags).items():
        total[k] += v
    tiny = tuple("mome_tiny_patch16" if prev == "--model_name" else
                 ("1" if prev == "--R" else flag)
                 for prev, flag in zip(("",) + flags, flags))
    tiny_launches, _ = run_line("long-tiny", tiny)
    fused = {k: v for k, v in tiny_launches.items()
             if v and k.startswith(("attn", "mlp"))}
    if fused:
        raise AssertionError(f"[long-tiny] launched fused kernels: {fused}")
    for k, v in tiny_launches.items():
        total[k] += v
    want = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd",
            "attn_bwd_recompute", "mlp_bwd_nores", "flash_fwd", "flash_bwd")
    log(f"[long] launches at N={LONG_N}: "
        f"{ {k: total[k] for k in want} }")
    missing = [k for k in want if not total[k]]
    if missing:
        raise AssertionError(f"[long] never launched {missing}")
    return total


# ---------------------------------------------------------------- mesh ----

MESH_TRAINING_KERNELS = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
# the Megatron route's kernels on the model axis: rows 11, 12, 3e, 6
TP_KERNELS = ("flash_fwd", "flash_bwd", "mlp_fwd", "mlp_bwd_nores")


def _global_weights(server) -> dict:
    """A server's global weights by (dataset, reference name), as its
    ``.npz`` checkpoint holds them."""
    from fedcola_tpu_torch.models import naming
    return {(ds, name): naming.get_by_path(p, path).detach().float().cpu()
            .numpy()
            for ds, p in server.global_params.items()
            for path, name in naming.param_names(server.model_cfgs[ds])}


def _npz_weights(result_dir, exp_name, datasets) -> dict:
    import numpy as np
    out = {}
    for ds in datasets:
        with np.load(os.path.join(result_dir, exp_name, f"{ds}.npz")) as z:
            out.update({(ds, k): z[k] for k in z.files
                        if not k.startswith("__")})
    return out


# Planted faults, each a program that patches the mesh and runs the entry
# point.  FAULT_FIRST_BLOCK: every rank keeps the first block of each draw
# (a rank past the first trains its clients with another client's DropPath
# masks), the bug the layout-free draws exist to prevent.
# FAULT_DROP_UPLOAD: the gathered uploads hold the first client's in place
# of every other (the other ranks' uploads dropped from aggregation).
FAULT_FIRST_BLOCK = """
import sys
from fedcola_tpu_torch.parallel import mesh
block = mesh.RankDraws.block
def first_block(self, full):
    k = self.clients.stop - self.clients.start
    return block(mesh.RankDraws(self.gen, self.n, self.B, slice(0, k),
                                self.batch), full)
mesh.RankDraws.block = first_block
from fedcola_tpu_torch.main import main
main(sys.argv[1:])
"""
FAULT_DROP_UPLOAD = """
import sys
from fedcola_tpu_torch.models.mat import tree_map
from fedcola_tpu_torch.parallel import mesh
gather = mesh.MeshPlan.gather_clients
def drop_uploads(self, tree, n):
    full = gather(self, tree, n)
    if not isinstance(tree, dict):       # the metric sums
        return full
    return tree_map(lambda a: a[:1].expand_as(a).clone(), full)
mesh.MeshPlan.gather_clients = drop_uploads
from fedcola_tpu_torch.main import main
main(sys.argv[1:])
"""


# FAULT_SKIP_ENTER: the backward all-reduce of Megatron's f skipped on the
# attention input (the LayerNorm'd residual stream): each model rank then
# back-propagates only its own heads' part of the attention's gradient into
# LN1 and the layers below.  The ranks' replicated leaves drift apart, so
# the check that catches that at the upload is switched off, as it would be
# by a fault that also broke it; the gates must still see the fault.
FAULT_SKIP_ENTER = """
import sys
from fedcola_tpu_torch.models import mat
from fedcola_tpu_torch.parallel import mesh
layer_norm, enter = mat._layer_norm, mesh.TensorParallel.enter
def tagged(*a):
    y = layer_norm(*a)
    y.fault_ln = True
    return y
def skip_on_ln(self, x):
    return x if getattr(x, "fault_ln", False) else enter(self, x)
mat._layer_norm = tagged
mesh.TensorParallel.enter = skip_on_ln
mesh.MeshPlan.check_replicated = lambda *a, **k: None
from fedcola_tpu_torch.main import main
main(sys.argv[1:])
"""


# FAULT_OWN_FEATURES: each rank aggregates only its own block's public
# features (CreamFL under a mesh): every other client's features stand in
# for one of the rank's own, so the contrastive weighting and the
# distillation see the rank's clients alone, and the ranks' global models
# drift apart.  NO_REPLICATION_CHECK, put before it, switches off the check
# that catches that at the round's end (as FAULT_SKIP_ENTER does), to read
# what the other gates see.
FAULT_OWN_FEATURES = """
import sys
from fedcola_tpu_torch.federation import creamfl
extract = creamfl.CreamflServer._extract_pub_features
def own_features(self, g):
    extract(self, g)
    own = g.ids[self.plan.client_rows(len(g.ids))]
    for j, cid in enumerate(g.ids):
        if own and cid not in own:
            self._pub_feats[cid] = self._pub_feats[own[j % len(own)]]
creamfl.CreamflServer._extract_pub_features = own_features
from fedcola_tpu_torch.main import main
main(sys.argv[1:])
"""
NO_REPLICATION_CHECK = """
from fedcola_tpu_torch.parallel import mesh
mesh.MeshPlan.check_replicated = lambda *a, **k: None
"""


def _mesh_cli(out, extra, virtual, dist=None, code=None, flags=None):
    """``python -m fedcola_tpu_torch.main`` on ``flags`` ([main]'s line by
    default) with ``extra``, started with ``FEDCOLA_VIRTUAL_DEVICES=
    virtual``; ``dist``: ``(port, process_id)`` of a two-process run;
    ``code``: run that program (``python -c``) with the same flags
    instead."""
    from fedcola_tpu_torch import main as port_main
    cmd = [sys.executable, *(["-c", code] if code else
                             ["-m", "fedcola_tpu_torch.main"]),
           *(flags or port_main.MAIN_PATH_FLAGS), *extra,
           "--result_path", os.path.join(out, "result"),
           "--log_path", os.path.join(out, "log")]
    if dist is not None:
        port, pid = dist
        cmd += ["--dist_coordinator", f"127.0.0.1:{port}",
                "--dist_num_processes", "2", "--dist_process_id", str(pid)]
    env = dict(os.environ, FEDCOLA_VIRTUAL_DEVICES=str(virtual))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _mesh_finish(tag, procs, timeout=600, check=True):
    """Wait for every process of a mesh run; when one fails (or the time
    runs out) stop the others, which would wait on it, and raise with the
    end of its output (with ``check`` off, return the outputs)."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs):
        if time.time() > deadline or any(p.poll() not in (None, 0)
                                         for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate()[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and check:
            raise AssertionError(f"[{tag}] process {i} exited with "
                                 f"{p.returncode}:\n{o[-6000:]}")
        for line in o.splitlines():
            if any(k in line for k in ("[MESH]", "[KERNELS]", "] clients in")):
                log(f"[{tag}] process {i}: {line}")
    return outs


def _mesh_report(tag, card, res, tp=False):
    """Print a mesh run's backend and each rank's figures, beside the
    card; fail unless every rank launched the fused training kernels and
    the eval forwards (more forward launches than backward ones).  With
    ``tp`` (a ``model`` axis): unless every rank launched the Megatron
    route's rows 11, 12, 3e and 6 and the eval row 1e, and neither fused
    training backward (rows 2, 4)."""
    want = TP_KERNELS if tp else MESH_TRAINING_KERNELS
    m = res["mesh"]
    log(f"[{tag}] {card}: mesh {m['mesh']}, backend {m['backend']}")
    for r in sorted(k for k in res if k.isdigit()):
        sections = {k: round(v, 3) for k, v in
                    res[r]["round_sections"].items()}
        log(f"[{tag}] {card}: round {r}: rank 0 round_sections {sections}")
    for rk in m["ranks"]:
        ln = rk["launches"]
        peak = rk["peak_memory_bytes"]
        log(f"[{tag}] {card}: rank {rk['rank']} on {rk['device']}: staged "
            f"{rk['staged_bytes'] / 1e6:.1f} MB, peak device memory "
            f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}"
            f", round_seconds "
            f"{rk['round_seconds']}, eval_seconds {rk['eval_seconds']}, "
            f"launches { {k: ln.get(k, 0) for k in want} }"
            + (f", eval row 1e {ln.get('attn_fwd', 0)}" if tp else ""))
        missing = [k for k in want if not ln.get(k)]
        if tp:
            wrong = missing or ln.get("attn_bwd") or ln.get("mlp_bwd") \
                or not ln.get("attn_fwd")
        else:
            wrong = missing or not (ln["attn_fwd"] > ln["attn_bwd"]
                                    and ln["mlp_fwd"] > ln["mlp_bwd"])
        if wrong:
            raise AssertionError(
                f"[{tag}] rank {rk['rank']} launches {ln}: " +
                ("rows 11, 12, 3e, 6 and the eval row 1e must launch, rows "
                 "2 and 4 not" if tp else
                 "rows 1-4 and the eval rows 1e / 3e must all launch"))
    return {rk["rank"]: {k: rk["launches"].get(k, 0) for k in want}
            for rk in m["ranks"]}


def _mesh_collectives():
    """Each collective the mesh uses, in a one-rank NCCL group on the card,
    against the identity, in bfloat16 and float32: the NCCL calls a
    multi-card run makes."""
    import torch
    import torch.distributed as dist
    from fedcola_tpu_torch.parallel import mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{mesh.free_port()}", world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        gen = torch.Generator(device="cuda").manual_seed(3)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((2, 48, 384), generator=gen, device="cuda"
                            ).to(dtype)
            w = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            xg = x.clone().requires_grad_(True)
            y = mesh.all_gather_grad(xg, g, dim=1)
            y.backward(w)
            checks = {
                "all_gather": mesh.all_gather(x, g, dim=1),
                "all_gather (bool)": mesh.all_gather(x > 0, g) == (x > 0),
                "all_gather_grad": y, "all_gather_grad backward": xg.grad,
                "all_reduce_sum": mesh.all_reduce_sum([x], g)[0],
                "gather_stacks": mesh.gather_stacks([x], g)[0]}
            want = {"all_gather (bool)": torch.ones_like(x, dtype=torch.bool),
                    "all_gather_grad backward": w}
            bad = [k for k, v in checks.items()
                   if not torch.equal(v, want.get(k, x))]
            log(f"[mesh] one-rank NCCL group, {dtype}: "
                f"{len(checks)} collectives against the identity, unequal: "
                f"{bad}")
            if bad:
                raise AssertionError(f"NCCL collectives {bad} are not the "
                                     f"identity on one rank ({dtype})")
    finally:
        dist.destroy_process_group()


# [mesh]'s gates against [main], set from the planted faults' readings
# (PERF.md, Findings): the largest relative departure of a round's training
# loss and of an eval loss, acc1 in test samples (500 a set), r@1sum in one
# image and one caption, and per dataset the weights' RMS departure in
# units of the line's lr (AdamW moves an element about lr a step whatever
# its gradient's size; the departure from the initial weights is no
# yardstick, as the aux scales' fold into the uploads dominates it).  On
# the H100 the genuine meshes read at most 5.5e-5 / 1.5e-4 / 0.046 in
# training loss / eval loss / weights, the faults at least 1.6e-3 / 4.2e-3
# / 0.42; each bound sits near the geometric mean of the two (3-5x from
# either)
MESH_BOUNDS = {"training loss": 3e-4, "eval loss": 8e-4,
               "acc1": 1 / 500 + 1e-9, "r@1sum": 2 / 100 + 2 / 500 + 1e-9,
               "weights": 0.14}
# the gates each planted fault must fail.  skipped-enter leaves every
# forward right and bends only the gradients: a rehearsal of phase_tp on
# the CPU at test size moved the training loss and the weights past their
# bounds but not the eval loss (PERF.md, Findings)
FAULT_GATES = {"first-block": ("training loss", "eval loss", "weights"),
               "dropped-upload": ("training loss", "eval loss", "weights"),
               "skipped-enter": ("training loss", "weights"),
               # own-features: "replicated" is the check at the end of
               # every CreamFL round under a mesh (the ranks' global models
               # the same bits).  With it off, a rehearsal of
               # phase_creamfl_mesh on the CPU at test size moved only the
               # training loss past its bound; at mome_small the
               # distillation (--kd_weight 1e-7) moves the Coco model by
               # far less than the layout's noise, so no MESH_BOUNDS gate
               # is required of it (PERF.md, Findings)
               "own-features": ("replicated",)}
# what the replication check says when it stops a run
REPLICATED_GATE = "mesh ranks hold different copies of"


def _mesh_readings(main_results, main_weights, lr, res, weights) -> dict:
    """How far a mesh run departs from [main]: per round its training loss
    against [main]'s, and the readings ``MESH_BOUNDS`` gates."""
    import numpy as np
    rd = {"rounds": [], "training loss": 0.0, "eval loss": 0.0, "acc1": 0.0,
          "r@1sum": 0.0, "bitwise": True}
    for r in sorted(main_results):
        a, b = main_results[r], res[str(r)]
        la = a["clients_updated_summary"]["loss"]["avg"]
        lb = b["clients_updated_summary"]["loss"]["avg"]
        rd["rounds"].append((la, lb))
        rd["bitwise"] &= la == lb
        rd["training loss"] = max(rd["training loss"], abs(lb - la) / abs(la)
                                  if np.isfinite(lb) else float("inf"))
        for k in sorted(k for k in a if k.startswith("server_evaluated_")):
            rd["bitwise"] &= a[k] == b[k]
            if "metrics" in a[k]:
                rd["acc1"] = max(rd["acc1"], abs(a[k]["metrics"]["acc1"]
                                                 - b[k]["metrics"]["acc1"]))
                rd["eval loss"] = max(rd["eval loss"], abs(
                    a[k]["loss"] - b[k]["loss"]) / abs(a[k]["loss"]))
            else:
                key = k[len("server_evaluated_"):] + " r@1sum"
                rd["r@1sum"] = max(rd["r@1sum"], abs(a[k][key] - b[k][key]))
    rd["weights by dataset"] = {}
    for ds in sorted({ds for ds, _ in main_weights}):
        keys = [k for k in main_weights if k[0] == ds]
        sq = sum(float(np.square(weights[k].astype(np.float64)
                                 - main_weights[k]).sum()) for k in keys)
        rd["weights by dataset"][ds] = \
            (sq / sum(main_weights[k].size for k in keys)) ** 0.5 / lr
        rd["bitwise"] &= sq == 0
    rd["weights"] = max(rd["weights by dataset"].values())
    return rd


def _mesh_judge(tag, card, rd) -> list:
    """Print a run's readings beside the card; returns the gates of
    ``MESH_BOUNDS`` it fails."""
    for r, (la, lb) in enumerate(rd["rounds"], 1):
        log(f"[{tag}] {card}: round {r}: training loss {lb!r} (main {la!r})")
    ratios = {k: f"{v:.3e}" for k, v in rd["weights by dataset"].items()}
    log(f"[{tag}] {card}: against [main]: training loss "
        f"{rd['training loss']:.3e}, eval loss {rd['eval loss']:.3e}, acc1 "
        f"|d| {rd['acc1']:.4f}, r@1sum |d| {rd['r@1sum']:.4f}, weights' RMS "
        f"departure / lr {ratios}; bit for bit with [main]: "
        f"{rd['bitwise']}")
    return [k for k, bound in MESH_BOUNDS.items() if not rd[k] <= bound]


def _stacking_bits(card):
    """Why the ``clients`` mesh is not bit for bit on the card: float32
    products and reductions that cuBLAS / PyTorch split by the client
    count.  Client c's rows of two stacked clients against client c
    alone."""
    import torch
    from fedcola_tpu_torch.ops import losses
    g = torch.Generator(device="cuda").manual_seed(4)
    a = torch.randn((2, 96, 384), generator=g, device="cuda")
    b = torch.randn((2, 384, 100), generator=g, device="cuda")
    for name, two, fn in (
            ("torch.bmm float32 [2, 96, 384] x [2, 384, 100] (a head)",
             torch.bmm(a, b), lambda c: torch.bmm(a[c:c + 1], b[c:c + 1])),
            ("clip_contrastive [2, 96, 384]",
             losses.clip_contrastive(a, a.flip(1)),
             lambda c: losses.clip_contrastive(a[c:c + 1],
                                               a.flip(1)[c:c + 1]))):
        d = max(float((two[c:c + 1] - fn(c)).abs().max()) for c in range(2))
        log(f"[mesh] {card}: {name}: one client alone against two stacked, "
            f"max |d| {d:.3e}")


def phase_mesh(main_results, main_weights, card):
    """The device mesh on the one card, ranks sharing it (gloo), each run
    read against [main] by ``_mesh_readings`` and gated by ``MESH_BOUNDS``:

    1. [main]'s line with ``--mesh_shape 2`` (a ``clients`` mesh, spawned,
       ``FEDCOLA_VIRTUAL_DEVICES=2``), from a cold kernel build (both ranks
       start with ``build/kernels/`` removed: one builds, under the build
       lock, and both load it): each rank trains one of a group's two
       clients; whether it equals [main] bit for bit is printed;
    2. ``--mesh_shape 1 2 --mesh_axes clients data`` as two ``--dist_*``
       processes: each rank takes 48 of every client's 96 rows;
    3. the ``clients`` mesh again as two ``--dist_*`` processes with each
       planted fault (``FAULT_FIRST_BLOCK``, ``FAULT_DROP_UPLOAD``): each
       gate ``FAULT_GATES`` names must reject it;
    4. ``graft_entry.dryrun_multichip(4)``: a 2 x 2 mesh of four ranks on
       the card, each launching the fused training kernels;
    5. each collective in a one-rank NCCL group, against the identity.

    Prints each run's backend and every rank's figures.  Returns the
    ranks' launches of the fused training kernels, per run."""
    import shutil
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.graft_entry import dryrun_multichip
    from fedcola_tpu_torch.ops import kernels
    from fedcola_tpu_torch.parallel.mesh import free_port
    import torch
    torch.cuda.empty_cache()
    datasets = sorted({ds for ds, _ in main_weights})
    flags = port_main.MAIN_PATH_FLAGS
    lr = float(flags[flags.index("--lr") + 1])
    launches = {}

    def read(tag, out):
        res = json.load(open(os.path.join(out, "result", "FedCola.json")))
        launches[tag] = _mesh_report(f"mesh-{tag}", card, res)
        weights = _npz_weights(os.path.join(out, "result"), "FedCola",
                               datasets)
        return _mesh_readings(main_results, main_weights, lr, res, weights)

    with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as out:
        shutil.rmtree(kernels.BUILD_DIR)
        t0 = time.time()
        outs = _mesh_finish("mesh-clients", [_mesh_cli(
            os.path.join(out, "clients"), ["--mesh_shape", "2"], 2)])
        wall = time.time() - t0
        built = outs[0].count("[KERNELS] built")
        log(f"[mesh] clients run: {wall:.1f}s wall with a cold kernel build "
            f"(built {built} time(s); {kernels.LIB_PATH} exists: "
            f"{kernels.LIB_PATH.exists()})")
        if built != 1 or not kernels.LIB_PATH.exists():
            raise AssertionError(f"[mesh] cold start: the build ran {built} "
                                 f"times (want 1)")
        failed = _mesh_judge("mesh-clients", card,
                             read("clients", os.path.join(out, "clients")))
        if failed:
            raise AssertionError(f"[mesh] the clients mesh departs from "
                                 f"[main] beyond {failed}")

        port = free_port()
        _mesh_finish("mesh-data", [
            _mesh_cli(os.path.join(out, "data"),
                      ["--mesh_shape", "1", "2", "--mesh_axes", "clients",
                       "data"], 1, (port, pid)) for pid in range(2)])
        failed = _mesh_judge("mesh-data", card,
                             read("data", os.path.join(out, "data")))
        if failed:
            raise AssertionError(f"[mesh] the clients x data mesh departs "
                                 f"from [main] beyond {failed}")

        for fault, code in (("first-block", FAULT_FIRST_BLOCK),
                            ("dropped-upload", FAULT_DROP_UPLOAD)):
            port = free_port()
            _mesh_finish(f"mesh-{fault}", [
                _mesh_cli(os.path.join(out, fault), ["--mesh_shape", "2"], 1,
                          (port, pid), code=code) for pid in range(2)])
            failed = _mesh_judge(f"mesh-{fault}", card,
                                 read(fault, os.path.join(out, fault)))
            del launches[fault]
            log(f"[mesh] planted fault {fault}: rejected by {failed}")
            blind = [k for k in FAULT_GATES[fault] if k not in failed]
            if blind:
                raise AssertionError(
                    f"[mesh] the {blind} gate(s) accept the planted fault "
                    f"{fault}: they cannot tell a wrong mesh from "
                    f"reassociation")
    _stacking_bits(card)
    t0 = time.time()
    dry = dryrun_multichip(4)
    log(f"[mesh] {card}: dryrun_multichip(4) on the card: mesh {dry['mesh']}"
        f", backend {dry['backend']}, loss {dry['loss']!r}, "
        f"{time.time() - t0:.1f}s; launches per rank {dry['launches']}")
    _mesh_collectives()
    return launches


# --------------------------------------------------------- creamfl-mesh ----

def phase_creamfl_mesh(cream_results, cream_weights, card):
    """CreamFL under the mesh on the one card, ranks sharing it over gloo:
    [baselines]' CreamFL line (``main.CREAMFL_FLAGS``: mome_small, B=96,
    500 public pairs in batches of 128 staged on the card), each run read
    against [baselines]' one-device CreamFL run by ``_mesh_readings`` and
    gated by ``MESH_BOUNDS`` (in units of the line's lr):

    1. ``--mesh_shape 2``, spawned: each rank trains one client of each
       group and all-gathers the public features;
    2. ``--mesh_shape 1 2 --mesh_axes clients data`` as two ``--dist_*``
       processes: 48 of every client's 96 task rows and 64 of every 128
       public rows a rank;
    3. the planted fault ``FAULT_OWN_FEATURES`` on the clients mesh (two
       ``--dist_*`` processes), which the gates ``FAULT_GATES`` names must
       reject; then the same fault with the replication check off (as the
       fault program of [tp] runs), its readings printed beside the gates.

    Every rank must launch rows 1-4 and the eval rows 1e / 3e.  Prints
    each run's backend and every rank's staged bytes, peak memory, round
    (with its pub_logit / train / aggregate / distill sections) and eval
    seconds and launches, and whether it equals the one-device run bit for
    bit.  Returns the genuine runs' launches of rows 1-4 per rank."""
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.parallel.mesh import free_port
    import torch
    torch.cuda.empty_cache()
    flags = port_main.CREAMFL_FLAGS
    exp = flags[flags.index("--exp_name") + 1]
    lr = float(flags[flags.index("--lr") + 1])
    datasets = sorted({ds for ds, _ in cream_weights})
    launches = {}
    t_phase = time.time()

    def run(tag, extra, virtual, dist, code=None, check=True):
        out = os.path.join(d, tag)
        t0 = time.time()
        if dist:
            port = free_port()
            procs = [_mesh_cli(out, extra, virtual, (port, pid), code, flags)
                     for pid in range(2)]
        else:
            procs = [_mesh_cli(out, extra, virtual, code=code, flags=flags)]
        outs = _mesh_finish(f"creamfl-mesh-{tag}", procs, check=check)
        log(f"[creamfl-mesh] {tag}: {time.time() - t0:.1f}s wall")
        return out, procs, outs

    def read(tag, out):
        res = json.load(open(os.path.join(out, "result", f"{exp}.json")))
        ranks = _mesh_report(f"creamfl-mesh-{tag}", card, res)
        rd = _mesh_readings(cream_results, cream_weights, lr, res,
                            _npz_weights(os.path.join(out, "result"), exp,
                                         datasets))
        return ranks, _mesh_judge(f"creamfl-mesh-{tag}", card, rd)

    with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as d:
        for tag, extra, virtual, dist in (
                ("clients", ["--mesh_shape", "2"], 2, False),
                ("data", ["--mesh_shape", "1", "2", "--mesh_axes",
                          "clients", "data"], 1, True)):
            out, _, _ = run(tag, extra, virtual, dist)
            launches[tag], failed = read(tag, out)
            if failed:
                raise AssertionError(f"[creamfl-mesh] the {tag} mesh departs "
                                     f"from [baselines]' CreamFL run beyond "
                                     f"{failed}")
        fault = "own-features"
        _, procs, outs = run(fault, ["--mesh_shape", "2"], 1, True,
                             FAULT_OWN_FEATURES, check=False)
        failed = ["replicated"] if any(
            p.returncode != 0 and REPLICATED_GATE in o
            for p, o in zip(procs, outs)) else []
        if not failed:
            failed = read(fault, os.path.join(d, fault))[1]
        stop = next((line for o in outs for line in o.splitlines()
                     if REPLICATED_GATE in line), "no replication error")
        log(f"[creamfl-mesh] planted fault {fault}: rejected by {failed} "
            f"({stop.strip()[:300]})")
        blind = [k for k in FAULT_GATES[fault] if k not in failed]
        if blind:
            raise AssertionError(
                f"[creamfl-mesh] the {blind} gate(s) accept the planted "
                f"fault {fault}")
        out, _, _ = run(fault + "-unchecked", ["--mesh_shape", "2"], 1, True,
                        NO_REPLICATION_CHECK + FAULT_OWN_FEATURES)
        _, unchecked = read(fault + "-unchecked", out)
        log(f"[creamfl-mesh] planted fault {fault} with the replication "
            f"check off: MESH_BOUNDS gates tripped {unchecked}")
    log(f"[creamfl-mesh] {card}: phase {time.time() - t_phase:.1f}s wall")
    return launches


# ------------------------------------------------------------------ tp ----

TP_MESH = ("--mesh_shape", "1", "2", "--mesh_axes", "clients", "model")


def phase_tp(main_results, main_weights, card):
    """The ``model`` axis on the one card: [main]'s line with
    ``TP_MESH`` as two ``--dist_*`` processes sharing the card over gloo
    (NCCL cannot put two ranks on one card).  Each rank trains both
    clients of every group on 3 of the 6 heads (rows 11 / 12) and 768 of
    the 1536 hidden columns (rows 3e / 6), the replicated activations
    joined by an all-reduce a sublayer; evaluation runs whole (rows 1e,
    3e).

    1. the run, read against [main] by ``_mesh_readings`` and gated by
       ``MESH_BOUNDS``; every rank must launch rows 11, 12, 3e, 6 and 1e,
       and neither fused training backward;
    2. the planted fault ``FAULT_SKIP_ENTER``, which each gate
       ``FAULT_GATES`` names must reject;
    3. ``graft_entry.dryrun_multichip(8)``: the JAX dry run's 2 x 2 x 2
       ``clients x data x model`` mesh, eight ranks on the card.

    Prints every rank's figures beside the card; returns the run's
    launches of rows 11, 12, 3e and 6 per rank."""
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.graft_entry import dryrun_multichip
    from fedcola_tpu_torch.parallel.mesh import free_port
    import torch
    torch.cuda.empty_cache()
    datasets = sorted({ds for ds, _ in main_weights})
    flags = port_main.MAIN_PATH_FLAGS
    lr = float(flags[flags.index("--lr") + 1])
    launches = None
    with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as out:
        for fault, code in ((None, None), ("skipped-enter",
                                           FAULT_SKIP_ENTER)):
            tag = "tp" if fault is None else f"tp-{fault}"
            run = os.path.join(out, tag)
            port, t0 = free_port(), time.time()
            _mesh_finish(tag, [_mesh_cli(run, TP_MESH, 1, (port, pid),
                                         code=code) for pid in range(2)])
            log(f"[{tag}] {card}: {time.time() - t0:.1f}s wall")
            res = json.load(open(os.path.join(run, "result",
                                              "FedCola.json")))
            ranks = _mesh_report(tag, card, res, tp=True)
            failed = _mesh_judge(tag, card, _mesh_readings(
                main_results, main_weights, lr, res, _npz_weights(
                    os.path.join(run, "result"), "FedCola", datasets)))
            if fault is None:
                launches = ranks
                if failed:
                    raise AssertionError(f"[tp] the clients x model mesh "
                                         f"departs from [main] beyond "
                                         f"{failed}")
                continue
            log(f"[tp] planted fault {fault}: rejected by {failed}")
            blind = [k for k in FAULT_GATES[fault] if k not in failed]
            if blind:
                raise AssertionError(
                    f"[tp] the {blind} gate(s) accept the planted fault "
                    f"{fault}: they cannot tell a wrong model axis from "
                    f"reassociation")
    t0 = time.time()
    dry = dryrun_multichip(8)
    log(f"[tp] {card}: dryrun_multichip(8) on the card: mesh {dry['mesh']}, "
        f"backend {dry['backend']}, loss {dry['loss']!r}, "
        f"{time.time() - t0:.1f}s; launches per rank {dry['launches']}")
    if dry["mesh"] != {"clients": 2, "data": 2, "model": 2}:
        raise AssertionError(f"[tp] dry run mesh {dry['mesh']}")
    return launches


# ---------------------------------------------------------- loss bound ----

LOSS_BOUND = 1e-3   # relative, per round
# the same in float32: [kernels]' float32 tolerance, 1e-4 relative
LOSS_BOUND_F32 = 1e-4
LOSS_BOUND_B = 4    # batch size of the comparison, on both devices


def _training_losses(flags, device: str, out: str):
    """The two rounds' average training losses of a coco.sh line on
    ``device`` at ``LOSS_BOUND_B`` without DropPath, each round's clients'
    own (client id: [dataset, loss]), the seconds they took and round 1's
    sampled shards by dataset, in rows; training only, no central
    evaluation."""
    import numpy as np
    import torch
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.data.loaders import load_federated_data
    from fedcola_tpu_torch.federation.server import create_server
    from fedcola_tpu_torch.utils.seeding import set_seed
    cfg = parse_args(list(flags) + [
        "--device", device, "--B", str(LOSS_BOUND_B), "--dropout", "0",
        "--result_path", os.path.join(out, "result"),
        "--log_path", os.path.join(out, "log")])
    set_seed(cfg.seed)
    server = create_server(cfg, load_federated_data(
        cfg, np.random.RandomState(cfg.seed)))
    t0 = time.time()
    losses, clients = [], []
    for r in (1, 2):
        server.round = r
        server.update()
        res = server.results[r]
        losses.append(res["clients_updated_summary"]["loss"]["avg"])
        clients.append({str(c): [server.clients[int(c)].dataset, m["loss"]]
                        for c, m in res["clients_updated"].items()})
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    rows = {}
    for c, (ds, _) in clients[0].items():
        rows.setdefault(ds, []).append(server.data.client_shards[int(c)].n)
    return losses, clients, secs, rows


def _bound_lines(d):
    """Each ``loss_bound``'s tag and line, in the order the phases read
    them; the fixtures line on [fixtures]' files, written under ``d`` when
    it is reached."""
    from fedcola_tpu_torch import main as port_main
    yield "main", port_main.MAIN_PATH_FLAGS
    yield "tiny", port_main.MOME_TINY_FLAGS
    yield "fedprox", port_main.FEDPROX_FLAGS
    yield "creamfl", _creamfl_bound_flags()
    yield "fixtures", _write_fixture_line(d)[0]
    yield "flickr", _write_flickr_line(d)
    yield "population", _population_bound_line(d)
    yield "long", port_main.MEDABS_LONG_FLAGS


def _same_line(a, b) -> bool:
    """Two lines' flags alike but for the paths in them (the fixtures
    line's roots differ between the worker and the phase)."""
    def strip(flags):
        return [f for f in flags if not os.path.isabs(f)]
    return strip(a) == strip(b)


def cpu_bounds_worker(out_dir: str) -> None:
    """The CPU side of every loss bound, one after the other, each written
    to ``<out_dir>/<tag>.json`` as it ends (``CpuBounds`` starts this in a
    process with no card visible)."""
    with tempfile.TemporaryDirectory(prefix="fedcola_bounds_") as d:
        for tag, flags in _bound_lines(d):
            with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as out:
                losses, clients, secs, _ = _training_losses(flags, "cpu",
                                                            out)
            tmp = os.path.join(out_dir, f"{tag}.tmp")
            with open(tmp, "w") as f:
                json.dump({"flags": list(flags), "losses": losses,
                           "clients": clients, "seconds": secs}, f)
            os.replace(tmp, os.path.join(out_dir, f"{tag}.json"))


class CpuBounds:
    """The CPU sides of the loss bounds (about 400 s, no card), computed by
    one background process from the script's start and collected where
    each bound is read.  It gets ``CPU_BOUNDS_THREADS`` of the host's
    cores; the card's phases and their mesh ranks keep the rest."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="fedcola_cpu_bounds_")
        self.log = open(os.path.join(self.dir, "worker.log"), "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(CPU_BOUNDS_THREADS))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.cpu_bounds_worker(sys.argv[1])", self.dir],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=self.log, stderr=subprocess.STDOUT)

    def get(self, tag: str, flags, timeout: float = 1200):
        """The CPU losses and seconds of ``tag``'s line, waiting for them;
        fails when the worker has stopped without them or ran another
        line."""
        path = os.path.join(self.dir, f"{tag}.json")
        t0 = time.time()
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.time() - t0 > timeout:
                self.log.flush()
                tail = open(self.log.name).read()[-4000:]
                raise AssertionError(f"{tag}: the CPU bound worker stopped "
                                     f"(exit {self.proc.poll()}) without "
                                     f"its losses:\n{tail}")
            time.sleep(0.5)
        res = json.load(open(path))
        if not _same_line(res["flags"], flags):
            raise AssertionError(f"{tag}: the CPU bound worker ran another "
                                 f"line: {res['flags']}")
        return (res["losses"], res["clients"], res["seconds"],
                time.time() - t0)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


CPU_BOUNDS_THREADS = 4
CPU_BOUNDS = None     # the running CpuBounds, set by main()


def loss_bound(tag: str, flags):
    """How far the kernels may move the training loss: the same two rounds
    of a coco.sh line from the same seed (weights, splits, client
    sampling, shuffles) on the card, through the kernels, and on the CPU,
    through their plain versions, at the line's full width and depth in
    bfloat16 (or in float32 where the line says so).  A round's average
    training loss may differ by at most ``LOSS_BOUND`` = 1e-3 relative,
    in float32 ``LOSS_BOUND_F32``.

    The shape is the line's own but for two flags, the same on both
    devices: ``--B 4``, because the CPU side of the full batch of 96 takes
    minutes (the card side under a second), and ``--dropout 0``, because
    the card's and the CPU's generators draw different DropPath masks from
    one seed.  Both losses are printed.  Returns round 1's sampled shards
    on the card (``_training_losses``) and the card side's launches."""
    import math
    from fedcola_tpu_torch.ops import kernels
    f32 = dict(zip(flags, flags[1:])).get("--compute_dtype") == "float32"
    bound = LOSS_BOUND_F32 if f32 else LOSS_BOUND
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="fedcola_smoke_") as out:
        card, card_clients, t_card, rows = _training_losses(flags, "cuda",
                                                            out)
    launches = dict(kernels.LAUNCHES)
    cpu, cpu_clients, t_cpu, waited = CPU_BOUNDS.get(tag, flags)
    for r, (a, b) in enumerate(zip(card, cpu), 1):
        rel = abs(a - b) / abs(b)
        log(f"[{tag}] bound: round {r} training loss on the card {a:.6f}, "
            f"on the CPU {b:.6f}, relative difference {rel:.2e} "
            f"(bound {bound:.0e}; B={LOSS_BOUND_B}, no DropPath)")
        # each client's own loss, printed, not bounded
        own = {c: (ds, abs(la - cpu_clients[r - 1][c][1])
                   / abs(cpu_clients[r - 1][c][1]))
               for c, (ds, la) in card_clients[r - 1].items()}
        log(f"[{tag}] bound: round {r} each client's relative difference "
            + ", ".join(f"{c} ({ds}) {d:.2e}" for c, (ds, d) in
                        sorted(own.items(), key=lambda kv: int(kv[0]))))
        if not (math.isfinite(a) and rel <= bound):
            raise AssertionError(
                f"{tag}: round {r} training loss {a} on the card against "
                f"{b} on the CPU: relative difference {rel:.3e} exceeds "
                f"{bound}")
    log(f"[{tag}] bound: {t_card:.1f}s on the card, {t_cpu:.1f}s on the CPU "
        f"(background; waited {waited:.1f}s for it)")
    return rows, launches


# --------------------------------------------------------------- remat ----

def phase_remat():
    """Two local steps of the Coco img+txt group update (both stacks, N=197
    and 40) at mome_small, n=2 clients, B=96, under each remat policy, from
    the same weights, batches and DropPath draws.  Returns the launch
    counts of the three runs."""
    import math
    import numpy as np
    import torch
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.models.mat import stack_clients, tree_map
    from fedcola_tpu_torch.models.registry import create_model
    from fedcola_tpu_torch.ops import kernels
    from fedcola_tpu_torch.parallel.client_update import GroupSpec, run_chunk
    from fedcola_tpu_torch.parallel.optim import (init_opt_state,
                                                  make_optimizer_spec)
    cfg = parse_args(list(port_main.MAIN_PATH_FLAGS))
    mcfg, params = create_model(cfg.model_name, cfg, "Coco",
                                torch.Generator().manual_seed(cfg.seed))
    params = tree_map(lambda a: a.cuda(), params)
    opt = make_optimizer_spec(cfg)
    spec = GroupSpec(modality="img+txt", criterion="ContrastiveLoss",
                     imnorm=True)
    n, S, B = 2, 2, cfg.B
    r = np.random.RandomState(0)
    chunk = {"x": r.randint(0, 256, (n, S, B, 224, 224, 3)).astype(np.uint8),
             "y": r.randint(0, mcfg.vocab_size,
                            (n, S, B, mcfg.max_text_len)).astype(np.int32),
             "valid": np.ones((n, S, B), bool),
             "step_valid": np.ones((n, S), bool)}
    losses = {}
    kernels.reset_launches()
    for policy in ("kernel", "save_attn", "full"):
        stacked = tree_map(lambda a: a.requires_grad_(True),
                           stack_clients(params, n))
        state = init_opt_state(opt, stacked, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ls, _, _ = run_chunk(mcfg.replace(remat_policy=policy), spec, opt,
                             stacked, state, chunk, cfg.lr,
                             torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        secs = time.time() - t0
        losses[policy] = ls.float().cpu()
        if not all(math.isfinite(v) for v in losses[policy].flatten()):
            raise AssertionError(f"{policy}: non-finite loss {losses[policy]}")
        log(f"[remat] {policy:9s} losses {losses[policy].tolist()} "
            f"{secs:.2f}s for {S} steps, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del stacked, state
    launches = dict(kernels.LAUNCHES)
    ref = losses["kernel"]
    for policy in ("save_attn", "full"):
        d = (losses[policy] - ref).abs().max().item()
        m = ref.abs().max().item()
        if d > 3e-2 * max(1.0, m):
            raise AssertionError(f"{policy} losses differ from 'kernel' by "
                                 f"{d:.3e} (max |loss| {m:.3e})")
        log(f"[remat] {policy} vs 'kernel': max |d loss| {d:.3e}")
    log(f"[remat] launches { {k: v for k, v in launches.items() if v} }")
    if not (launches["attn_bwd_recompute"] and launches["mlp_bwd_nores"]):
        raise AssertionError(f"remat path never launched rows 5/6: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------- rows ----

def phase_rows():
    """The rows-mode MLP through its public functions on every layer of
    both stacks of the mome_small Coco img+txt model (the model's own
    norm2 and fc weights, stacked for n=2 clients), on seeded bf16
    activations of the training batch (B=96, N=197 and 40) flattened to
    [n, B*N, D]: fused_mlp_sublayer (rows 9/10) forward and backward
    against the item sublayer (3e/6) on the unflattened batch, and
    fused_mlp (rows 7/8) on T(LN2(x)) against its plain version.  Returns
    the launch counts."""
    import torch
    import torch.nn.functional as F
    from fedcola_tpu_torch import main as port_main
    from fedcola_tpu_torch.config import parse_args
    from fedcola_tpu_torch.models.mat import stack_clients
    from fedcola_tpu_torch.models.registry import create_model
    from fedcola_tpu_torch.ops import fused_mlp as fm
    from fedcola_tpu_torch.ops import kernels
    cfg = parse_args(list(port_main.MAIN_PATH_FLAGS))
    mcfg, params = create_model(cfg.model_name, cfg, "Coco",
                                torch.Generator().manual_seed(cfg.seed))
    n, B, D, dt = 2, cfg.B, mcfg.embed_dim, torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)
    sub_names = ("out", "dx", "dlns", "dlnb", "dw1", "db1", "dw2", "db2")
    mlp_names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    kernels.reset_launches()
    t0 = time.time()
    for slot, modality in enumerate(mcfg.modalities):
        N = mcfg.num_patches + 1 if modality == "img" else mcfg.max_text_len
        blk = stack_clients(params["blk"][str(slot)], n)
        worst_sub = worst_mlp = 0.0
        for l in range(mcfg.depth):
            lw = {k: blk[k][:, l].cuda().contiguous() for k in (
                "norm2_scale", "norm2_bias", "fc1_kernel", "fc1_bias",
                "fc2_kernel", "fc2_bias")}
            ln = [lw["norm2_scale"], lw["norm2_bias"]]
            w = [lw[k] for k in ("fc1_kernel", "fc1_bias", "fc2_kernel",
                                 "fc2_bias")]
            x4, do4 = (torch.randn((n, B, N, D), generator=gen,
                                   device="cuda").to(dt) for _ in range(2))
            x, do = x4.reshape(n, B * N, D), do4.reshape(n, B * N, D)
            # rows 9/10 (float32 master weights, cast as the JAX op casts
            # them) against the item sublayer on the weights in T, as
            # models/mat.py passes them
            leaves = [x.clone().requires_grad_(True)] + \
                [u.clone().requires_grad_(True) for u in ln + w]
            out = fm.fused_mlp_sublayer(*leaves)
            got = [out] + list(torch.autograd.grad(out, leaves, do))
            ileaves = [x4.clone().requires_grad_(True)] + \
                [u.clone().requires_grad_(True) for u in ln] + \
                [u.to(dt).requires_grad_(True) for u in w]
            iout = fm.fused_mlp_sublayer_items(*ileaves)
            ref = [iout] + list(torch.autograd.grad(iout, ileaves, do4))
            got = [g.reshape(r.shape).to(r.dtype) for g, r in zip(got, ref)]
            worst_sub = max(worst_sub, _compare(got, ref, dt, sub_names))
            # rows 7/8 on T(LN2(x)) against their plain versions
            h = F.layer_norm(x.float(), (D,), None, None, 1e-5)
            h = (h * ln[0][:, None] + ln[1][:, None]).to(dt)
            leaves = [h.requires_grad_(True)] + \
                [u.clone().requires_grad_(True) for u in w]
            out = fm.fused_mlp(*leaves)
            got = [out] + list(torch.autograd.grad(out, leaves, do))
            wt = [u.to(dt) for u in w]
            ref = [fm.mlp_fwd_rows_plain(h.detach(), *wt)] + \
                list(fm.mlp_bwd_rows_plain(h.detach(), *wt[:3], do))
            worst_mlp = max(worst_mlp, _compare(got, ref, dt, mlp_names))
        log(f"[rows] {modality} stack (N={N}, rows={B * N}, {mcfg.depth} "
            f"layers): fused_mlp_sublayer vs the item sublayer, output and "
            f"7 gradients, max|d| {worst_sub:.3e}; fused_mlp vs its plain "
            f"version max|d| {worst_mlp:.3e}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = len(mcfg.modalities) * mcfg.depth
    log(f"[rows] {time.time() - t0:.1f}s, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    wrong = {k: launches[k] for k in ("mlp_fwd_rows", "mlp_bwd_rows",
                                      "mlp_ln_fwd_rows", "mlp_ln_bwd_rows")
             if launches[k] != want}
    if wrong:
        raise AssertionError(f"rows path launched {wrong}, expected {want} "
                             f"each (one per layer per stack)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # outside a checkout of the repo the script stops here
    from fedcola_tpu_torch.ops import kernels  # noqa: F401

    card = gpu_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CPU_BOUNDS
    CPU_BOUNDS = CpuBounds()
    try:
        return _phases(card)
    finally:
        CPU_BOUNDS.close()


def _phases(card) -> int:
    import torch
    from fedcola_tpu_torch.ops import kernels
    secs = kernels.build()
    log(f"[build] {len(kernels.SOURCES)} sources -> {kernels.LIB_PATH} "
        f"in {secs:.1f}s")
    kernels.library()
    check_sass(kernels)

    measured = phase_kernels()
    phase_model()
    main_launches, main_results, main_weights = phase_main()
    paths = {"main": main_launches, "resident": phase_resident(main_results),
             "tiny": phase_tiny(), "moonlight": phase_moonlight()}
    paths["baselines"], (cream_results, cream_weights) = phase_baselines()
    phase_retrieval()
    paths.update(local=phase_local(), augment=phase_augment(),
                 fixtures=phase_fixtures(), flickr=phase_flickr(),
                 population=phase_population(), remat=phase_remat(),
                 rows=phase_rows(), long=phase_long())
    mesh_launches = phase_mesh(main_results, main_weights, card)
    tp_launches = phase_tp(main_results, main_weights, card)
    cream_launches = phase_creamfl_mesh(cream_results, cream_weights, card)

    rows = []
    for name, (source, replaces, path) in KERNEL_INFO.items():
        m = measured[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": paths[path][name],
               **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
        for shape in ("eval", "distill", "long", "long_eval", "tp", "text"):
            if shape in m:
                # the same entry point at central evaluation's, CreamFL
                # distillation's, the long line's (N = 512), a [tp]
                # rank's or the moonlight line's text step's shape
                row[shape] = {k: m[shape][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if "groups" in m:
            # the optimizer step at each population group's shape
            row["groups"] = m["groups"]
        if "long" in row:
            # the long line's launches (every one at N = 512)
            row["long"]["launches"] = paths["long"][name]
        if name in FIXTURE_TRAINING_KERNELS:
            # [population]: the coco.sh line at its own population and length
            row["population_launches"] = paths["population"][name]
        if name in MESH_TRAINING_KERNELS:
            # [mesh] and [creamfl-mesh]: each run's launches per rank (eval
            # rows included)
            row["mesh_launches"] = {run: {r: v[name] for r, v in ranks.items()}
                                    for run, ranks in mesh_launches.items()}
            row["creamfl_mesh_launches"] = {
                run: {r: v[name] for r, v in ranks.items()}
                for run, ranks in cream_launches.items()}
        if name in TP_KERNELS:
            # [tp]: each rank's launches (mlp_fwd with the eval row 3e)
            row["tp_launches"] = {r: v[name] for r, v in tp_launches.items()}
        rows.append(row)
    missing = [r["name"] for r in rows if r["launches"] == 0] + \
        [r["name"] + " (long)" for r in rows
         if "long" in r and r["long"]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
