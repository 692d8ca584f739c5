"""Entry points of the PyTorch port for a one-card check and a multi-device
dry run (counterpart of the root ``__graft_entry__.py``): the flagship
forward on one card, and a dry run of the multi-device group update.

    python -m fedcola_tpu_torch.graft_entry [n_devices] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def entry(device: str = "cuda"):
    """``(fn, example_args)``: the multi-modal eval forward of the flagship
    ViT-small MAT (the model scripts/coco.sh trains: D=384, depth 12, 6
    heads, bfloat16) on ``device``; on the card it runs the fused eval
    kernels (rows 1e and 3e), on the CPU their plain versions."""
    import torch
    from fedcola_tpu_torch.models.mat import MATConfig, init_mat, mat_apply

    cfg = MATConfig(
        modalities=("img", "txt"), tasks=("rtv", "rtv"),
        num_classes=(None, None),
        img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
        vocab_size=30522, max_text_len=40,
        use_pallas=True, use_fused_mlp=True, compute_dtype="bfloat16",
    )
    params = init_mat(cfg, torch.Generator().manual_seed(0))
    params = {k: _to(v, device) for k, v in params.items()}

    @torch.no_grad()
    def fn(params, img, txt):
        feats = mat_apply(cfg, params, [img, txt], feat_out=True)
        return feats[0], feats[1]

    img = torch.zeros((8, 224, 224, 3), dtype=torch.bfloat16, device=device)
    txt = torch.zeros((8, 40), dtype=torch.int32, device=device)
    return fn, (params, img, txt)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


TRAINING_KERNELS = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
# the Megatron route's kernels (rows 11, 12, 3e, 6)
TP_KERNELS = ("flash_fwd", "flash_bwd", "mlp_fwd", "mlp_bwd_nores")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One resident group update of a small img+txt model (D=128, depth 2,
    2 heads: the fused route's smallest width) over an ``n_devices`` mesh,
    one rank per mesh device, in the JAX dry run's layouts: ``clients x
    data x model`` = ``[n/4, 2, 2]`` for ``n >= 8`` divisible by 4,
    ``clients x data`` = ``[n/2, 2]`` for other even ``n >= 4``, else
    ``[n]`` clients.  On the card (the default) the ranks share the
    visible cards (``FEDCOLA_VIRTUAL_DEVICES``), train in bfloat16 and
    every rank must launch the four fused training kernels (on a ``model``
    axis, the Megatron route's flash and no-residual MLP kernels); with
    ``device="cpu"`` they are virtual CPU devices running the kernels'
    plain versions in float32.  Each rank trains its clients of the group,
    its half of every batch, on a ``model`` axis its head and half of the
    MLP, gathered from a deduplicated image store.  Prints the mesh, the
    backend and the loss; returns them with each rank's launches."""
    import torch
    from fedcola_tpu_torch.parallel.mesh import (Launch, MeshPlan,
                                                 VIRTUAL_DEVICES_ENV,
                                                 free_port)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                               "device='cpu' for virtual CPU devices")
        from fedcola_tpu_torch.ops import kernels
        kernels.ensure_built()      # once, before the ranks start
        cards = torch.cuda.device_count()
    else:
        cards = 1
    if n_devices >= 8 and n_devices % 4 == 0:
        shape, axes = [n_devices // 4, 2, 2], ["clients", "data", "model"]
    elif n_devices >= 4 and n_devices % 2 == 0:
        shape, axes = [n_devices // 2, 2], ["clients", "data"]
    else:
        shape, axes = [n_devices], ["clients"]
    virtual = -(-n_devices // cards)
    plan = MeshPlan.build(shape, axes, n_visible=cards * virtual)
    launch = Launch(plan, 0, plan.n_devices,
                    f"tcp://127.0.0.1:{free_port()}", device)
    out = torch.multiprocessing.get_context("spawn").SimpleQueue()
    before = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(virtual)   # the ranks' view
    try:
        torch.multiprocessing.start_processes(
            _dryrun_rank, args=(launch, out), nprocs=plan.n_devices,
            start_method="spawn")
    finally:
        if before is None:
            del os.environ[VIRTUAL_DEVICES_ENV]
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = before
    ranks = sorted((out.get() for _ in range(plan.n_devices)),
                   key=lambda r: r["rank"])
    if device == "cuda":
        want = TP_KERNELS if plan.model_axis > 1 else TRAINING_KERNELS
        idle = [r["rank"] for r in ranks
                if not all(r["launches"].get(k) for k in want)]
        if idle:
            raise RuntimeError(f"dryrun_multichip: ranks {idle} did not "
                               f"launch every training kernel of {want}: "
                               f"{[r['launches'] for r in ranks]}")
    result = {"mesh": plan.mesh_dict, "backend": ranks[0]["backend"],
              "device": device, "loss": ranks[0]["loss"],
              "launches": {r["rank"]: r["launches"] for r in ranks}}
    print(f"dryrun_multichip OK: mesh={result['mesh']} on {device} "
          f"(backend {result['backend']}), resident-gather data plane, "
          f"loss={result['loss']:.4f}")
    return result


def _dryrun_rank(local_index: int, launch, out) -> None:
    import torch
    from fedcola_tpu_torch.models.mat import (MATConfig, init_mat,
                                              stack_clients, tree_leaves,
                                              tree_map)
    from fedcola_tpu_torch.ops import kernels
    from fedcola_tpu_torch.parallel.client_update import GroupSpec, run_chunk
    from fedcola_tpu_torch.parallel.optim import OptimizerSpec, init_opt_state

    torch.set_num_threads(1)
    plan = launch.join(local_index)
    try:
        cuda = launch.device_type == "cuda"
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
            else torch.device("cpu")
        n_clients = plan.clients_axis
        B, S = 4 * plan.data_axis, 2
        cfg = MATConfig(
            modalities=("img", "txt"), tasks=("rtv", "rtv"),
            num_classes=(None, None),
            img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            vocab_size=64, max_text_len=8,
            use_pallas=True, use_fused_mlp=True,
            compute_dtype="bfloat16" if cuda else "float32",
        )
        spec = GroupSpec(modality="img+txt", criterion="ContrastiveLoss",
                         imnorm=True)
        opt = OptimizerSpec(name="AdamW")
        params = init_mat(cfg, torch.Generator().manual_seed(0))
        rows = plan.client_rows(n_clients)
        stacked = tree_map(lambda a: a.to(dev),
                           stack_clients(params, rows.stop - rows.start))
        tp = plan.tensor_parallel(cfg)
        if tp is not None:
            stacked = tp.cut(stacked)
        for leaf in tree_leaves(stacked):
            leaf.requires_grad_(True)
        opt_state = init_opt_state(opt, stacked, rows.stop - rows.start)
        # the flagship (COCO / Flickr) resident layout: a deduplicated
        # image store and the caption -> image row map, 5 captions an image
        rng = np.random.RandomState(0)
        n_rows = 64
        data = {
            "img_store": torch.from_numpy(rng.randint(
                0, 255, (n_rows // 5 + 1, 32, 32, 3)).astype(np.uint8)),
            "img_row": torch.from_numpy(
                (np.arange(n_rows) // 5).astype(np.int32)),
            "txt": torch.from_numpy(
                rng.randint(0, 64, (n_rows, 8)).astype(np.int32)),
        }
        data = {k: v.to(dev) for k, v in data.items()}
        chunk = {
            "idx": rng.randint(0, n_rows, (n_clients, S, B)).astype(np.int32),
            "valid": np.ones((n_clients, S, B), bool),
            "step_valid": np.ones((n_clients, S), bool),
        }
        kernels.reset_launches()
        loss, _, _ = run_chunk(cfg, spec, opt, stacked, opt_state, chunk,
                               1e-4, torch.Generator(dev).manual_seed(1),
                               data=data, plan=plan, tp=tp)
        loss = plan.to_host(loss, n_clients)
        if not np.isfinite(loss).all():
            raise FloatingPointError(f"dry run: non-finite loss {loss}")
        out.put({"rank": plan.rank, "backend": plan.backend,
                 "loss": float(loss.mean()),
                 "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}})
    finally:
        plan.close()


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cuda"
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    dryrun_multichip(int(args[0]) if args else 8, dev)
