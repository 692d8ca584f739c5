"""Device mesh of the PyTorch port: the ``(clients, data, model)`` layout
of ``fedcola_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package drives a ``jax.sharding.Mesh`` from one process; here the
same layout is one process per mesh device, every rank running the same
deterministic host program (as the JAX package's processes do under
``--dist_*``):

* ``clients`` — each rank trains a contiguous block of a group's stacked
  clients (the stack padded to a multiple of the axis); after the group
  closes the uploads are all-gathered, so every rank aggregates the same
  full stack and the global models stay replicated;
* ``data`` (optional) — each client's per-step batch splits over the data
  ranks when it divides them.  Losses keep global-batch semantics: the
  model outputs are all-gathered with their gradient before the
  criterion, so masked means divide by the whole batch's valid count and
  the contrastive losses see every pair, and the parameter gradients are
  summed over the data ranks before the optimizer step;
* ``model`` (optional) — Megatron tensor parallelism inside a client's
  group update (:class:`TensorParallel`): each rank holds its shard of the
  ruled leaves (``_TP_RULES``: qkv and fc1 by output column, proj and fc2
  by input row, the word table by vocabulary row), cut when the group
  update starts and all-gathered at the upload; the model ranks of one
  client block and batch rows compute the same replicated activations,
  joined by one all-reduce a sharded sublayer;
* evaluation splits each eval batch over every rank and all-gathers the
  logits and features (with whole weights, as the JAX package shards eval
  batches over the flattened mesh).

Randomness does not depend on the layout: every rank draws the whole
group's tensors from the same generator and keeps its block
(:class:`RankDraws`).  ``--mesh_shape`` / ``--mesh_axes`` pick the layout
by the JAX rules (:meth:`MeshPlan.build`); with neither and more than one
visible device, a 1-D ``clients`` mesh spans them all.
``FEDCOLA_VIRTUAL_DEVICES=k`` makes each card, or the CPU, present ``k``
mesh devices (the counterpart of XLA's
``--xla_force_host_platform_device_count``).

Ranks whose cards are all distinct talk over NCCL; ranks that share a card
or run on the CPU over gloo.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fedcola_tpu_torch.utils.profiling import readback

VALID_AXES = ("clients", "data", "model")
VIRTUAL_DEVICES_ENV = "FEDCOLA_VIRTUAL_DEVICES"
# how long a rank waits on its peers before a collective fails
TIMEOUT = timedelta(minutes=10)


def virtual_devices() -> int:
    """Mesh devices each card (or the CPU) presents."""
    k = int(os.environ.get(VIRTUAL_DEVICES_ENV, "1"))
    if k < 1:
        raise ValueError(f"{VIRTUAL_DEVICES_ENV}={k}: must be at least 1")
    return k


def visible_devices(device_type: str) -> int:
    """The mesh devices this process owns: its cards, or the CPU, times
    ``FEDCOLA_VIRTUAL_DEVICES``."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 1
    return cards * virtual_devices()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------- collectives --
# Each takes an explicit process group, so chip_smoke.py can run them in a
# one-rank NCCL group against the identity.

def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenation along ``dim`` of every rank's ``x`` (equal shapes), in
    rank order of ``group``.  Bools travel as uint8."""
    size = dist.get_world_size(group)
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), group, dim).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _GatherWithGrad(torch.autograd.Function):
    """All-gather whose backward hands each rank the gradient of its own
    slice.  Exact when every rank computes the same function of the
    gathered tensor (the data ranks' losses): the sum of the ranks'
    parameter gradients is then the gradient of that function."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.len = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.len, ctx.len), None, None


def all_gather_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return _GatherWithGrad.apply(x, group, dim)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group) -> List[torch.Tensor]:
    """Elementwise sums over ``group``: one collective per dtype over the
    flattened tensors."""
    out = list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def gather_parts(tensors: Sequence[torch.Tensor],
                 group) -> List[List[torch.Tensor]]:
    """Every rank's copy of each tensor (equal shapes), in rank order of
    ``group``: one all-gather per dtype of the flattened tensors."""
    out: List[List[torch.Tensor]] = [[] for _ in tensors]
    size = dist.get_world_size(group)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        split = [p.split([tensors[i].numel() for i in idx]) for p in parts]
        for j, i in enumerate(idx):
            out[i] = [s[j].view_as(tensors[i]) for s in split]
    return out


def gather_stacks(tensors: Sequence[torch.Tensor],
                  group) -> List[torch.Tensor]:
    """Each tensor's concatenation along dim 0 over ``group``."""
    return [torch.cat(p) for p in gather_parts(tensors, group)]


# ----------------------------------------------------------------- draws --

class RankDraws:
    """A group update's device random stream under a mesh: every rank
    draws the whole group's ``[n, B, ...]`` tensor from the same generator,
    so the stream advances as in one process, and keeps its block: its
    clients of the padded stack (rows past ``n`` are zeros) and its rows of
    the batch."""

    def __init__(self, gen: Optional[torch.Generator], n: int, B: int,
                 clients: slice, batch: slice):
        self.gen, self.n, self.B = gen, n, B
        self.clients, self.batch = clients, batch

    @staticmethod
    def whole(gen: Optional[torch.Generator], n: int, B: int) -> "RankDraws":
        """The draws of one process: the whole ``[n, B, ...]`` tensors."""
        return RankDraws(gen, n, B, slice(0, n), slice(0, B))

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-group ``[n, B, ...]`` tensor."""
        pad = self.clients.stop - full.shape[0]
        if pad > 0:
            full = torch.cat([full, full.new_zeros((pad,) + full.shape[1:])])
        return full[self.clients, self.batch]

    def rand(self, shape, device) -> torch.Tensor:
        """Uniform draws for this rank's ``[n_rank, B_rank, ...]`` tensor."""
        full = torch.rand((self.n, self.B) + tuple(shape[2:]),
                          generator=self.gen, device=device)
        out = self.block(full)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"draw of shape {tuple(shape)} does not match "
                             f"this rank's block {tuple(out.shape)}")
        return out


# ------------------------------------------------------- tensor parallel --

# The Megatron layout of the MAT leaves on the ``model`` axis (the JAX
# ``MeshPlan._TP_RULES``), on client-stacked ``[n, depth, ...]`` trees: the
# dimension a leaf is cut along and the sublayer it belongs to.  qkv and
# fc1 are column-parallel, proj and fc2 row-parallel, each aux copy is cut
# as its kernel, the word table by vocabulary row; every other leaf (the
# LayerNorms, proj_bias, fc2_bias, the aux scales, the heads) is
# replicated.
_TP_RULES = {
    "qkv_kernel": (3, "attn"), "qkv_bias": (2, "attn"),
    "qkv_aux": (3, "attn"), "proj_kernel": (2, "attn"),
    "proj_aux": (2, "attn"),
    "fc1_kernel": (3, "mlp"), "fc1_bias": (2, "mlp"), "fc1_aux": (3, "mlp"),
    "fc2_kernel": (2, "mlp"), "fc2_aux": (2, "mlp"),
    "word": (1, "word"),
}
# Replicated leaves whose gradient each model rank holds only its shard's
# part of, by the sharded sublayer they feed: the aux scales (folded into
# the sharded kernels) and LN2 (inside the MLP sublayer, which takes the
# residual stream through ``enter``).
_PARTIAL_GRADS = {"attn": ("qkv_scale", "proj_scale"),
                  "mlp": ("fc1_scale", "fc2_scale", "norm2_scale",
                          "norm2_bias")}
# q, k and v each span every head: a rank takes its heads of each, three
# strided pieces (the JAX spec cuts the 3D columns contiguously and XLA
# reshards; the attention kernels need q, k and v of the same heads)
_HEAD_ALIGNED = ("qkv_kernel", "qkv_bias", "qkv_aux")


def _named_leaves(tree, name: Optional[str] = None
                  ) -> List[Tuple[Optional[str], torch.Tensor]]:
    """``(key, leaf)`` pairs in sorted-key order (``tree_leaves``'s)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named_leaves(tree[k], k)]
    return [(name, tree)]


def _cut_leaf(name: str, x: torch.Tensor, dim: int, size: int,
              index: int) -> torch.Tensor:
    if name in _HEAD_ALIGNED:
        return x.unflatten(dim, (3, size, -1)).select(dim + 1, index) \
            .flatten(dim, dim + 1)
    per = x.shape[dim] // size
    return x.narrow(dim, index * per, per)


def _merge_leaf(name: str, parts: Sequence[torch.Tensor],
                dim: int) -> torch.Tensor:
    """The whole leaf from every rank's cut, in rank order."""
    if name in _HEAD_ALIGNED:
        return torch.stack([p.unflatten(dim, (3, -1)) for p in parts],
                           dim + 1).flatten(dim, dim + 2)
    return torch.cat(list(parts), dim)


class _Enter(torch.autograd.Function):
    """Megatron's ``f``: identity forward; backward, the sum over the
    model ranks of the gradient (each rank's shard contributes its
    part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum([grad], ctx.group)[0], None


class _Reduce(torch.autograd.Function):
    """Megatron's ``g``: the sum over the model ranks of their partial
    outputs; backward, identity (every rank computes the same function of
    the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum([x], group)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's share of the ``model`` axis for one model configuration.
    A sublayer is sharded when its width divides the axis: the attention
    by head (``H % size == 0``; each rank runs its ``H / size`` heads), the
    MLP by hidden column (``F % size == 0``), the word table by vocabulary
    row (``V % size == 0``); otherwise its leaves stay whole on every model
    rank.  ``group``: the model ranks of this rank's client block and batch
    rows, ``index`` this rank's place among them."""
    size: int
    index: int
    group: object
    attn: bool
    mlp: bool
    word: bool

    @staticmethod
    def build(cfg, size: int, index: int, group) -> "TensorParallel":
        if getattr(cfg, "block", "vit") != "vit":
            raise NotImplementedError(
                f"the model axis shards the ViT block; the {cfg.block} "
                f"block runs without it")
        return TensorParallel(size, index, group,
                              cfg.num_heads % size == 0,
                              cfg.hidden_dim % size == 0,
                              cfg.vocab_size % size == 0)

    def describe(self, cfg) -> str:
        def say(on, what, whole):
            return what if on else f"{whole} replicated"
        return ", ".join((
            say(self.attn, f"attention by head ({cfg.num_heads // self.size}"
                f" of {cfg.num_heads} a rank)",
                f"attention ({cfg.num_heads} heads)"),
            say(self.mlp, f"MLP hidden {cfg.hidden_dim // self.size} of "
                f"{cfg.hidden_dim} a rank", f"MLP ({cfg.hidden_dim})"),
            say(self.word, f"word table {cfg.vocab_size // self.size} of "
                f"{cfg.vocab_size} rows a rank",
                f"word table ({cfg.vocab_size} rows)")))

    def dim(self, name: Optional[str]) -> Optional[int]:
        """The dimension a leaf of a stacked tree is cut along, or None
        when it is replicated."""
        rule = _TP_RULES.get(name)
        if rule is None or not getattr(self, rule[1]):
            return None
        return rule[0]

    def cut(self, tree, lead: int = 1):
        """This rank's shard of every sharded leaf of a client-stacked tree
        (``lead=1``) or of an unstacked one (``lead=0``), each a new
        contiguous tensor; replicated leaves as they are."""
        def walk(t, name):
            if isinstance(t, dict):
                return {k: walk(v, k) for k, v in t.items()}
            d = self.dim(name)
            if d is None:
                return t
            return _cut_leaf(name, t, d - 1 + lead, self.size, self.index
                             ).clone(memory_format=torch.contiguous_format)
        return walk(tree, None)

    def join(self, tree):
        """The whole client-stacked tree on every model rank, from each
        rank's shards (one all-gather per dtype)."""
        named = _named_leaves(tree)
        idx = [i for i, (k, _) in enumerate(named) if self.dim(k) is not None]
        leaves = [t for _, t in named]
        for i, parts in zip(idx, gather_parts([leaves[i] for i in idx],
                                              self.group)):
            leaves[i] = _merge_leaf(named[i][0], parts, self.dim(named[i][0]))
        return _rebuild(tree, iter(leaves))

    def replicated(self, tree):
        """The tree less its sharded leaves: what every model rank holds
        whole."""
        return {k: self.replicated(v) if isinstance(v, dict) else v
                for k, v in tree.items()
                if isinstance(v, dict) or self.dim(k) is None}

    def sums_grad(self, name: Optional[str]) -> bool:
        """Whether a replicated leaf feeds a sharded sublayer, so that a
        model rank's gradient of it is a partial sum (``_PARTIAL_GRADS``)."""
        return any(getattr(self, part) and name in ns
                   for part, ns in _PARTIAL_GRADS.items())

    def sum_partial_grads(self, tree, grads: List[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """``grads`` (in ``tree_leaves`` order of ``tree``) with the
        gradients of the replicated leaves that feed a sharded sublayer
        (``_PARTIAL_GRADS``) summed over the model ranks."""
        idx = [i for i, (k, _) in enumerate(_named_leaves(tree))
               if self.sums_grad(k)]
        out = list(grads)
        for i, g in zip(idx, all_reduce_sum([grads[i] for i in idx],
                                            self.group) if idx else []):
            out[i] = g
        return out

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f`` on the input of a sharded sublayer."""
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``g``: the sum of the model ranks' partials."""
        return _Reduce.apply(x, self.group)


# ------------------------------------------------------------------ plan --

@dataclass(frozen=True)
class _Groups:
    world: object          # every rank: evaluation, replication
    clients: object        # the ranks of this rank's data and model index
    data: object           # the ranks of this rank's clients and model index
    backend: str
    why: str               # the backend's reason, for the log
    device: str
    model: object = None   # the ranks of this rank's clients and data index


@dataclass(frozen=True)
class MeshPlan:
    """A (possibly absent) device mesh and the layout rules the servers,
    the evaluators and the dry run use.  ``shape`` None: no mesh, and every
    method is the single-device identity.  A plan with a mesh is joined to
    its process group by :meth:`Launch.join`; ``rank`` orders the devices
    clients-major, as ``np.reshape`` lays out the JAX mesh ``[c, d, m]``:
    ``rank = (ci * d + di) * m + mi``."""

    shape: Optional[Tuple[int, ...]] = None
    axes: Tuple[str, ...] = ()
    rank: int = 0
    groups: Optional[_Groups] = None

    # ------------------------------------------------------------ factory --
    @staticmethod
    def build(mesh_shape: Optional[Sequence[int]] = None,
              mesh_axes: Optional[Sequence[str]] = None,
              n_visible: int = 1) -> "MeshPlan":
        """The layout ``--mesh_shape`` / ``--mesh_axes`` ask for over
        ``n_visible`` devices, by the rules of the JAX ``MeshPlan.build``."""
        if mesh_shape:
            axes = list(mesh_axes or ())
            if len(axes) != len(mesh_shape):
                if not axes or axes == ["clients"]:   # unset / CLI default
                    axes = list(VALID_AXES[:len(mesh_shape)])
                else:
                    raise ValueError(f"mesh_axes {axes} does not match "
                                     f"mesh_shape {list(mesh_shape)}")
            for a in axes:
                if a not in VALID_AXES:
                    raise ValueError(f"unknown mesh axis {a!r}; "
                                     f"valid: {VALID_AXES}")
            if "clients" not in axes:
                raise ValueError("mesh_axes must include 'clients'")
            n = int(np.prod(mesh_shape))
            if n > n_visible:
                raise ValueError(f"mesh_shape {list(mesh_shape)} needs {n} "
                                 f"devices but only {n_visible} are visible")
            if n == 1:
                return MeshPlan()
            return MeshPlan(tuple(int(s) for s in mesh_shape), tuple(axes))
        if mesh_axes and list(mesh_axes) != ["clients"]:
            raise ValueError(
                f"--mesh_axes {list(mesh_axes)} requires --mesh_shape "
                "(one size per axis)")
        if n_visible > 1:
            return MeshPlan((n_visible,), ("clients",))
        return MeshPlan()

    # --------------------------------------------------------- properties --
    def _axis(self, name: str) -> int:
        if self.shape is None or name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape)) if self.shape is not None else 1

    @property
    def clients_axis(self) -> int:
        return self._axis("clients")

    @property
    def data_axis(self) -> int:
        return self._axis("data")

    @property
    def model_axis(self) -> int:
        """Tensor-parallel axis size (1 = TP off)."""
        return self._axis("model")

    @property
    def mesh_dict(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape or ()))

    @property
    def is_multiprocess(self) -> bool:
        return self.n_devices > 1

    @property
    def backend(self) -> Optional[str]:
        return self.groups.backend if self.groups is not None else None

    def describe(self) -> str:
        g = self.groups
        return (f"{self.mesh_dict} over {self.n_devices} devices, rank "
                f"{self.rank} on {g.device}, backend {g.backend} ({g.why})")

    # ------------------------------------------------------------ padding --
    def pad_clients(self, n: int) -> int:
        """Stacked client axes pad to a multiple of the clients axis."""
        m = self.clients_axis
        return ((n + m - 1) // m) * m

    def pad_eval_batch(self, b: int) -> int:
        """Eval batches pad to a multiple of the device count."""
        m = self.n_devices
        return ((b + m - 1) // m) * m

    # ------------------------------------------------------ rank's share --
    def client_rows(self, n: int) -> slice:
        """This rank's block of a group's ``n`` stacked clients, in the
        padded stack's coordinates (it may reach past ``n``)."""
        per = self.pad_clients(n) // self.clients_axis
        ci = self.rank // (self.data_axis * self.model_axis)
        return slice(ci * per, (ci + 1) * per)

    def splits_batch(self, B: int) -> bool:
        """Whether a per-step batch of ``B`` rows splits over the data
        axis (it stays whole on every data rank when it does not divide)."""
        return self.data_axis > 1 and B % self.data_axis == 0

    def batch_rows(self, B: int) -> slice:
        if not self.splits_batch(B):
            return slice(0, B)
        per = B // self.data_axis
        di = self.rank // self.model_axis % self.data_axis
        return slice(di * per, (di + 1) * per)

    def batch_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a ``[B, ...]`` batch that every client of a
        group shares (CreamFL's public batches)."""
        return x[self.batch_rows(x.shape[0])]

    def local_chunk(self, chunk: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """A training chunk ``[n, S, B, ...]`` cut to this rank: its clients
        of the padded stack (padding clients are zero rows with every step
        masked off) and, for arrays with a batch axis (axis 2), its batch
        rows."""
        n = chunk["step_valid"].shape[0]
        rows = self.client_rows(n)
        out = {}
        for k, v in chunk.items():
            if rows.stop > n:
                v = np.concatenate(
                    [v, np.zeros((rows.stop - n,) + v.shape[1:], v.dtype)])
            v = v[rows]
            if v.ndim > 2:
                v = v[:, :, self.batch_rows(v.shape[2])]
            out[k] = v
        return out

    def draws(self, gen: torch.Generator, n: int, B: int) -> RankDraws:
        """What a rank's group update draws from ``gen``: the whole
        group's tensors, of which it keeps its block (without a mesh, all
        of them).  The model ranks of one block keep the same one, so the
        replicated activations see the same DropPath and dropout."""
        return RankDraws(gen, n, B, self.client_rows(n), self.batch_rows(B))

    def tensor_parallel(self, cfg) -> Optional[TensorParallel]:
        """This rank's share of the ``model`` axis for a model
        configuration (``models.mat.MATConfig``); None without the axis."""
        if self.model_axis == 1:
            return None
        return TensorParallel.build(cfg, self.model_axis,
                                    self.rank % self.model_axis,
                                    self.groups.model if self.groups
                                    else None)

    # -------------------------------------------------------- collectives --
    def gather_clients(self, tree, n: int):
        """A tree (or tensor) of this rank's ``[n_rank, ...]`` client block
        -> the group's ``[n, ...]`` stack on every rank (padding dropped)."""
        if self.shape is None:
            return tree
        from fedcola_tpu_torch.models.mat import tree_leaves
        leaves = tree_leaves(tree)
        full = iter(t[:n] for t in gather_stacks(leaves, self.groups.clients))
        return _rebuild(tree, full)

    def to_host(self, x: torch.Tensor, n: int) -> np.ndarray:
        """A client-stacked ``[n_rank]`` tensor's whole ``[n]`` stack on the
        host (the JAX ``to_host`` of a clients-sharded array)."""
        return self.gather_clients(x, n).cpu().numpy()

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``[n, B_rank, ...]`` rows -> the whole per-step batch
        ``[n, B, ...]``, carrying the gradient back to this rank's rows."""
        if x.requires_grad:
            return all_gather_grad(x, self.groups.data, dim=1)
        return all_gather(x, self.groups.data, dim=1)

    def sum_over_data(self, tensors: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Per-rank partial gradients -> their sum over the data ranks."""
        return all_reduce_sum(tensors, self.groups.data)

    def eval_rows(self, fwd: Callable, idx: np.ndarray):
        """``fwd(idx)`` (row indices -> a tensor or tuple of ``[rows, ...]``
        tensors) with the rows split over every rank and the outputs
        all-gathered; identical to ``fwd(idx)`` without a mesh."""
        if self.shape is None:
            return fwd(idx)
        from fedcola_tpu_torch.utils.dispatch import pad_batch_indices
        n = len(idx)
        per = self.pad_eval_batch(n) // self.n_devices
        full = pad_batch_indices(np.asarray(idx), per * self.n_devices)
        out = fwd(full[self.rank * per:(self.rank + 1) * per])
        gather = lambda t: all_gather(t, self.groups.world)[:n]  # noqa: E731
        return tuple(map(gather, out)) if isinstance(out, tuple) \
            else gather(out)

    def check_replicated(self, trees: Dict[str, object],
                         group=None) -> None:
        """Fail when the ranks' copies of replicated state differ (the JAX
        ``ensure_addressable`` makes them one array; here every rank
        computes them from the same gathered uploads, so they never
        should): one exact digest per tree, the 64-bit sum of its bits,
        all-gathered over ``group`` (every rank by default)."""
        if self.shape is None:
            return
        from fedcola_tpu_torch.models.mat import tree_leaves
        names = sorted(trees)
        digest = torch.stack([sum(_bit_sum(t) for t in tree_leaves(trees[k]))
                              for k in names])
        every = all_gather(digest[None], group or self.groups.world)
        with readback():
            bad = [k for j, k in enumerate(names)
                   if not bool((every[:, j] == every[0, j]).all())]
        if bad:
            raise RuntimeError(f"mesh ranks hold different copies of {bad} "
                               f"(rank digests {every.tolist()})")

    def gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if self.shape is None:
            return [obj]
        out = [None] * self.n_devices
        dist.all_gather_object(out, obj)
        return out

    def check_same_round(self, rnd: int, ckpt_dir: str) -> None:
        """Fail loudly when the ranks resumed from different rounds (a
        checkpoint directory some ranks cannot see): mismatched collective
        programs would hang or corrupt (root ``main.py``'s multi-host
        resume check)."""
        rounds = self.gather_object(int(rnd))
        if min(rounds) != max(rounds):
            raise RuntimeError(
                f"mesh resume mismatch: ranks see checkpoints at rounds "
                f"{sorted(set(rounds))} — --result_path must be storage "
                f"every rank can read (each loads {ckpt_dir})")

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _bit_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor's elements read as integers of their width,
    in int64: order-free and exact."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(ints[t.element_size()]).sum(
        dtype=torch.int64)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


# ---------------------------------------------------------------- launch --

@dataclass(frozen=True)
class Launch:
    """Where this process's ranks sit in a mesh run: ranks ``first_rank``
    to ``first_rank + local - 1`` of ``world``, meeting at
    ``init_method``."""
    plan: MeshPlan
    first_rank: int
    local: int
    init_method: str
    device_type: str

    @property
    def world(self) -> int:
        return self.plan.n_devices

    def join(self, local_index: int) -> MeshPlan:
        """Join rank ``first_rank + local_index`` to the process group: pick
        its device (card ``local_index mod cards``), choose the backend and
        build the clients, data and model groups.  Returns the joined
        plan."""
        rank = self.first_rank + local_index
        if self.device_type == "cuda":
            card = local_index % torch.cuda.device_count()
            torch.cuda.set_device(card)
            who = (socket.gethostname(),
                   str(torch.cuda.get_device_properties(card).uuid))
        else:
            who = (socket.gethostname(), f"cpu:{local_index}")
        dist.init_process_group("gloo", init_method=self.init_method,
                                world_size=self.world, rank=rank,
                                timeout=TIMEOUT)
        ids = [None] * self.world
        dist.all_gather_object(ids, who)
        # NCCL needs a card per rank; gloo takes CPU tensors and, through
        # host staging of its own, CUDA ones
        nccl = self.device_type == "cuda" and len(set(ids)) == self.world
        backend = "nccl" if nccl else "gloo"
        plan = self.plan
        c, d, m = plan.clients_axis, plan.data_axis, plan.model_axis
        at = np.arange(c * d * m).reshape(c, d, m)   # rank of (ci, di, mi)

        world = dist.new_group(list(range(self.world)), backend=backend,
                               timeout=TIMEOUT) if nccl else dist.group.WORLD
        groups = []
        # every rank creates every group, in the same order: along each
        # axis, the ranks that share the other two indices
        for axis in range(3):
            lines = np.moveaxis(at, axis, -1).reshape(-1, at.shape[axis])
            for ranks in lines.tolist():
                g = dist.new_group(ranks, backend=backend, timeout=TIMEOUT)
                if rank in ranks:
                    groups.append(g)
        clients, data, model = groups
        why = ("one card per rank" if nccl else
               "ranks on the CPU" if self.device_type == "cpu"
               else "ranks share a card")
        device = f"cuda:{torch.cuda.current_device()}" \
            if self.device_type == "cuda" else "cpu"
        return MeshPlan(plan.shape, plan.axes, rank,
                        _Groups(world, clients, data, backend, why, device,
                                model))


def plan_launch(cfg, device_type: str) -> Optional[Launch]:
    """The launch a configuration asks for, validated before any rank
    starts; None for a one-device run without ``--dist_*``.

    One host: ``--mesh_shape`` (or more than one visible device) starts
    one rank per mesh device.  ``--dist_*``: each process owns its visible
    devices, its ranks are ``process_id x local + i``, and the mesh must
    span every process's devices."""
    k = visible_devices(device_type)
    multi = cfg.dist_coordinator is not None
    n_visible = k * (cfg.dist_num_processes if multi else 1)
    plan = MeshPlan.build(cfg.mesh_shape, cfg.mesh_axes, n_visible)
    if not multi and plan.shape is None:
        return None
    if not multi:
        return Launch(plan, 0, plan.n_devices,
                      f"tcp://127.0.0.1:{free_port()}", device_type)
    if plan.n_devices != n_visible:
        raise ValueError(
            f"a --dist_* mesh must span every process's devices: mesh "
            f"{plan.mesh_dict or {'clients': 1}} has {plan.n_devices}, the "
            f"{cfg.dist_num_processes} processes own {n_visible}")
    if plan.shape is None:      # one process, one device
        plan = MeshPlan((1,), ("clients",))
    return Launch(plan, cfg.dist_process_id * k, k,
                  f"tcp://{cfg.dist_coordinator}", device_type)
