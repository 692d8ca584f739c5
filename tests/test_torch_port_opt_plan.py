"""The fused optimizer step's work table (``parallel/optim.py``
``plan_opt_segments``, ``opt_launches``; the kernel is
``csrc/opt_update.cu``), assembled on CPU tensors:

* every element of every non-frozen (leaf, client) segment is covered by
  exactly one block's tile, no tile spans two segments, frozen and empty
  leaves are absent, segments whose per-client size is not a multiple of 4
  are flagged for the scalar path, and a table holds at most
  ``OPT_MAX_LEAVES`` leaves;
* the arguments match the ctypes signature; each table row points at its
  leaf's parameter, gradient, moments and counters; a group's table is
  packed once and only the gradients' column changes between steps;
* the wrapper refuses parameters or state that are not contiguous, of the
  wrong dtype, or a step mask it cannot index;
* CPU tensors take the plain loop: no launch, no ``opt_fused`` count, the
  plain version's bits.
"""

import numpy as np
import pytest
import torch

from fedcola_tpu_torch.models.mat import tree_leaves, tree_map
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.parallel import optim
from fedcola_tpu_torch.utils import profiling

T = optim.OPT_TILE
# per-client sizes: a head bias of 4 classes, odd sizes, one tile exactly,
# a ragged multi-tile leaf, BERT's word embedding at D = 384
SIZES = [1, 3, 4, 100, 384, T, T + 3, 3 * T + 4, 30522 * 384]


def _block_segment(rows, n, numels, b):
    """Block ``b`` of a launch's ``rows`` as ``csrc/opt_update.cu`` maps it
    (binary search over the first blocks): (leaf, client, first element,
    end element) of its tile."""
    lo, hi = 0, len(rows) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        lo, hi = (mid, hi) if rows[mid][2] <= b else (lo, mid - 1)
    leaf, tiles, first, _ = rows[lo]
    c, tile = divmod(b - first, tiles)
    start = tile * T
    return leaf, c, start, min(start + T, numels[leaf])


def _covered(numels, n, frozen):
    """Each launch's blocks, mapped as the kernel maps them: (leaf, client)
    -> the tile ranges, in block order."""
    seen = {}
    for rows in optim.plan_opt_segments(numels, n, frozen):
        assert 1 <= len(rows) <= optim.OPT_MAX_LEAVES
        leaf, tiles, first, _ = rows[-1]
        blocks = first + n * tiles
        assert rows[0][2] == 0
        for b in range(blocks):
            leaf, c, start, end = _block_segment(rows, n, numels, b)
            assert 0 <= c < n and 0 <= start < end <= numels[leaf]
            assert end - start <= T
            seen.setdefault((leaf, c), []).append((start, end))
    return seen


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("frozen_at", [None, 0, 4, 8])
def test_every_element_is_covered_once(n, frozen_at):
    frozen = None if frozen_at is None else [
        i == frozen_at for i in range(len(SIZES))]
    seen = _covered(SIZES, n, frozen)
    want = {(i, c) for i in range(len(SIZES)) for c in range(n)
            if frozen is None or not frozen[i]}
    assert set(seen) == want
    for (leaf, c), ranges in seen.items():
        # the tiles of one segment, in order, end to end: each element once
        assert ranges[0][0] == 0 and ranges[-1][1] == SIZES[leaf]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_frozen_and_empty_leaves_are_absent():
    numels = [8, 0, 12, 5]
    rows = optim.plan_opt_segments(numels, 2, [False, False, True, False])
    assert [r[0] for r in rows[0]] == [0, 3]


def test_misaligned_segments_take_the_scalar_path():
    rows = optim.plan_opt_segments(SIZES, 3)[0]
    assert {leaf: vec for leaf, _, _, vec in rows} == {
        i: e % 4 == 0 for i, e in enumerate(SIZES)}


@pytest.mark.parametrize("leaves", [47, 48, 49, 100])
def test_a_launch_holds_at_most_the_table_s_leaves(leaves):
    numels = [(i % 7) * 13 + 1 for i in range(leaves)]
    launches = optim.plan_opt_segments(numels, 2)
    assert len(launches) == -(-leaves // optim.OPT_MAX_LEAVES)
    assert [r[0] for rows in launches for r in rows] == list(range(leaves))
    seen = _covered(numels, 2, None)
    assert len(seen) == 2 * leaves


def _table(args):
    """The packed table a launch's arguments point to."""
    for _, tables in optim._TABLES.values():
        for table, _ in tables:
            if table.ctypes.data == args[4]:
                return table
    raise AssertionError("no packed table at the launch's address")


def _group(spec, n=2, r=None):
    r = r or np.random.RandomState(0)
    shapes = {"a": (n, 3, 4), "b": {"c": (n, 5), "d": (n, 2, 2)},
              "e": (n, 1)}
    params = tree_map(
        lambda s: torch.from_numpy(r.randn(*s).astype(np.float32)), shapes)
    return params, optim.init_opt_state(spec, params, n)


def _grads(params, seed):
    r = np.random.RandomState(seed)
    return tree_map(lambda p: torch.from_numpy(
        r.randn(*p.shape).astype(np.float32)), params)


SPECS = [optim.OptimizerSpec(name="AdamW", weight_decay=0.05),
         optim.OptimizerSpec(name="Adam", moment_dtype="bfloat16"),
         optim.OptimizerSpec(name="SGD", momentum=0.9, nesterov=True)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_arguments_point_at_each_leaf(spec):
    params, state = _group(spec)
    frozen = {"a": False, "b": {"c": True, "d": False}, "e": False}
    sv = torch.tensor([[True, False], [False, True]])[:, 1]   # strided
    grads = _grads(params, 1)
    launches, held = optim.opt_launches(spec, params, grads, state, 1e-3,
                                        frozen, sv)
    sig = kernels._SIGNATURES["fc_opt_update"]
    assert len(launches) == 1 and len(launches[0]) + 1 == len(sig)
    args = launches[0]
    sgd = spec.name == "SGD"
    assert args[:4] == [{"AdamW": 0, "Adam": 1, "SGD": 2}[spec.name],
                        int(spec.moment_dtype == "bfloat16"), 3, 2]
    assert args[5:7] == [sv.data_ptr(), 2]
    assert args[7:16] == [1e-3, spec.beta1, 1 - spec.beta1, spec.beta2,
                          1 - spec.beta2, spec.eps, spec.weight_decay,
                          1 - 1e-3 * spec.weight_decay, spec.momentum]
    assert args[16] == int(spec.nesterov)
    I, P, F = kernels._I, kernels._P, kernels._F
    assert sig == [I] * 4 + [P, P, I] + [F] * 9 + [I, P]
    table = _table(args)
    paths = [("a",), ("b", "d"), ("e",)]
    get = optim._get
    for row, path in zip(table, paths):
        p = get(params, path)
        want = [p.data_ptr(), get(grads, path).data_ptr(),
                get(state["b" if sgd else "m"], path).data_ptr(),
                0 if sgd else get(state["v"], path).data_ptr(),
                get(state["t"], path).data_ptr(), p[0].numel()]
        assert list(row[:6]) == want
    assert [g.data_ptr() for g in held] == list(table[:, optim._G])


def test_the_table_is_packed_once_a_group():
    spec = SPECS[0]
    params, state = _group(spec)
    first, _ = optim.opt_launches(spec, params, _grads(params, 1), state,
                                  1e-3)
    table = _table(first[0])
    grads = _grads(params, 2)
    again, _ = optim.opt_launches(spec, params, grads, state, 1e-3)
    assert _table(again[0]) is table
    assert list(table[:, optim._G]) == [
        g.data_ptr() for g in tree_leaves(grads)]
    # another group: its own table
    other, ostate = _group(spec)
    new, _ = optim.opt_launches(spec, other, _grads(other, 3), ostate, 1e-3)
    assert _table(new[0]) is not table


def test_a_non_contiguous_gradient_is_made_contiguous():
    spec = SPECS[0]
    params, state = _group(spec)
    grads = _grads(params, 1)
    grads["a"] = grads["a"].transpose(1, 2).contiguous().transpose(1, 2)
    _, held = optim.opt_launches(spec, params, grads, state, 1e-3)
    assert held[0].is_contiguous() and torch.equal(held[0], grads["a"])


@pytest.mark.parametrize("fault", [
    "param_strided", "param_float64", "param_bfloat16", "moment_dtype",
    "counter_dtype", "mask_dtype", "mask_shape"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    spec = SPECS[0]
    params, state = _group(spec)
    sv = torch.ones(2, dtype=torch.bool)
    if fault == "param_strided":
        params["a"] = params["a"].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "param_float64":
        params["a"] = params["a"].double()
    elif fault == "param_bfloat16":
        params["a"] = params["a"].bfloat16()
    elif fault == "moment_dtype":
        state["m"]["a"] = state["m"]["a"].bfloat16()
    elif fault == "counter_dtype":
        state["t"]["a"] = state["t"]["a"].long()
    elif fault == "mask_dtype":
        sv = sv.int()
    else:
        sv = torch.ones(3, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        optim.opt_launches(spec, params, _grads(params, 1), state, 1e-3,
                           step_valid=sv)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_cpu_tensors_take_the_plain_loop(spec):
    params, state = _group(spec)
    ref_p, ref_s = _group(spec)
    sv = torch.tensor([True, False])
    kernels.reset_launches()
    timer = profiling.Timer()
    with timer.recording():
        for seed in range(3):
            optim.opt_update(spec, params, _grads(params, seed), state, 1e-2,
                             step_valid=sv)
            optim.opt_update_plain(spec, ref_p, _grads(ref_p, seed), ref_s,
                                   1e-2, step_valid=sv)
    assert timer.counters["opt_fused"] == 0
    assert not any(kernels.LAUNCHES.values())
    for a, b in zip(tree_leaves(params) + tree_leaves(state),
                    tree_leaves(ref_p) + tree_leaves(ref_s)):
        assert torch.equal(a, b)
