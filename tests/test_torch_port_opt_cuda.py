"""The fused optimizer step (``csrc/opt_update.cu`` through
``parallel/optim.py`` ``opt_update``) against its plain version
(``opt_update_plain``, the eager loop) on the card: AdamW, Adam, SGD with
and without momentum and nesterov; float32 and bfloat16 moments; n = 1, 2
and 3 clients; per-client sizes 1, 3, 4, 100, 384 and 30522 * 384 (BERT's
word embedding at D = 384) with a frozen leaf; 20 steps under per-client
``step_valid`` patterns.  Parameters and moments agree within 1e-6 of
max|ref| per leaf (the port's AdamW tolerance), the counters exactly; a
masked client's and a frozen leaf's parameters, moments and counters stay
bitwise untouched; a repeat gives the same bits; each step is one call of
the entry point.  Also: a leaf whose base is not 16-byte aligned (the
scalar path), a strided mask, more leaves than one table holds, and the
wrapper's refusals.

Marked ``cuda``: every test skips without a CUDA device.  This file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_opt_cuda.py
"""

import numpy as np
import pytest
import torch

from fedcola_tpu_torch.models.mat import tree_leaves, tree_map
from fedcola_tpu_torch.ops import kernels
from fedcola_tpu_torch.parallel import optim

pytestmark = pytest.mark.cuda
SIZES = (1, 3, 4, 100, 384, 30522 * 384)
FROZEN = 2                   # the leaf of 4 elements a client
SPECS = {
    "adamw": dict(name="AdamW", weight_decay=0.05),
    "adamw_bf16": dict(name="AdamW", weight_decay=0.05,
                       moment_dtype="bfloat16"),
    "adam": dict(name="Adam", weight_decay=0.05),
    "adam_bf16": dict(name="Adam", weight_decay=0.05,
                      moment_dtype="bfloat16"),
    "sgd": dict(name="SGD", weight_decay=0.05),
    "sgd_momentum": dict(name="SGD", weight_decay=0.05, momentum=0.9),
    "sgd_nesterov": dict(name="SGD", weight_decay=0.05, momentum=0.9,
                         nesterov=True),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _group(spec, n, dev, sizes=SIZES, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {f"l{i}": torch.randn(n, e, device=dev, generator=gen)
              for i, e in enumerate(sizes)}
    return params, optim.init_opt_state(spec, params, n)


def _clone(tree):
    return tree_map(lambda a: a.clone(), tree)


def _masks(n, steps):
    """Per step, which clients step: all, then patterns that leave out
    each client in turn, and none at all."""
    out = []
    for s in range(steps):
        if s % 5 == 0:
            out.append([True] * n)
        elif s % 5 == 4:
            out.append([False] * n)
        else:
            out.append([(c + s) % 3 != 0 for c in range(n)])
    return out


def _agree(got, ref, what):
    for path, g, r in zip(what, tree_leaves(got), tree_leaves(ref)):
        if g.dtype == torch.int32:
            assert torch.equal(g, r), path
            continue
        g, r = g.float(), r.float()
        d = (g - r).abs().max().item()
        assert d <= 1e-6 * r.abs().max().item(), (path, d)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("rule", list(SPECS))
def test_kernel_matches_the_plain_loop(dev, rule, n):
    spec = optim.OptimizerSpec(**SPECS[rule])
    params, state = _group(spec, n, dev)
    ref_p, ref_s = _clone(params), _clone(state)
    frozen = {k: k == f"l{FROZEN}" for k in params}
    gen = torch.Generator(device=dev).manual_seed(1)
    names = sorted(params)
    kernels.reset_launches()
    for s, mask in enumerate(_masks(n, 20)):
        grads = {k: torch.randn(p.shape, device=dev, generator=gen)
                 for k, p in params.items()}
        sv = torch.tensor(mask, device=dev)
        before = (_clone(params), _clone(state))
        optim.opt_update(spec, params, grads, state, 1e-2, frozen, sv)
        optim.opt_update_plain(spec, ref_p, grads, ref_s, 1e-2, frozen, sv)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["opt_update"] == s + 1
        _agree(params, ref_p, names)
        for key in state:
            _agree(state[key], ref_s[key], [f"{key}/{k}" for k in names])
        for k in names:
            for c in range(n):
                if k == f"l{FROZEN}" or not mask[c]:
                    assert torch.equal(params[k][c], before[0][k][c])
                    for key in state:
                        assert torch.equal(state[key][k][c],
                                           before[1][key][k][c]), (key, k)
    # every unfrozen counter counts the steps its client ran
    runs = np.array(_masks(n, 20)).sum(0)
    assert state["t"][f"l{FROZEN}"].tolist() == [0] * n
    assert state["t"]["l0"].tolist() == runs.tolist()


@pytest.mark.parametrize("rule", ["adamw", "adamw_bf16", "sgd_nesterov"])
def test_a_repeat_gives_the_same_bits(dev, rule):
    spec = optim.OptimizerSpec(**SPECS[rule])
    runs = []
    for _ in range(2):
        params, state = _group(spec, 3, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        for mask in _masks(3, 6):
            grads = {k: torch.randn(p.shape, device=dev, generator=gen)
                     for k, p in params.items()}
            optim.opt_update(spec, params, grads, state, 1e-2,
                             step_valid=torch.tensor(mask, device=dev))
        runs.append(tree_leaves(params) + tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("rule", ["adamw", "adam_bf16", "sgd_momentum"])
def test_misaligned_leaf_strided_mask_and_two_tables(dev, rule):
    """A parameter at a base 4 bytes past 16-byte alignment (the scalar
    path), the mask as a column of the chunk's ``[n, S]`` step_valid, and
    50 leaves: two calls a step."""
    spec = optim.OptimizerSpec(**SPECS[rule])
    n = 2
    sizes = [(i % 5) * 4 + 1 + i % 2 for i in range(49)]
    params, state = _group(spec, n, dev, sizes)
    base = torch.randn(n * 12 + 1, device=dev)
    params["mis"] = base[1:].view(n, 12)
    assert params["mis"].data_ptr() % 16 == 4
    state = optim.init_opt_state(spec, params, n)
    ref_p, ref_s = _clone(params), _clone(state)
    chunk_sv = torch.tensor([[True, False, True], [True, True, False]],
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels.reset_launches()
    for s in range(chunk_sv.shape[1]):
        grads = {k: torch.randn(p.shape, device=dev, generator=gen)
                 for k, p in params.items()}
        optim.opt_update(spec, params, grads, state, 1e-2,
                         step_valid=chunk_sv[:, s])
        optim.opt_update_plain(spec, ref_p, grads, ref_s, 1e-2,
                               step_valid=chunk_sv[:, s])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["opt_update"] == 2 * chunk_sv.shape[1]
    names = sorted(params)
    _agree(params, ref_p, names)
    for key in state:
        _agree(state[key], ref_s[key], [f"{key}/{k}" for k in names])


def test_the_wrapper_refuses_what_the_kernel_does_not_take(dev):
    spec = optim.OptimizerSpec(**SPECS["adamw"])
    for fault in ("strided", "float64", "bfloat16"):
        params, state = _group(spec, 2, dev, (8, 12))
        if fault == "strided":
            params["l1"] = params["l1"].view(2, 3, 4).transpose(1, 2)
            state = optim.init_opt_state(spec, params, 2)
            state["m"]["l1"] = state["m"]["l1"].contiguous()
            state["v"]["l1"] = state["v"]["l1"].contiguous()
        else:
            params["l1"] = params["l1"].to(getattr(torch, fault))
        grads = tree_map(lambda p: torch.ones_like(p), params)
        with pytest.raises((TypeError, ValueError)):
            optim.opt_update(spec, params, grads, state, 1e-2)
