"""Faults planted in the program's timed path, for the checks that the
comparison fails them (``tests/test_portbench_faults.py`` on the CPU,
``control.py --fault`` on the card).  Each is a context manager that
patches the program while it is open.

* ``frozen``: a local step returns its state unchanged (no optimizer
  update).
* ``half``: half of every training batch left out, the loss the mean over
  the rest.
* ``answer``: one answer of every evaluation batch altered where it is
  produced (a classification row's logits shifted by one class, a
  retrieval feature replaced by its neighbour's).
"""

from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("frozen", "half", "answer")


def _half(fn):
    def wrapped(a, b, valid=None):
        import torch
        if valid is None:
            valid = torch.ones(a.shape[:-1], dtype=torch.bool,
                               device=a.device)
        keep = torch.cumsum(valid.long(), -1) <= \
            (valid.sum(-1, keepdim=True) + 1) // 2
        return fn(a, b, valid & keep)
    return wrapped


@contextmanager
def planted(name: str):
    import torch
    from fedcola_tpu_torch.eval import retrieval
    from fedcola_tpu_torch.federation import server
    from fedcola_tpu_torch.ops import losses
    from fedcola_tpu_torch.parallel import client_update

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "frozen":
        patch(client_update, "descend", lambda *a, **k: None)
    elif name == "half":
        patch(losses, "cross_entropy", _half(losses.cross_entropy))
        patch(losses, "clip_contrastive", _half(losses.clip_contrastive))
    elif name == "answer":
        fwd, tower = server.eval_forward, retrieval._tower

        def eval_forward(*a, **k):
            out = fwd(*a, **k)
            if torch.is_tensor(out):
                out = out.clone()
                out[0] = torch.roll(out[0], 1)
            return out

        def _tower(*a, **k):
            out = tower(*a, **k).clone()
            out[0] = out[-1]
            return out

        patch(server, "eval_forward", eval_forward)
        patch(retrieval, "_tower", _tower)
    else:
        raise ValueError(f"unknown fault {name!r}; {FAULTS}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
