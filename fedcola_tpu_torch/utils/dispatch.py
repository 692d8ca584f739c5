"""Fixed-size batches from ragged index ranges, and windowed dispatch-ahead
for device -> host readback loops (port of
``fedcola_tpu/utils/dispatch.py``).

CUDA work is queued asynchronously: an eval loop that reads each batch
back as soon as it is queued waits for the device every batch, while
queuing every batch first holds every batch's inputs and outputs in
device memory at once.  ``DispatchWindow`` bounds the number of queued
but unread batches.  The central eval and the client-by-client
local-eval path use it.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np

# batches queued ahead of the host readback
EVAL_INFLIGHT = 8


def pad_batch_indices(idx, B: int):
    """Pad a partial batch's index vector to the batch size ``B`` by
    repeating its first row; readers mask or trim the rows past
    ``len(idx)``."""
    if len(idx) == 0:
        raise ValueError("pad_batch_indices needs a non-empty index vector "
                         "(there is no row to repeat as padding)")
    pad = B - len(idx)
    if pad <= 0:
        return idx
    return np.concatenate([idx, np.repeat(idx[:1], pad)])


class DispatchWindow:
    """Bounded dispatch-ahead queue.

    ``drain`` is called with one pushed item at a time, in FIFO order; at
    most ``EVAL_INFLIGHT`` batches are queued but unread at any moment.
    """

    def __init__(self, drain: Callable):
        self._drain = drain
        self._q: deque = deque()

    def push(self, *item) -> None:
        self._q.append(item)
        if len(self._q) >= EVAL_INFLIGHT:
            self._drain(*self._q.popleft())

    def flush(self) -> None:
        while self._q:
            self._drain(*self._q.popleft())
