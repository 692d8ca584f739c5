"""Fixed-size batches from ragged index ranges (port of
``pad_batch_indices`` in ``fedcola_tpu/utils/dispatch.py``;
``DispatchWindow`` is not ported: the port's eval loops read each batch
back as they go)."""

from __future__ import annotations

import numpy as np


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
