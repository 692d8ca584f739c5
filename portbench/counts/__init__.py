"""Operations and bytes: the model's FLOPs per sample (``model.py``), each
fused or flash kernel's operations and bytes per call (``kernels.py``),
and the peaks of the card they are held against (``peaks.py``)."""
