"""Operations and bytes: each fused or flash kernel's operations and bytes
per call (``kernels.py``), the peaks of the card they are held against
(``peaks.py``), and the work of whole rounds and evaluation passes
(``work.py``).  A model's FLOPs and the kernels its layers call are its
architecture's (``portbench/arch/``)."""
