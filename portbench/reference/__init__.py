"""The plain reference: the FedCola line's round and central evaluation in
float32 PyTorch, one client and one batch at a time, with TF32 off.  It
imports nothing of ``fedcola_tpu_torch``, ``fedcola_tpu`` or JAX and takes
nothing the program made: the benchmark hands it the same arrays, split
and initial weights it hands the program.
"""
