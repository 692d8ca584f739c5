"""The benchmark of ``fedcola_tpu_torch`` on one NVIDIA H100 (see README.md).

Nothing in this package imports JAX or the JAX package ``fedcola_tpu``;
the plain reference under ``reference/`` imports nothing of the port
either.
"""
