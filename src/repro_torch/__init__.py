"""PyTorch/CUDA port of the DFLOP training slice.

Module paths mirror ``repro`` (the JAX package, which stays the reference).
This package imports torch and numpy only — never jax, never ``repro``.
"""
