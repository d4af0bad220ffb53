"""PyTorch/CUDA port of DFLOP.

Module paths mirror ``repro`` (the JAX package, which stays the reference).
This package imports torch and numpy only — never jax, never ``repro``.

The distributed core runs on ``torch.distributed``: ``launch.mesh`` builds
device meshes over an initialised process group (NCCL on the cards by
default, gloo on the CPU when asked), ``sharding`` holds the per-module
partition rules and the vocab-parallel cross-entropy,
``core.communicator`` moves activations between the encoder's and the
LLM's data-parallel layouts, and ``core.pipeline.executor`` runs stacked
layers over a stage axis by point-to-point sends.  ``train.step`` takes the
communicator and the vocab-parallel CE as hooks.
"""
