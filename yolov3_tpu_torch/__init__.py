"""PyTorch/CUDA port of `yolov3_tpu` for one NVIDIA H100.

Mirrors the JAX package's module layout (config, data, ops, models, utils,
inference) so each module's counterpart is found by name. Imports torch
and numpy only, never jax, flax, orbax or `yolov3_tpu`. The hand-written
Hopper kernels live in `csrc/` and are wrapped in `ops/kernels/`.
"""
