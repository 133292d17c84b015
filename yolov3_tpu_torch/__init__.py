"""PyTorch/CUDA port of `yolov3_tpu` for one NVIDIA H100.

Mirrors the JAX package's module layout (config, data, ops, models,
parallel, utils, inference, train) so each module's counterpart is found
by name. Needs torch, numpy and scipy; never imports jax, flax, optax,
orbax, protobuf or `yolov3_tpu` (`utils/metrics.py` uses tensorboardX
where it is installed). The hand-written
Hopper kernels live in `csrc/` and are wrapped in `ops/kernels/`.
"""
