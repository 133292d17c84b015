"""Configuration dataclasses for the PyTorch port.

An own copy of `yolov3_tpu/config.py`'s `ModelConfig` and
`InferenceConfig`, with the same field names, defaults and JSON form, so
`ModelConfig.from_json` reads a `model_config.json` written by the JAX
package unchanged.

Every field of the JAX config is accepted, including the TPU-only ones
(`stem_space_to_depth`, `s2d_base_grads`, `stem1_im2row_grads`). The
float forward of this port ignores them: the space-to-depth stem is the
same math as the plain stem laid out for the TPU's 128-wide lanes (one
variable tree for both), and the two grad options change only how the
TPU computes weight gradients. `remat_blocks` recomputes each
FeatureBlock's and YoloBlock's activations in the backward
(`torch.utils.checkpoint`, `models/yolo.py::remat`), as the reference's
`nn.remat` does: the same math in less memory. int8
post-training-quantized serving is ported (`models/quantized.py`,
selected by the caller, not by the config); as in the reference,
`stem_space_to_depth` is where its stem-region kernels apply (computed
in the plain layout), and where stem1 stays bf16 under
quantization-aware training. `int8_train` selects the QAT train forward
(`models/yolo.py::int8_ste_conv`), and `int8_train_static`, with it, the
frozen activation scales; without `int8_train` it changes nothing, as in
the reference.

`TrainConfig` and `AugmentConfig` are copies of the JAX package's, with
its defaults. `shard_optimizer` is ZeRO-1 over the data-parallel group
(`parallel/train_step.py`); the TPU-only `packed_loss` (the lane-domain
loss) is accepted at its default only.

torch is imported lazily (`ModelConfig.dtype`): the reader's worker
processes import this module and need no torch.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Tuple

# Network constants (reference/model.py:22-26)
BLOCK_COUNT = 8
FILTER_COUNT = 1024
KERNEL_SIZE = 3
NETWORK_DOWNSAMPLE_FACTOR = 32
WEIGHT_DECAY = 5e-4
# tiled inference's ghost-zone radius (reference/inference_tiled.py:25-26)
EDGE_EFFECT_RANGE = 96

DEFAULT_ANCHORS: Tuple[Tuple[int, int], ...] = ((32, 32), (128, 128), (256, 256))
TRAIN_DEFAULT_ANCHORS: Tuple[Tuple[int, int], ...] = ((64, 384), (384, 64))

# readers per device (reference/train.py:16)
READER_COUNT_PER_DEVICE = 3
# early-stopping convergence tolerance (reference/train.py:185)
CONVERGENCE_TOLERANCE = 1e-4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (field for field as the JAX config)."""

    img_size: Tuple[int, int, int]  # (H, W, C)
    number_classes: int
    anchors: Tuple[Tuple[float, float], ...] = DEFAULT_ANCHORS
    compute_dtype: str = "bfloat16"
    leaky_relu_alpha: float = 0.2
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    block_count: int = BLOCK_COUNT
    filter_count: int = FILTER_COUNT
    kernel_size: int = KERNEL_SIZE
    # TPU layout of the stem (same math, same tree); the int8 stem-region
    # kernels apply under it, as in the reference
    stem_space_to_depth: bool = True
    # inference 1x1 ConvBlocks through the fused pointwise kernel
    use_pallas_pointwise: bool = False
    # reference-compatible channel-sum upsample (models/yolo.py upsample_2x)
    upsample_channel_sum: bool = False
    # TPU training options; the math is the plain stem's
    s2d_base_grads: Any = False
    stem1_im2row_grads: bool = False
    # quantization-aware training (the train forward only): int8 forward,
    # straight-through backward; static: frozen calibrated act scales
    int8_train: bool = False
    int8_train_static: bool = False
    # recompute FeatureBlock/YoloBlock activations in the backward
    remat_blocks: bool = False

    def __post_init__(self):
        h, w, _ = self.img_size
        if h % NETWORK_DOWNSAMPLE_FACTOR or w % NETWORK_DOWNSAMPLE_FACTOR:
            raise ValueError(
                f"img size {self.img_size} must be a multiple of "
                f"{NETWORK_DOWNSAMPLE_FACTOR}")

    @property
    def number_anchors(self) -> int:
        return len(self.anchors)

    @property
    def dtype(self):
        import torch
        return getattr(torch, self.compute_dtype)

    @property
    def grid_sizes(self) -> List[Tuple[int, int]]:
        """Grid (gh, gw) per scale at strides 32/16/8."""
        h, w, _ = self.img_size
        return [(h // s, w // s) for s in self.strides]

    @property
    def strides(self) -> List[int]:
        return [32, 16, 8]

    @property
    def number_output_boxes(self) -> int:
        return self.number_anchors * sum(gh * gw for gh, gw in self.grid_sizes)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        d["img_size"] = tuple(d["img_size"])
        d["anchors"] = tuple(tuple(a) for a in d["anchors"])
        return ModelConfig(**d)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation severities (reference/imagereader.py:370-378)."""

    rotation_flag: bool = False
    reflection_flag: bool = True
    noise_augmentation_severity: float = 0.03
    scale_augmentation_severity: float = 0.1
    blur_augmentation_max_sigma: float = 2.0
    box_size_augmentation_severity: float = 0.03
    box_location_jitter_severity: float = 0.03


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (reference/train.py:229-242), field for
    field as the JAX config."""

    batch_size: int = 8  # per device
    learning_rate: float = 1e-4
    test_every_n_steps: int = 1000
    early_stopping_count: int = 10
    use_augmentation: bool = True
    balance_classes: bool = True
    reader_count_per_device: int = READER_COUNT_PER_DEVICE
    # epoch 0 runs min(warmup_steps, epoch size) steps at lr / divisor
    warmup_steps: int = 1000
    warmup_lr_divisor: float = 10.0
    convergence_tolerance: float = CONVERGENCE_TOLERANCE
    # the reference defines L2 kernel regularizers but never adds them to
    # its loss (reference/model.py:37,117,485-492): off by default
    apply_weight_decay: bool = False
    weight_decay: float = WEIGHT_DECAY
    # Keras's Adam defaults (reference/model.py:451)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7
    # TPU-only formulations; the port accepts them at False only
    packed_loss: bool = False
    shard_optimizer: bool = False


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Inference / NMS configuration (reference/bbox_utils.py:240-247)."""

    iou_threshold: float = 0.3
    score_threshold: float = 0.1
    min_box_size: int = 32
    tile_height: int = 512
    tile_width: int = 512
    edge_effect_range: int = 96
    max_boxes_per_class: int = 512
