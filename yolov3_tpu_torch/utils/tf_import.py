"""TF2/Keras reference-weight importer (port of
`yolov3_tpu/utils/tf_import.py`; pure numpy, no TensorFlow needed).

The reference exports `tf.train.Checkpoint` + SavedModel artifacts
(reference/train.py:208-221). Reproducing a reference-trained model
needs those weights, and the import is split in two:

1. `scripts/dump_tf_weights.py`, run where TensorFlow is installed: it
   loads the reference SavedModel/checkpoint and dumps
   `{layer_name}/{var_name}` numpy arrays to an .npz (the "keras layout").
2. `import_keras_weights` (this module): maps the keras layout into the
   Flax-shaped (params, batch_stats) trees of the JAX package, and
   `load_npz` carries them on into the port's `YoloV3` state_dict through
   `utils/checkpoint.py::params_from_jax`.

Layout facts the mapping relies on:
- `conv_layer` creates Conv2D then BatchNormalization, so the N-th
  ConvBlock in creation order owns `conv2d[_N]` and
  `batch_normalization[_N]` (Keras auto-naming, reference/model.py:28-39).
- detection layers are EXPLICITLY named feature_map_1/2/3
  (reference/model.py:107-120, :364-378) and so never consume conv2d_N
  names.
- the upsample Conv2DTranspose layers (reference/model.py:93-105) carry
  frozen all-ones kernels; they are skipped (the model implements the
  upsample functionally). A reference-trained model's outputs are only
  reproduced with `ModelConfig(upsample_channel_sum=True)`: the
  reference's upsample sums channels.
- Keras Conv2D kernels are stored HWIO regardless of data_format, the
  Flax layout; BatchNorm gamma/beta/moving_mean/moving_variance map to
  scale/bias and batch_stats mean/var.

`reference_keras_shapes` transcribes the reference's architecture walk
(reference/model.py:356-421) independently of models/yolo.py, so the
tests cross-check two separate descriptions of the network.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.utils.checkpoint import params_from_jax

BN_VARS = ("gamma", "beta", "moving_mean", "moving_variance")


def _kname(base: str, idx: int) -> str:
    """Keras auto-naming: first instance unnumbered, then `_1`, `_2`, ..."""
    return base if idx == 0 else f"{base}_{idx}"


def conv_block_paths(block_count: int = 8) -> List[str]:
    """Flax ConvBlock path prefixes in the reference's CREATION order
    (= conv2d/batch_normalization numbering order)."""
    d = "Darknet53_0"
    paths = [f"{d}/ConvBlock_0", f"{d}/ConvBlock_1"]
    paths += [f"{d}/FeatureBlock_0/ConvBlock_{i}" for i in range(2)]
    paths.append(f"{d}/ConvBlock_2")
    fb_reps = [2, block_count, block_count, block_count // 2]
    for fb_i, reps in enumerate(fb_reps, start=1):
        paths += [f"{d}/FeatureBlock_{fb_i}/ConvBlock_{i}"
                  for i in range(2 * reps)]
        if fb_i < 4:
            paths.append(f"{d}/ConvBlock_{fb_i + 2}")
    for s in range(3):
        paths += [f"YoloBlock_{s}/ConvBlock_{i}" for i in range(6)]
        if s < 2:
            paths.append(f"ConvBlock_{s}")
    return paths


def reference_keras_shapes(number_classes: int, num_anchors: int,
                           img_channels: int = 3, block_count: int = 8,
                           filter_count: int = 1024, kernel: int = 3,
                           ) -> Dict[str, Tuple[int, ...]]:
    """Every variable (name -> shape) of the reference Keras model, by
    transcribing reference/model.py:356-421's construction walk."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    counters = {"conv2d": 0, "batch_normalization": 0, "conv2d_transpose": 0}

    def conv(cin: int, cout: int, k: int) -> int:
        name = _kname("conv2d", counters["conv2d"])
        counters["conv2d"] += 1
        shapes[f"{name}/kernel"] = (k, k, cin, cout)
        shapes[f"{name}/bias"] = (cout,)
        bn = _kname("batch_normalization", counters["batch_normalization"])
        counters["batch_normalization"] += 1
        for v in BN_VARS:
            shapes[f"{bn}/{v}"] = (cout,)
        return cout

    def feature_block(cin: int, reps: int, fcnt: int) -> int:
        for _ in range(reps):
            conv(cin, fcnt // 2, 1)
            conv(fcnt // 2, fcnt, kernel)
        return fcnt if reps else cin

    def yolo_block(cin: int, fcnt: int) -> Tuple[int, int]:
        c = conv(cin, fcnt // 2, 1)
        c = conv(c, fcnt, kernel)
        c = conv(c, fcnt // 2, 1)
        c = conv(c, fcnt, kernel)
        route = conv(c, fcnt // 2, 1)
        out = conv(route, fcnt, kernel)
        return route, out

    def detection(idx: int, cin: int) -> None:
        cout = num_anchors * (5 + number_classes)
        shapes[f"feature_map_{idx}/kernel"] = (1, 1, cin, cout)
        shapes[f"feature_map_{idx}/bias"] = (cout,)

    def upsample(ch: int) -> None:
        # frozen ones-kernel Conv2DTranspose; Keras transpose kernels are
        # (kh, kw, filters, in_channels)
        name = _kname("conv2d_transpose", counters["conv2d_transpose"])
        counters["conv2d_transpose"] += 1
        shapes[f"{name}/kernel"] = (2, 2, ch, ch)
        shapes[f"{name}/bias"] = (ch,)

    fc, bc = filter_count, block_count
    c = conv(img_channels, fc // 32, kernel)
    c = conv(c, fc // 16, kernel)
    c = feature_block(c, 1, fc // 16)
    c = conv(c, fc // 8, kernel)
    c = feature_block(c, 2, fc // 8)
    c = conv(c, fc // 4, kernel)
    route1 = feature_block(c, bc, fc // 4)
    c = conv(route1, fc // 2, kernel)
    route2 = feature_block(c, bc, fc // 2)
    c = conv(route2, fc, kernel)
    route3 = feature_block(c, bc // 2, fc)

    route, out = yolo_block(route3, fc)
    detection(1, out)
    c = conv(route, fc // 2, 1)
    upsample(c)
    route, out = yolo_block(c + route2, fc // 2)
    detection(2, out)
    c = conv(route, fc // 4, 1)
    upsample(c)
    route, out = yolo_block(c + route1, fc // 4)
    detection(3, out)
    return shapes


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def import_keras_weights(weights: Mapping[str, np.ndarray],
                         block_count: int = 8,
                         ) -> Tuple[dict, dict]:
    """keras-layout variables -> (params, batch_stats) Flax trees.

    `weights` keys are `{layer_name}/{var_name}` (a trailing ':0' is
    stripped). Returns the trees `utils/checkpoint.py::params_from_jax`
    takes; build the model with `upsample_channel_sum=True` for output
    parity.
    """
    w = {k.split(":")[0]: np.asarray(v, np.float32)
         for k, v in weights.items()}
    params: dict = {}
    stats: dict = {}

    for i, path in enumerate(conv_block_paths(block_count)):
        kc = _kname("conv2d", i)
        kb = _kname("batch_normalization", i)
        _set(params, f"{path}/Conv_0/kernel", w[f"{kc}/kernel"])
        _set(params, f"{path}/Conv_0/bias", w[f"{kc}/bias"])
        _set(params, f"{path}/BatchNorm_0/scale", w[f"{kb}/gamma"])
        _set(params, f"{path}/BatchNorm_0/bias", w[f"{kb}/beta"])
        _set(stats, f"{path}/BatchNorm_0/mean", w[f"{kb}/moving_mean"])
        _set(stats, f"{path}/BatchNorm_0/var", w[f"{kb}/moving_variance"])

    for s in range(3):
        _set(params, f"DetectionHead_{s}/Conv_0/kernel",
             w[f"feature_map_{s + 1}/kernel"])
        _set(params, f"DetectionHead_{s}/Conv_0/bias",
             w[f"feature_map_{s + 1}/bias"])
    return params, stats


def load_npz(npz_path: str, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A `scripts/dump_tf_weights.py` dump -> the port's `YoloV3`
    state_dict for `cfg` (build `cfg` with `upsample_channel_sum=True`
    to reproduce the reference's outputs)."""
    with np.load(npz_path) as z:
        params, stats = import_keras_weights(dict(z.items()),
                                             cfg.block_count)
    return params_from_jax(params, stats, cfg)
