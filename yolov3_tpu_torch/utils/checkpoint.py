"""Weight bridge and the port's exported-model artifact.

The JAX package keeps the feature-map model `YoloV3`'s variables as two
Flax trees, `params` and `batch_stats`. `params_from_jax` turns those
trees, given as nested dicts of numpy arrays, into this port's
`state_dict`; the names map explicitly (`_MODULES`, `_LEAVES`) because
Flax auto-names the unnamed modules (`Darknet53_0`, the neck's
`ConvBlock_0`/`ConvBlock_1`, `DetectionHead_0..2`, and `Conv_0` /
`BatchNorm_0` inside each block). The JAX space-to-depth and plain stems
share one tree, so one mapping serves both.

The port's artifact is `<folder>/saved_model/` with the same
`model_config.json` as the JAX export and a `weights.npz` keyed by Flax
path (`params/Darknet53_0/ConvBlock_0/Conv_0/kernel`), written without
pickle. A YOLOv4 export (`ModelConfig.architecture`) keys its convs by
cfg layer, `params/conv_<L>/Conv_0/kernel` (no bias but the heads'),
`params/conv_<L>/BatchNorm_0/scale`, `batch_stats/conv_<L>/BatchNorm_0/
mean`. Converting a JAX (Orbax) export needs JAX, so it is done outside
this package: load it with the JAX package, turn the leaves into numpy,
and pass them to `export_model`. `params_to_jax` is the inverse of
`params_from_jax`: the trainer exports its model through it.

Under static quantization-aware training (`int8_train` with
`int8_train_static`) each quantizing ConvBlock also holds an `act_scale`
buffer, the JAX `quant_scales` collection's leaf of the same path
(`quant_scales/Darknet53_0/ConvBlock_1/act_scale`): `params_from_jax`
takes that collection as well (1.0 where none is given, as the Flax init
starts it) and `scales_to_jax` gives it back. The trainer's checkpoint
keeps the scales with the rest of the state; the export carries none.

The training checkpoint (`save_checkpoint` / `restore_checkpoint`) is the
whole train state (parameters, BatchNorm statistics, QAT scales, Adam
moments, step) in one `torch.save` file under `<output>/checkpoint/`,
the JAX package's directory name, overwritten in place: the reference's
best-only policy (reference/train.py:178-182). Under ZeRO-1 it holds the
consolidated moments, so it resumes at any world size (the reference's
ZeRO state is tied to its chip count). `adam_state_from_jax` carries
optax's Adam state into `torch.optim.Adam`'s.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from yolov3_tpu_torch.config import YOLOV4, ModelConfig

CHECKPOINT_DIR = "checkpoint"
STATE_FILE = "state.pt"
EXPORT_DIR = "saved_model"
CONFIG_FILE = "model_config.json"
WEIGHTS_FILE = "weights.npz"

# port module name -> Flax module name ("{}" takes the next key part, the
# index in a ModuleList)
_MODULES = {
    "darknet": "Darknet53_0",
    "yolo_blocks": "YoloBlock_{}",
    "necks": "ConvBlock_{}",
    "heads": "DetectionHead_{}",
    "blocks": "FeatureBlock_{}",
    "convs": "ConvBlock_{}",
    "conv": "Conv_0",
    "bn": "BatchNorm_0",
    # YOLOv4's convs, by cfg layer (`models/yolov4.py`): `conv_<L>`
    "layers": "{}",
}
# a quantizing ConvBlock's frozen activation scale (static QAT)
SCALE_LEAF = "act_scale"
# (owner module, port leaf) -> (Flax collection, Flax leaf)
_LEAVES = {
    ("conv", "weight"): ("params", "kernel"),
    ("conv", "bias"): ("params", "bias"),
    ("bn", "weight"): ("params", "scale"),
    ("bn", "bias"): ("params", "bias"),
    ("bn", "running_mean"): ("batch_stats", "mean"),
    ("bn", "running_var"): ("batch_stats", "var"),
}


def flax_module_path(name: str) -> str:
    """Port module name -> Flax module path, e.g. `darknet.blocks.2.convs.3`
    -> `Darknet53_0/FeatureBlock_2/ConvBlock_3`: the keys of the int8
    path's activation scales (`models/quantized.py`)."""
    names, it = [], iter(name.split("."))
    for p in it:
        fmt = _MODULES[p]
        names.append(fmt.format(next(it)) if "{}" in fmt else fmt)
    return "/".join(names)


def flax_path(key: str) -> str:
    """Port state_dict key -> "<collection>/<Flax path>", e.g.
    `darknet.blocks.2.convs.3.bn.running_var` ->
    `batch_stats/Darknet53_0/FeatureBlock_2/ConvBlock_3/BatchNorm_0/var`."""
    parts = key.split(".")
    if parts[-1] == SCALE_LEAF:
        collection, leaf = "quant_scales", SCALE_LEAF
    else:
        collection, leaf = _LEAVES[(parts[-2], parts[-1])]
    return "/".join([collection, flax_module_path(".".join(parts[:-1])),
                     leaf])


def _is_scale(key: str) -> bool:
    return key.rsplit(".", 1)[-1] == SCALE_LEAF


def _flax_shape(value: torch.Tensor) -> Tuple[int, ...]:
    """Shape a port tensor has in the Flax tree (kernels are HWIO)."""
    shape = tuple(value.shape)
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape


def _flatten(tree: dict, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(v, path, out)
        else:
            out[path] = v


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def feature_model(cfg: ModelConfig) -> torch.nn.Module:
    """The feature-map model of `cfg.architecture`."""
    if cfg.architecture == YOLOV4:
        from yolov3_tpu_torch.models.yolov4 import YoloV4
        return YoloV4(cfg)
    from yolov3_tpu_torch.models.yolo import YoloV3
    return YoloV3(cfg)


def _template(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict names and shapes, allocated on no device."""
    with torch.device("meta"):
        return feature_model(cfg).state_dict()


def params_from_jax(params: dict, batch_stats: dict, cfg: ModelConfig,
                    quant_scales: Optional[dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax `YoloV3` trees (nested dicts of numpy arrays) -> the port's
    `YoloV3` state_dict. Raises on any leaf missing, left over, or of the
    wrong shape. The kernels go from HWIO to OIHW here and only here.
    Under static QAT the `act_scale` buffers come from `quant_scales`
    (the JAX collection), or are 1.0 when it is None."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats, "batch_stats", flat)
    if quant_scales is not None:
        _flatten(quant_scales, "quant_scales", flat)
    state = {}
    for key, meta in _template(cfg).items():
        path = flax_path(key)
        if _is_scale(key) and quant_scales is None:
            flat[path] = np.ones((), np.float32)
        if path not in flat:
            raise KeyError(f"Flax tree has no {path} (for {key})")
        value = np.asarray(flat.pop(path), np.float32)
        if value.shape != _flax_shape(meta):
            raise ValueError(f"{path}: shape {value.shape}, expected "
                             f"{_flax_shape(meta)}")
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    if flat:
        raise KeyError(f"Flax leaves left over: {sorted(flat)}")
    return state


def adam_state_from_jax(mu: dict, nu: dict, count, cfg: ModelConfig
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """optax's `ScaleByAdamState` (`mu`, `nu`: trees of numpy arrays in
    the Flax `params` layout; `count`: the step) -> `torch.optim.Adam`'s
    per-parameter state (`step`, `exp_avg`, `exp_avg_sq`), keyed by the
    port's parameter name. The moments' kernels go from HWIO to OIHW as
    the parameters' do; `set_adam_state` puts them into an optimizer."""
    moments = {}
    for tag, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        flat: Dict[str, np.ndarray] = {}
        _flatten(tree, "params", flat)
        moments[tag] = flat
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    out = {}
    for key, meta in _template(cfg).items():
        path = flax_path(key)
        if not path.startswith("params/"):
            continue
        out[key] = {"step": step.clone()}
        for tag, flat in moments.items():
            if path not in flat:
                raise KeyError(f"Adam state has no {path} (for {key})")
            value = np.asarray(flat.pop(path), np.float32)
            if value.shape != _flax_shape(meta):
                raise ValueError(f"{path}: shape {value.shape}, expected "
                                 f"{_flax_shape(meta)}")
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[key][tag] = torch.from_numpy(np.ascontiguousarray(value))
    left = sorted(k for flat in moments.values() for k in flat)
    if left:
        raise KeyError(f"Adam leaves left over: {left}")
    return out


def set_adam_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                   state: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Put `adam_state_from_jax`'s state into `optimizer` (an Adam over
    `model`'s parameters), each tensor on its parameter's device."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {k: v.to(p.device) if k != "step" else v
                              for k, v in state[name].items()}


def _to_jax(state: Dict[str, torch.Tensor]) -> dict:
    flat = {}
    for key, value in state.items():
        value = value.detach().to("cpu", torch.float32).numpy()
        if value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[flax_path(key)] = np.ascontiguousarray(value)
    return _unflatten(flat)


def params_to_jax(state: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's `YoloV3` state_dict -> Flax-shaped (params, batch_stats)
    trees of f32 numpy arrays; kernels go from OIHW back to HWIO. QAT
    scales, if any, are left out (`scales_to_jax`)."""
    tree = _to_jax({k: v for k, v in state.items() if not _is_scale(k)})
    return tree["params"], tree["batch_stats"]


def scales_to_jax(state: Dict[str, torch.Tensor]) -> Optional[dict]:
    """The state_dict's static-QAT `act_scale` buffers as the JAX
    `quant_scales` collection (None when it has none)."""
    scales = {k: v for k, v in state.items() if _is_scale(k)}
    return _to_jax(scales)["quant_scales"] if scales else None


def init_train_params(cfg: ModelConfig, seed: int) -> Tuple[dict, dict]:
    """Fresh training weights in the Flax layout, made from `seed` with
    numpy, with the distributions of the JAX model's `init`: kernels
    lecun_normal (a normal truncated at 2 sigma, std sqrt(1 / fan_in) /
    0.8796), conv and BatchNorm biases 0, scales 1, means 0, variances
    1. The draws themselves differ from JAX's PRNG."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, meta in _template(cfg).items():
        if _is_scale(key):
            continue
        shape = _flax_shape(meta)
        leaf = key.rsplit(".", 1)[-1]
        if len(shape) == 4:
            v = rng.standard_normal(shape)
            out = np.abs(v) > 2.0
            while out.any():
                v[out] = rng.standard_normal(int(out.sum()))
                out = np.abs(v) > 2.0
            v *= np.sqrt(1.0 / np.prod(shape[:-1])) / .87962566103423978
        elif leaf in ("weight", "running_var"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        flat[flax_path(key)] = v.astype(np.float32)
    tree = _unflatten(flat)
    return tree["params"], tree["batch_stats"]


def init_params(cfg: ModelConfig, seed: int) -> Tuple[dict, dict]:
    """Random Flax-shaped (params, batch_stats) trees for `cfg`, made from
    `seed` with numpy: kernels N(0, 1/fan_in), conv and BN biases and BN
    means N(0, 0.1^2), BN scales U(0.8, 1.2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, meta in _template(cfg).items():
        if _is_scale(key):
            continue
        shape = _flax_shape(meta)
        leaf = key.rsplit(".", 1)[-1]
        owner = key.rsplit(".", 2)[-2]
        if len(shape) == 4:
            v = rng.standard_normal(shape, np.float32) / np.sqrt(
                np.prod(shape[:-1]))
        elif owner == "bn" and leaf == "weight":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape, np.float32)
        flat[flax_path(key)] = v.astype(np.float32)
    tree = _unflatten(flat)
    return tree["params"], tree["batch_stats"]


def _checkpoint_file(output_folder: str) -> str:
    return os.path.abspath(os.path.join(output_folder, CHECKPOINT_DIR,
                                        STATE_FILE))


def save_checkpoint(output_folder: str, state, write: bool = True) -> str:
    """Overwrite `<output>/checkpoint` with the train state (`state.model`,
    `state.optimizer`, `state.step`); the caller decides when. A ZeRO-1
    optimizer's moments are consolidated onto rank 0 first (a collective:
    every rank calls this, rank 0 with `write`), so the file holds the
    whole Adam state, which an optimizer of any world size loads."""
    optimizer = state.optimizer
    if hasattr(optimizer, "consolidate_state_dict"):
        optimizer.consolidate_state_dict(to=0)
    path = os.path.dirname(_checkpoint_file(output_folder))
    if not write:
        return path
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"step": int(state.step), "model": state.model.state_dict(),
                "optimizer": optimizer.state_dict()},
               _checkpoint_file(output_folder))
    return path


def _load_checkpoint(output_folder: str, device) -> dict:
    return torch.load(_checkpoint_file(output_folder), map_location=device,
                      weights_only=True)


def has_checkpoint(output_folder: str) -> bool:
    return os.path.exists(_checkpoint_file(output_folder))


def restore_checkpoint(output_folder: str, state):
    """Load a checkpoint written by `save_checkpoint` into `state` (a
    fresh state of the same configuration) and return it. The optimizer
    keeps its own settings (a capturable Adam's flag and lr tensor on the
    card, a plain Adam's on the CPU), whichever kind wrote the file."""
    device = next(state.model.parameters()).device
    saved = _load_checkpoint(output_folder, device)
    state.model.load_state_dict(saved["model"])
    opt = saved["optimizer"]
    for group, own in zip(opt["param_groups"], state.optimizer.param_groups):
        group.update({k: v for k, v in own.items() if k != "params"})
    state.optimizer.load_state_dict(opt)
    state.step = saved["step"]
    return state


def checkpoint_params(output_folder: str) -> Tuple[dict, dict]:
    """The checkpoint's model as Flax-shaped (params, batch_stats), read
    on the CPU."""
    return params_to_jax(_load_checkpoint(output_folder, "cpu")["model"])


def export_model(output_folder: str, params: dict, batch_stats: dict,
                 config: ModelConfig) -> str:
    """Write `<output_folder>/saved_model` (config JSON + weights.npz) and
    return its path. Training-only QAT flags are cleared, as the JAX
    export does."""
    config = dataclasses.replace(config, int8_train=False,
                                 int8_train_static=False)
    path = os.path.abspath(os.path.join(output_folder, EXPORT_DIR))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    with open(os.path.join(path, CONFIG_FILE), "w") as fh:
        fh.write(config.to_json())
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats, "batch_stats", flat)
    np.savez(os.path.join(path, WEIGHTS_FILE),
             **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    return path


def load_model(saved_model_path: str) -> Tuple[dict, dict, ModelConfig]:
    """Load (params, batch_stats, config) from the port's artifact."""
    saved_model_path = os.path.abspath(saved_model_path)
    cfg_path = os.path.join(saved_model_path, CONFIG_FILE)
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"Not an exported model: {saved_model_path}")
    with open(cfg_path) as fh:
        config = ModelConfig.from_json(fh.read())
    with np.load(os.path.join(saved_model_path, WEIGHTS_FILE),
                 allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return tree["params"], tree["batch_stats"], config


def build_model(params: dict, batch_stats: dict, cfg: ModelConfig,
                device) -> torch.nn.Module:
    """The detector of `cfg.architecture` (`YoloV3Detector`,
    `YoloV4Detector`) with the given Flax-shaped weights, in eval mode on
    `device`."""
    if cfg.architecture == YOLOV4:
        from yolov3_tpu_torch.models.yolov4 import YoloV4Detector as Detector
    else:
        from yolov3_tpu_torch.models.yolo import YoloV3Detector as Detector
    model = Detector(cfg)
    model.backbone.load_state_dict(params_from_jax(params, batch_stats, cfg))
    return model.to(device).eval()
