"""Train and eval steps on one device (port of
`yolov3_tpu/parallel/train_step.py`, reference/model.py:481-540).

Scaling as the JAX step has it (train_step.py:116-137): per-scale loss
sums are divided by the local batch (inside `compute_loss`), the total by
the global batch; on one device the cross-replica sum and mean of the
metrics are the values themselves. The metrics keep the JAX keys:
`loss`, `loss_sum`, `loss_xy`, `loss_wh`, `loss_obj`, `loss_class`.

Adam has Keras's defaults (b1 0.9, b2 0.999, eps 1e-7) through
`torch.optim.Adam`: optax's `scale_by_adam` with the bias correction on
the update, lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), in
another rounding order. The learning rate is an argument of each step, so
the warm-up changes it without rebuilding anything. Weight decay, when
on, is added to the loss as the JAX step adds it, not through AdamW.

The train step runs the train-mode forward (batch statistics, running
statistics moved): with `ModelConfig.int8_train` the QAT forward
(`models/yolo.py::int8_ste_conv`, the int8 forward with the
straight-through backward), and with `int8_train_static` as well on the
model's frozen `act_scale` buffers, which the step leaves as they are
(the trainer refreshes them, `train.py`). The eval step runs the
inference forward with the
running statistics and changes no state; after a train step it derives
the model's constants again first, so the fused 1x1 kernel, when the
config asks for it, sees the current weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models.yolo import YoloV3, prepare_all
from yolov3_tpu_torch.ops.loss import YoloLoss, compute_loss, l2_regularization
from yolov3_tpu_torch.utils.checkpoint import (init_train_params,
                                               params_from_jax)

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters, BatchNorm statistics and, under static
    QAT, activation scales), the optimizer (its Adam moments), the step
    count, and whether the model's derived constants predate its
    parameters."""
    model: YoloV3
    optimizer: torch.optim.Optimizer
    step: int = 0
    stale: bool = False


def check_train_config(tcfg: TrainConfig) -> None:
    for name in ("packed_loss", "shard_optimizer"):
        if getattr(tcfg, name):
            raise NotImplementedError(
                f"TrainConfig.{name} is a TPU-only formulation the port "
                f"does not take (ROADMAP.md)")


def make_optimizer(model: torch.nn.Module,
                   tcfg: TrainConfig) -> torch.optim.Optimizer:
    return torch.optim.Adam(model.parameters(), lr=tcfg.learning_rate,
                            betas=(tcfg.adam_b1, tcfg.adam_b2),
                            eps=tcfg.adam_eps)


def create_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                       device="cuda", params: Optional[dict] = None,
                       batch_stats: Optional[dict] = None,
                       quant_scales: Optional[dict] = None) -> TrainState:
    """A fresh train state on `device`, the model in train mode: weights
    from the Flax-shaped trees given, else `init_train_params(cfg, seed)`;
    under static QAT the scales from `quant_scales` (JAX's collection),
    else 1.0, as the reference's init gives them."""
    check_train_config(tcfg)
    if params is None:
        params, batch_stats = init_train_params(cfg, seed)
    model = YoloV3(cfg)
    model.load_state_dict(params_from_jax(params, batch_stats, cfg,
                                          quant_scales))
    model = model.to(device).train()
    return TrainState(model, make_optimizer(model, tcfg))


def _loss(model: YoloV3, cfg: ModelConfig, tcfg: TrainConfig,
          global_batch_size: int, images: torch.Tensor,
          labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, YoloLoss]:
    yolo_loss = compute_loss(model(images), labels, cfg.anchors,
                             cfg.number_classes, cfg.strides)
    loss = yolo_loss.total / float(global_batch_size)
    if tcfg.apply_weight_decay:
        loss = loss + l2_regularization(model, tcfg.weight_decay)
    return loss, yolo_loss


def _metrics(loss: torch.Tensor, yolo_loss: YoloLoss) -> Dict[str, torch.Tensor]:
    loss = loss.detach()
    return {"loss": loss, "loss_sum": loss,
            "loss_xy": yolo_loss.xy.detach(),
            "loss_wh": yolo_loss.wh.detach(),
            "loss_obj": yolo_loss.objectness.detach(),
            "loss_class": yolo_loss.class_.detach()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    global_batch_size: int,
                    ) -> Callable[[TrainState, Batch, float],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch, lr) -> (state, metrics): the train-mode forward,
    the loss, backward and one Adam update at `lr`; the metrics are
    tensors on the device (reading them synchronises)."""
    check_train_config(tcfg)

    def step(state: TrainState, batch: Batch, lr: float):
        images, *labels = batch
        model = state.model.train()
        for group in state.optimizer.param_groups:
            group["lr"] = float(lr)
        loss, yolo_loss = _loss(model, cfg, tcfg, global_batch_size, images,
                                labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        state.stale = True
        return state, _metrics(loss, yolo_loss)

    return step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig,
                   global_batch_size: int,
                   ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """step(state, batch) -> metrics of the inference forward (running
    statistics) on `batch`; the state's parameters, statistics and
    moments stay as they were, and the model's mode is restored."""
    check_train_config(tcfg)

    def step(state: TrainState, batch: Batch):
        images, *labels = batch
        model = state.model
        was_training = model.training
        model.eval()
        try:
            if state.stale:
                prepare_all(model)
                state.stale = False
            with torch.no_grad():
                loss, yolo_loss = _loss(model, cfg, tcfg, global_batch_size,
                                        images, labels)
        finally:
            model.train(was_training)
        return _metrics(loss, yolo_loss)

    return step
