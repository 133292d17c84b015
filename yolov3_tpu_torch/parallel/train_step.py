"""Train and eval steps, on one device or data-parallel over a process
group (port of `yolov3_tpu/parallel/train_step.py`,
reference/model.py:481-540).

Scaling as the JAX step has it (train_step.py:1-23, 154-229): per-scale
loss sums are divided by the local batch (inside `compute_loss`), the
total by the global batch. Over a group of ranks (`parallel/
distributed.py`, one process per device, each with its local batch):
- the gradients are summed across the ranks (`lax.psum`; not averaged,
  as DDP would), one all_reduce per bucket;
- BatchNorm normalises with each rank's local batch statistics (no
  SyncBatchNorm), and the running statistics are then averaged across
  the ranks (`lax.pmean`), so every rank keeps the same state;
- the metrics keep the JAX keys: `loss` is the mean of the ranks' losses
  and `loss_sum` their sum, `loss_xy`, `loss_wh`, `loss_obj` and
  `loss_class` the means of the parts; the eval step reduces the same.
On one device the sum and the mean are the values themselves.

`TrainConfig.shard_optimizer` (ZeRO-1) shards Adam's moments over the
group with `torch.distributed.optim.ZeroRedundancyOptimizer` (the same
Adam, each rank stepping its share of the parameters and broadcasting
them); its checkpoint is the consolidated state, which any world size
loads (`utils/checkpoint.py`). Over one rank it is Adam itself.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models.yolo import YoloV3, prepare_all
from yolov3_tpu_torch.ops.loss import YoloLoss, compute_loss, l2_regularization
from yolov3_tpu_torch.parallel import distributed as D
from yolov3_tpu_torch.utils import tracing
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
    if tcfg.packed_loss:
        raise NotImplementedError(
            "TrainConfig.packed_loss is a TPU-only formulation the port "
            "does not take (ROADMAP.md)")


def make_optimizer(model: torch.nn.Module, tcfg: TrainConfig,
                   group=None) -> torch.optim.Optimizer:
    """Adam over the model's parameters; with `tcfg.shard_optimizer` on a
    group of more than one rank, ZeRO-1 over that group."""
    kw = dict(lr=tcfg.learning_rate, betas=(tcfg.adam_b1, tcfg.adam_b2),
              eps=tcfg.adam_eps)
    if tcfg.shard_optimizer and D.world_size(group) > 1:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        return ZeroRedundancyOptimizer(
            model.parameters(), optimizer_class=torch.optim.Adam,
            process_group=group, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def create_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                       device="cuda", params: Optional[dict] = None,
                       batch_stats: Optional[dict] = None,
                       quant_scales: Optional[dict] = None,
                       group=None) -> TrainState:
    """A fresh train state on `device`, the model in train mode: weights
    from the Flax-shaped trees given, else `init_train_params(cfg, seed)`
    (the same numpy draws on every rank); under static QAT the scales
    from `quant_scales` (JAX's collection), else 1.0, as the reference's
    init gives them. `group`: the data-parallel group ZeRO-1 shards
    over."""
    check_train_config(tcfg)
    if params is None:
        params, batch_stats = init_train_params(cfg, seed)
    model = YoloV3(cfg)
    model.load_state_dict(params_from_jax(params, batch_stats, cfg,
                                          quant_scales))
    model = model.to(device).train()
    return TrainState(model, make_optimizer(model, tcfg, group))


def _loss(model: YoloV3, cfg: ModelConfig, tcfg: TrainConfig,
          global_batch_size: int, images: torch.Tensor,
          labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, YoloLoss]:
    return _loss_of(model(images), model, cfg, tcfg, global_batch_size,
                    labels)


def _loss_of(fms: List[torch.Tensor], model: YoloV3, cfg: ModelConfig,
             tcfg: TrainConfig, global_batch_size: int,
             labels: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, YoloLoss]:
    """The loss of the feature maps `fms`, weight decay included."""
    yolo_loss = compute_loss(fms, labels, cfg.anchors, cfg.number_classes,
                             cfg.strides)
    loss = yolo_loss.total / float(global_batch_size)
    if tcfg.apply_weight_decay:
        loss = loss + l2_regularization(model, tcfg.weight_decay)
    return loss, yolo_loss


def _metrics(loss: torch.Tensor, yolo_loss: YoloLoss,
             group=None) -> Dict[str, torch.Tensor]:
    """The JAX keys; over a group, `loss_sum` is the ranks' sum and the
    others their means (one all_reduce)."""
    parts = torch.stack([loss.detach().float(), yolo_loss.xy.detach(),
                         yolo_loss.wh.detach(),
                         yolo_loss.objectness.detach(),
                         yolo_loss.class_.detach()])
    world = D.world_size(group)
    if world > 1:
        D.all_reduce_sum_([parts], group)
    mean = parts / world
    return {"loss": mean[0], "loss_sum": parts[0], "loss_xy": mean[1],
            "loss_wh": mean[2], "loss_obj": mean[3], "loss_class": mean[4]}


def batch_stat_buffers(model: YoloV3) -> List[torch.Tensor]:
    """The BatchNorm running means and variances."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    global_batch_size: int, group=None,
                    ) -> Callable[[TrainState, Batch, float],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch, lr) -> (state, metrics): the train-mode forward
    on this rank's `batch`, the loss over `global_batch_size`, backward,
    the gradients summed over `group`'s ranks, one Adam update at `lr`,
    and the running statistics averaged over the ranks; the metrics are
    tensors on the device (reading them synchronises)."""
    check_train_config(tcfg)
    world = D.world_size(group)

    def step(state: TrainState, batch: Batch, lr: float):
        # the optimizer's span opens twice, for zero_grad and for the step
        with tracing.span("yolo.step"):
            images, *labels = batch
            model = state.model.train()
            for g in state.optimizer.param_groups:
                g["lr"] = float(lr)
            with tracing.span("yolo.step.forward"):
                fms = model(images)
            with tracing.span("yolo.step.loss"):
                loss, yolo_loss = _loss_of(fms, model, cfg, tcfg,
                                           global_batch_size, labels)
            with tracing.span("yolo.step.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            with tracing.span("yolo.step.backward"):
                loss.backward()
                if world > 1:
                    D.all_reduce_sum_([p.grad for p in model.parameters()
                                       if p.grad is not None], group)
            with tracing.span("yolo.step.optimizer"):
                state.optimizer.step()
                if world > 1:
                    D.average_(batch_stat_buffers(model), group)
            state.step += 1
            state.stale = True
            return state, _metrics(loss, yolo_loss, group)

    return step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig,
                   global_batch_size: int, group=None,
                   ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """step(state, batch) -> metrics of the inference forward (running
    statistics) on this rank's `batch`, reduced over `group` as the train
    step's are; the state's parameters, statistics and moments stay as
    they were, and the model's mode is restored."""
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
        return _metrics(loss, yolo_loss, group)

    return step
