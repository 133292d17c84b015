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

On one CUDA device (`graphable`: the parameters on CUDA, no group of
more than one rank) the train step replays as one CUDA graph: forward,
loss, backward and Adam, captured once per input signature (the shapes,
dtypes and device of the images and the three label grids). The first
step of a signature runs eagerly on a side stream, as warm-up, and makes
Adam's state; the second captures and replays; later steps copy the
batch into the graph's input buffers, fill the learning rate's device
tensor and replay. Adam is then `capturable` with lr that tensor
(`make_optimizer`): the same update in another rounding order. A graph
is tied to the state's tensors (parameters, running statistics, static
QAT's scales, Adam's state, lr): when one is replaced, as
`utils/checkpoint.py`'s restore replaces Adam's, the step runs eagerly
again and captures anew. Nothing in the captured work may synchronise
with the host, so the forward and the loss make no tensor from host data
(the anchors are made once, a step's first). QAT, static too, and
`remat_blocks` replay as well. The multi-rank step, with its collectives
(ZeRO-1 among them), and the CPU keep the eager step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models.yolo import YoloV3, prepare_all
from yolov3_tpu_torch.ops.decode import Anchors, anchor_tensor
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


def graphable(model: torch.nn.Module, group=None) -> bool:
    """Whether the train step replays as one CUDA graph: the parameters on
    CUDA and no group of more than one rank."""
    return next(model.parameters()).is_cuda and D.world_size(group) == 1


def make_optimizer(model: torch.nn.Module, tcfg: TrainConfig,
                   group=None) -> torch.optim.Optimizer:
    """Adam over the model's parameters; with `tcfg.shard_optimizer` on a
    group of more than one rank, ZeRO-1 over that group. Where the step
    is `graphable`, a capturable Adam whose lr is a device tensor."""
    kw = dict(lr=tcfg.learning_rate, betas=(tcfg.adam_b1, tcfg.adam_b2),
              eps=tcfg.adam_eps)
    if tcfg.shard_optimizer and D.world_size(group) > 1:
        from torch.distributed.optim import ZeroRedundancyOptimizer
        return ZeroRedundancyOptimizer(
            model.parameters(), optimizer_class=torch.optim.Adam,
            process_group=group, **kw)
    if graphable(model, group):
        device = next(model.parameters()).device
        kw.update(lr=torch.full((), tcfg.learning_rate, device=device),
                  capturable=True)
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
             labels: Sequence[torch.Tensor],
             anchors: Optional[Anchors] = None
             ) -> Tuple[torch.Tensor, YoloLoss]:
    """The loss of the feature maps `fms`, weight decay included; `anchors`
    (a device tensor) in place of `cfg.anchors`."""
    yolo_loss = compute_loss(fms, labels,
                             cfg.anchors if anchors is None else anchors,
                             cfg.number_classes, cfg.strides)
    loss = yolo_loss.total / float(global_batch_size)
    if tcfg.apply_weight_decay:
        loss = loss + l2_regularization(model, tcfg.weight_decay)
    return loss, yolo_loss


def _parts(loss: torch.Tensor, yolo_loss: YoloLoss,
           group=None) -> torch.Tensor:
    """[loss, xy, wh, objectness, class], summed over `group`'s ranks (one
    all_reduce)."""
    parts = torch.stack([loss.detach().float(), yolo_loss.xy.detach(),
                         yolo_loss.wh.detach(),
                         yolo_loss.objectness.detach(),
                         yolo_loss.class_.detach()])
    if D.world_size(group) > 1:
        D.all_reduce_sum_([parts], group)
    return parts


def _metrics_of(parts: torch.Tensor, world: int) -> Dict[str, torch.Tensor]:
    """The JAX keys of `_parts`: `loss_sum` the ranks' sum, the others
    their means."""
    mean = parts / world if world > 1 else parts
    return {"loss": mean[0], "loss_sum": parts[0], "loss_xy": mean[1],
            "loss_wh": mean[2], "loss_obj": mean[3], "loss_class": mean[4]}


def _metrics(loss: torch.Tensor, yolo_loss: YoloLoss,
             group=None) -> Dict[str, torch.Tensor]:
    """The JAX keys; over a group, `loss_sum` is the ranks' sum and the
    others their means (one all_reduce)."""
    return _metrics_of(_parts(loss, yolo_loss, group), D.world_size(group))


def batch_stat_buffers(model: YoloV3) -> List[torch.Tensor]:
    """The BatchNorm running means and variances."""
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


class _Captured(NamedTuple):
    """One signature's graph: its input buffers and output, the
    gradients it writes, and the state it was captured on: the model, its
    buffers' places, and the tensors `_state_tensors` names (held, so that
    no other tensor takes their memory) with their addresses."""
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]
    parts: torch.Tensor
    grads: List[Optional[torch.Tensor]]
    model: YoloV3
    slots: List[Tuple[torch.nn.Module, str]]
    tensors: List[torch.Tensor]
    addresses: List[int]


def _buffer_slots(model: YoloV3) -> List[Tuple[torch.nn.Module, str]]:
    """(module, name) of the running statistics and static QAT's scales."""
    return [(m, n) for m in model.modules()
            for n, _ in m.named_buffers(recurse=False)
            if n in ("running_mean", "running_var", "act_scale")]


def _state_tensors(optimizer: torch.optim.Optimizer,
                   slots: Sequence[Tuple[torch.nn.Module, str]]
                   ) -> List[torch.Tensor]:
    """The tensors a captured step reads and writes in place: lr, the
    parameters with Adam's state for each, the buffers in `slots`."""
    out = [g["lr"] for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        for p in g["params"]:
            out.append(p)
            out.extend(v for v in optimizer.state.get(p, {}).values()
                       if isinstance(v, torch.Tensor))
    return out + [getattr(m, n) for m, n in slots]


def _addresses(tensors: Sequence[torch.Tensor]) -> List[int]:
    return [t.data_ptr() for t in tensors]


def _capturable(optimizer: torch.optim.Optimizer) -> bool:
    return all(g.get("capturable") and isinstance(g["lr"], torch.Tensor)
               for g in optimizer.param_groups)


def _no_span(name: str):
    return contextlib.nullcontext()


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's lr: a device tensor filled, a number replaced."""
    for g in optimizer.param_groups:
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].fill_(lr)
        else:
            g["lr"] = float(lr)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    global_batch_size: int, group=None,
                    ) -> Callable[[TrainState, Batch, float],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch, lr) -> (state, metrics): the train-mode forward
    on this rank's `batch`, the loss over `global_batch_size`, backward,
    the gradients summed over `group`'s ranks, one Adam update at `lr`,
    and the running statistics averaged over the ranks; the metrics are
    tensors on the device (reading them synchronises), a replayed step's
    a copy of the graph's. Where the state is `graphable` with a
    capturable Adam, the step is replayed as a CUDA graph (the module's
    docstring); `step.replayed` or `step.eager` counts each step."""
    check_train_config(tcfg)
    world = D.world_size(group)
    anchors: Dict[torch.device, torch.Tensor] = {}
    side: Dict[torch.device, "torch.cuda.Stream"] = {}
    graphs: Dict[tuple, Optional[_Captured]] = {}

    def run(state: TrainState, batch: Batch, spans: bool) -> torch.Tensor:
        """Forward, loss, backward and Adam; the metrics' `_parts`. The
        phase spans open where `spans`: the optimizer's twice, for
        zero_grad and for the step."""
        span = tracing.span if spans else _no_span
        images, *labels = batch
        model = state.model
        if images.device not in anchors:
            anchors[images.device] = anchor_tensor(cfg.anchors,
                                                   images.device)
        with span("yolo.step.forward"):
            fms = model(images)
        with span("yolo.step.loss"):
            loss, yolo_loss = _loss_of(fms, model, cfg, tcfg,
                                       global_batch_size, labels,
                                       anchors[images.device])
        with span("yolo.step.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("yolo.step.backward"):
            loss.backward()
            if world > 1:
                D.all_reduce_sum_([p.grad for p in model.parameters()
                                   if p.grad is not None], group)
        with span("yolo.step.optimizer"):
            state.optimizer.step()
            if world > 1:
                D.average_(batch_stat_buffers(model), group)
        return _parts(loss, yolo_loss, group)

    def warm_up(state: TrainState, batch: Batch) -> torch.Tensor:
        """An eager step on a side stream (cuDNN's and the allocator's
        first calls stay out of the capture)."""
        dev = batch[0].device
        if dev not in side:
            side[dev] = torch.cuda.Stream(dev)
        stream = side[dev]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            parts = run(state, batch, True)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return parts

    def capture(state: TrainState, batch: Batch) -> _Captured:
        """Capture one step on copies of `batch`; nothing runs until the
        graph is replayed."""
        state.optimizer.zero_grad(set_to_none=True)
        inputs = [t.clone() for t in batch]
        graph = torch.cuda.CUDAGraph()
        # thread-local: the trainer's prefetcher keeps staging batches
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            parts = run(state, inputs, False)
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        slots = _buffer_slots(state.model)
        tensors = _state_tensors(state.optimizer, slots)
        return _Captured(graph, inputs, parts, [p.grad for p in params],
                         state.model, slots, tensors, _addresses(tensors))

    def replayed(state: TrainState, batch: Batch) -> Optional[torch.Tensor]:
        """The graph's step, or None where this step runs eagerly (the
        signature's first, or the state's tensors were replaced)."""
        key = tuple((t.shape, t.dtype, t.device) for t in batch)
        rec = graphs.get(key)
        if key not in graphs or (rec is not None and (
                state.model is not rec.model or rec.addresses != _addresses(
                    _state_tensors(state.optimizer, rec.slots)))):
            graphs[key] = None  # this step warms up, the next captures
            return None
        if rec is None:
            rec = graphs[key] = capture(state, batch)
        else:
            for buf, t in zip(rec.inputs, batch):
                buf.copy_(t)
        rec.graph.replay()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        if params and params[0].grad is not rec.grads[0]:
            for p, grad in zip(params, rec.grads):
                p.grad = grad
        return rec.parts.clone()

    def step(state: TrainState, batch: Batch, lr: float):
        with tracing.span("yolo.step"):
            model = state.model.train()
            _set_lr(state.optimizer, lr)
            graphed = graphable(model, group) and _capturable(
                state.optimizer)
            parts = replayed(state, batch) if graphed else None
            tracing.count("step.eager" if parts is None else
                          "step.replayed", 1)
            if parts is None:
                parts = (warm_up(state, batch) if graphed
                         else run(state, batch, True))
            state.step += 1
            state.stale = True
            return state, _metrics_of(parts, world)

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
