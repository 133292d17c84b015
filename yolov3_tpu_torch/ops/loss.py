"""YOLOv3 four-component loss (xy, wh, objectness, class): port of
`yolov3_tpu/ops/loss.py`'s 5D form (reference/model.py:214-354).

Kept as the JAX module has them:
- the static-shape ignore rule: the reference's V valid true boxes are
  anchor-sized boxes at the origin, so each prediction's best IoU is
  taken against the anchor priors present anywhere in the batch's
  ground truth, -inf where none is (V = 0 then ignores nothing);
- the xy loss is an MSE in logit space through a (0.01, 0.99) clip and
  the reference's explicit inverse sigmoid;
- the wh loss is an MSE of log(wh / anchor) with a zeros->ones guard and
  a [1e-9, 1e9] clip;
- per-scale sums are divided by the local batch; the train step divides
  the total by the global batch;
- the ignore mask and the targets carry no gradient (loss.py:124-125,
  138, 149).

One guard the JAX loss lacks: the wh logits are clamped at 80 before the
exp (`WH_LOGIT_MAX`). A cell without an object gets no gradient on its
wh logits, so they can drift; past 88.7 the f32 exp overflows, and the
backward's 0 * inf makes every gradient NaN. Past ln(1e9) ~ 20.7 the
[1e-9, 1e9] clip already fixes the value and zeroes the gradient, so the
clamp changes no loss value and no gradient that JAX's gives finite. It
is a guard, not a fix: the port's full-depth 512 px training drifts there
within ~500 steps on the card, where the reference's record of the same
recipe shows no divergence, and why is not yet known (ROADMAP Queue C
G1); with the guard that run still spikes late.

Gradient ties follow JAX's rules: `max(x, 0)` and the clips are
`torch.maximum`/`torch.minimum` against tensors, which split the
gradient evenly at a tie as `jnp.maximum`/`jnp.clip` do (`clamp` would
pass all of it); `|x|` takes gradient +1 at 0, as `jnp.abs` does
(`torch.abs` takes 0), so a logit of exactly 0 gets -z, JAX's value.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from yolov3_tpu_torch.ops.decode import (Anchors, anchor_tensor,
                                         reorg_feature_map)

XY_CLIP = 0.01  # reference/model.py:326
WH_LOG_CLIP_MIN = 1e-9  # reference/model.py:344
WH_LOG_CLIP_MAX = 1e9
# below the f32 exp's overflow at 88.72, above ln(WH_LOG_CLIP_MAX / 1e-3)
WH_LOGIT_MAX = 80.0
IGNORE_IOU_THRESHOLD = 0.5  # reference/model.py:273


class YoloLoss(NamedTuple):
    total: torch.Tensor
    xy: torch.Tensor
    wh: torch.Tensor
    objectness: torch.Tensor
    class_: torch.Tensor


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: minimum(maximum(x, lo), hi), ties split as JAX does."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _sigmoid_ce(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits:
    max(x, 0) - x*z + log1p(exp(-|x|))."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))


def _inverse_sigmoid(p: torch.Tensor) -> torch.Tensor:
    """-log(1/p - 1) (reference/model.py:331-333)."""
    return -torch.log(1.0 / p - 1.0)


def _anchor_prior_iou(pred_xy: torch.Tensor, pred_wh: torch.Tensor,
                      anchors: torch.Tensor,
                      anchor_present: torch.Tensor) -> torch.Tensor:
    """Best IoU [B, gh, gw, A] of each predicted box ([B, gh, gw, A, 2]
    centres and sizes) against the anchor priors at the origin that are
    present in the batch ([A] bool); -inf where none is."""
    pred_min = (pred_xy - pred_wh / 2.0)[..., None, :]   # [B,gh,gw,A,1,2]
    pred_max = (pred_xy + pred_wh / 2.0)[..., None, :]
    prior_min, prior_max = -anchors / 2.0, anchors / 2.0  # [A, 2]
    inter_wh = (torch.minimum(pred_max, prior_max)
                - torch.maximum(pred_min, prior_min)).clamp_min(0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]           # [B,gh,gw,A,A]
    pred_area = (pred_wh[..., 0] * pred_wh[..., 1])[..., None]
    prior_area = anchors[:, 0] * anchors[:, 1]
    iou = inter / (pred_area + prior_area - inter)
    masked = torch.where(anchor_present, iou,
                         iou.new_full((), float("-inf")))
    return masked.amax(dim=-1)


def loss_layer(feature_map: torch.Tensor, gt_grid: torch.Tensor,
               anchors: Anchors, number_classes: int,
               stride: int) -> Tuple[torch.Tensor, ...]:
    """Per-scale (xy, wh, objectness, class) losses.

    feature_map: NHWC [B, gh, gw, A*(5+C)] raw network output.
    gt_grid: [B, gh, gw, A, 5+C] label grid (absolute-pixel centre boxes,
    objectness flag, one-hot classes) from `data/encoder.py`.
    anchors: the (w, h) pairs, or a float32 [A, 2] tensor on the feature
    map's device (`anchor_tensor`), which the train step makes once.
    """
    anchors_t = anchor_tensor(anchors, feature_map.device)
    batch_size = float(feature_map.shape[0])
    gt_grid = gt_grid.to(torch.float32)

    xy_offset, pred_boxes, pred_obj_logits, pred_class_logits = (
        reorg_feature_map(feature_map, anchors_t, number_classes, stride,
                          max_twh=WH_LOGIT_MAX))
    object_mask = gt_grid[..., 4:5]                       # [B,gh,gw,A,1]
    pred_xy, pred_wh = pred_boxes[..., 0:2], pred_boxes[..., 2:4]

    # objectness: the ignore mask is a constant of the step
    with torch.no_grad():
        anchor_present = (object_mask[..., 0] > 0).any(dim=(0, 1, 2))
        best_iou = _anchor_prior_iou(pred_xy, pred_wh, anchors_t,
                                     anchor_present)
        ignore_mask = (best_iou < IGNORE_IOU_THRESHOLD).float()[..., None]
        valid_mask = object_mask + (1.0 - object_mask) * ignore_mask
    objectness_loss = (valid_mask * _sigmoid_ce(object_mask, pred_obj_logits)
                       ).sum() / batch_size

    class_loss = (object_mask * _sigmoid_ce(gt_grid[..., 5:],
                                            pred_class_logits)
                  ).sum() / batch_size

    # xy: MSE in logit space
    true_xy = _clip(gt_grid[..., 0:2] / float(stride) - xy_offset,
                    XY_CLIP, 1.0 - XY_CLIP)
    pred_cell_xy = _clip(pred_xy / float(stride) - xy_offset,
                         XY_CLIP, 1.0 - XY_CLIP)
    true_txy = _inverse_sigmoid(true_xy)
    pred_txy = _inverse_sigmoid(pred_cell_xy)
    xy_loss = ((true_txy - pred_txy).square() * object_mask).sum() / batch_size

    # wh: MSE in log space, zeros -> ones, clipped
    true_twh = gt_grid[..., 2:4] / anchors_t
    pred_twh = pred_wh / anchors_t
    true_twh = torch.where(true_twh == 0.0, torch.ones_like(true_twh),
                           true_twh)
    pred_twh = torch.where(pred_twh == 0.0, torch.ones_like(pred_twh),
                           pred_twh)
    true_twh = torch.log(_clip(true_twh, WH_LOG_CLIP_MIN, WH_LOG_CLIP_MAX))
    pred_twh = torch.log(_clip(pred_twh, WH_LOG_CLIP_MIN, WH_LOG_CLIP_MAX))
    wh_loss = ((true_twh - pred_twh).square() * object_mask).sum() / batch_size

    return xy_loss, wh_loss, objectness_loss, class_loss


def compute_loss(feature_maps: Sequence[torch.Tensor],
                 gt_grids: Sequence[torch.Tensor],
                 anchors: Anchors, number_classes: int,
                 strides: Sequence[int] = (32, 16, 8)) -> YoloLoss:
    """The four components summed over the scales
    (reference/model.py:214-228)."""
    parts = [loss_layer(fm, gt, anchors, number_classes, stride)
             for fm, gt, stride in zip(feature_maps, gt_grids, strides)]
    xy, wh, obj, cls = (sum(p[i] for p in parts) for i in range(4))
    return YoloLoss(xy + wh + obj + cls, xy, wh, obj, cls)


def l2_regularization(model: torch.nn.Module,
                      weight_decay: float) -> torch.Tensor:
    """Keras-style L2 penalty, wd * sum(w^2) over the conv kernels (the
    Flax tree's `kernel` leaves: every `conv.weight`). The reference
    defines it but never adds it (reference/model.py:37,117,485-492);
    `TrainConfig.apply_weight_decay` opts in."""
    total = sum(p.float().square().sum() for name, p in model.named_parameters()
                if name.endswith("conv.weight"))
    return weight_decay * total
