"""YOLO box decode (port of `yolov3_tpu/ops/decode.py`), in float32.

Per cell and anchor (YOLOv3 paper, reference/model.py:122-212):
    b_x = (sigmoid(t_x) + c_x) * stride      b_w = anchor_w * exp(t_w)
    b_y = (sigmoid(t_y) + c_y) * stride      b_h = anchor_h * exp(t_h)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from yolov3_tpu_torch.utils import tracing

Anchors = Union[Sequence[Tuple[float, float]], torch.Tensor]


def anchor_tensor(anchors: Anchors, device) -> torch.Tensor:
    """The anchors as a float32 [A, 2] tensor: a tensor as it is, (w, h)
    pairs copied from the host onto `device` (a copy that synchronises)."""
    if isinstance(anchors, torch.Tensor):
        return anchors
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def reorg_feature_map(feature_map: torch.Tensor, anchors: Anchors,
                      number_classes: int, stride: int,
                      max_twh: Optional[float] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Decode one NHWC feature map [N, gh, gw, A*(5+C)].

    Returns (xy_offset [gh,gw,1,2], boxes [N,gh,gw,A,4] as absolute-pixel
    (cx, cy, w, h), objectness_logits [N,gh,gw,A,1], class_logits
    [N,gh,gw,A,C]). With `max_twh` the wh logits are clamped to it before
    the exp (the loss's overflow guard, `ops/loss.py`).
    """
    n, gh, gw, _ = feature_map.shape
    dev = feature_map.device
    fm = feature_map.to(torch.float32).reshape(
        n, gh, gw, len(anchors), 5 + number_classes)
    # channel 0 is the column (x), channel 1 the row (y)
    row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=dev),
                              torch.arange(gw, dtype=torch.float32, device=dev),
                              indexing="ij")
    xy_offset = torch.stack([col, row], dim=-1).reshape(gh, gw, 1, 2)
    anchors_t = anchor_tensor(anchors, dev)
    box_xy = (torch.sigmoid(fm[..., 0:2]) + xy_offset) * float(stride)
    twh = fm[..., 2:4]
    if max_twh is not None:
        twh = torch.clamp(twh, max=max_twh)
    box_wh = torch.exp(twh) * anchors_t
    boxes = torch.cat([box_xy, box_wh], dim=-1)
    return xy_offset, boxes, fm[..., 4:5], fm[..., 5:]


def decode_detections(feature_maps: Sequence[torch.Tensor],
                      anchors: Sequence[Tuple[float, float]],
                      number_classes: int,
                      strides: Sequence[int] = (32, 16, 8)) -> torch.Tensor:
    """Decode all scales into detections [N, num_boxes, 4+1+C].

    Rows are [x0, y0, x1, y1, objectness, class_probs...], corners
    unclipped, ordered (scale, cell, anchor). Corners are c - 0.5*wh and
    c + 0.5*wh, the JAX decode's op order (decode.py:113-114).
    """
    with tracing.span("yolo.decode"):
        out = []
        for fm, stride in zip(feature_maps, strides):
            _, boxes, obj, cls = reorg_feature_map(fm, anchors,
                                                   number_classes, stride)
            xy, wh = boxes[..., 0:2], boxes[..., 2:4]
            rows = torch.cat([xy - 0.5 * wh, xy + 0.5 * wh,
                              torch.sigmoid(obj), torch.sigmoid(cls)],
                             dim=-1)
            out.append(rows.reshape(fm.shape[0], -1, 5 + number_classes))
        return torch.cat(out, dim=1)
