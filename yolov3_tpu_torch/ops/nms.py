"""On-device non-maximum suppression (port of `yolov3_tpu/ops/nms.py`).

    scores = sqrt(class_probs * objectness)          # reference score rule
    per (image, class): threshold -> top-K by score -> greedy suppression

The greedy recurrence keep[i] = valid[i] AND no kept j < i with
IoU(j, i) > threshold is the reference's survivor rule (ties at the
threshold survive), so for N <= K and distinct scores the result equals
`ops/boxes.py::per_class_nms` bit for bit. Results stay fixed-size
(boxes, scores, keep) tensors; `nms_to_host` gives the reference's ragged
(boxes, scores, labels).

Suppression runs through the hand-written kernel
(`ops/kernels/nms_suppress.py`) for CUDA tensors and through the plain
`_greedy_suppress` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def pairwise_iou(boxes: Tensor) -> Tensor:
    """IoU matrices [..., K, K] for ltrb boxes [..., K, 4]
    (area = (r-l)*(b-t), no +1)."""
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:4], boxes[..., None, :, 2:4])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def _greedy_suppress(iou: Tensor, valid: Tensor, iou_threshold: float
                     ) -> Tensor:
    """Sequential greedy keep-mask over score-sorted candidates, batched
    over leading dims: iou [..., K, K], valid [..., K] -> keep [..., K]."""
    keep = torch.zeros_like(valid)
    for i in range(iou.shape[-1]):
        # keep[j] for j >= i is still False, which gives the j < i rule
        suppressed = (keep & (iou[..., :, i] > iou_threshold)).any(dim=-1)
        keep[..., i] = valid[..., i] & ~suppressed
    return keep


def batched_nms_device(detections: Tensor, num_classes: int,
                       iou_threshold: float = 0.3,
                       score_threshold: float = 0.1,
                       max_boxes: int = 512,
                       min_box_size: Optional[float] = None,
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """NMS over a batch of decoded detections [B, N, 4+1+C] on their device.

    Optionally applies the strict small-box filter
    (reference/bbox_utils.py:274-281) by zeroing those candidates'
    objectness. Returns (boxes [B, C, K, 4], scores [B, C, K],
    keep [B, C, K] bool), candidates score-sorted per class; K =
    min(max_boxes, N) caps the candidates of one class in one image.
    """
    from yolov3_tpu_torch.ops.kernels.nms_suppress import suppress_boxes_t

    boxes = detections[..., 0:4]
    objectness = detections[..., 4:5]
    class_probs = detections[..., 5:5 + num_classes]
    if min_box_size is not None:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        big = ((w > min_box_size) & (h > min_box_size))[..., None]
        objectness = torch.where(big, objectness, 0.0)

    b, n = boxes.shape[0], boxes.shape[1]
    k = min(max_boxes, n)
    # the square root goes through float64 so that it is correctly rounded
    # to float32 on every device, as XLA's and numpy's are (torch's CPU
    # float32 sqrt is off by one ulp on some inputs)
    prod = class_probs.transpose(1, 2) * objectness[..., 0][:, None, :]
    scores_all = torch.sqrt(prod.double()).float()              # [B, C, N]
    # top-K over the folded [B*C, N] scores; lax.top_k puts the lower
    # index first among equal scores (the -1 sentinels tie everywhere),
    # which a stable descending sort reproduces and torch.topk does not
    flat = scores_all.reshape(b * num_classes, n)
    masked = torch.where(flat >= score_threshold, flat, -1.0)
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    # (sort may hand back a column-major result; the kernel takes rows)
    top_scores = top_scores[:, :k].contiguous().reshape(b, num_classes, k)
    top_idx = top_idx[:, :k].contiguous().reshape(b, num_classes, k)
    # one flat row gather with indices made global over the batch
    gidx = top_idx + (torch.arange(b, device=top_idx.device) * n)[:, None, None]
    cand = boxes.reshape(b * n, 4)[gidx.reshape(-1)].reshape(
        b, num_classes, k, 4)
    valid = top_scores >= score_threshold
    keep = suppress_boxes_t(cand.reshape(b * num_classes, k, 4),
                            valid.reshape(b * num_classes, k), iou_threshold)
    return cand, top_scores, keep.reshape(b, num_classes, k)


def per_class_nms_device(boxes: Tensor, objectness: Tensor,
                         class_probs: Tensor, iou_threshold: float = 0.3,
                         score_threshold: float = 0.1,
                         max_boxes: int = 512,
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class greedy NMS for one image: boxes [N, 4] ltrb, objectness
    [N, 1], class_probs [N, C] -> (boxes [C, K, 4], scores [C, K],
    keep [C, K]); the batch-of-one case of `batched_nms_device`."""
    det = torch.cat([boxes, objectness, class_probs], dim=-1)[None]
    out = batched_nms_device(det, class_probs.shape[-1], iou_threshold,
                             score_threshold, max_boxes)
    return tuple(o[0] for o in out)


_saturation_warned = False


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def warn_if_saturated(cand_scores) -> bool:
    """One-time operator warning when the fixed top-K candidate list filled.

    Below-threshold slots carry the -1.0 sentinel, so a class whose last
    candidate score is non-negative had >= K above-threshold candidates
    and detections may have been dropped. Returns True when saturated.
    """
    global _saturation_warned
    saturated = bool((_host(cand_scores)[..., -1] >= 0).any())
    if saturated and not _saturation_warned:
        _saturation_warned = True
        print("WARNING: device NMS candidate list saturated (>= max_boxes "
              "above-score-threshold detections in one class); detections "
              "may have been dropped — raise --max-boxes.")
    return saturated


def nms_to_host(cand_boxes, cand_scores, keep
                ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
                           Optional[np.ndarray]]:
    """One image's fixed-size NMS output -> the reference's ragged
    (boxes [M,4], scores [M], labels [M]), or (None, None, None) when
    nothing survives (reference/bbox_utils.py:264-271)."""
    cand_boxes = _host(cand_boxes)
    cand_scores = _host(cand_scores)
    keep = _host(keep)
    warn_if_saturated(cand_scores)
    out_b, out_s, out_l = [], [], []
    for c in range(cand_boxes.shape[0]):
        sel = keep[c]
        if sel.any():
            out_b.append(cand_boxes[c][sel])
            out_s.append(cand_scores[c][sel])
            out_l.append(np.full(int(sel.sum()), c, dtype=np.int32))
    if not out_b:
        return None, None, None
    return (np.concatenate(out_b), np.concatenate(out_s),
            np.concatenate(out_l))
