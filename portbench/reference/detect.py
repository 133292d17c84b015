"""Plain reference of the detector's post-processing: box decode, clip to
the image, the strict small-box filter, the score rule and the per-class
NMS candidates (usnistgov/object-detection-yolov3 `model.py`,
`bbox_utils.py`; the greedy suppression is `judge.greedy_keep`), plus the
objectness shift that gives random weights a trained detector's score
sparsity.

Decode, per cell and anchor (YOLOv3):
    b_x = (sigmoid(t_x) + c_x) * stride      b_w = anchor_w * exp(t_w)
corners b -/+ wh / 2; score = sqrt(sigmoid(t_obj) * sigmoid(t_class)),
zero objectness where the clipped box is not wider AND taller than the
minimum size. NMS candidates per class: the boxes with score >= the
threshold, in descending score order (ties: lower index first), the
first `max_boxes`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32


def decode(fms: Sequence[torch.Tensor], anchors, classes: int,
           strides=(32, 16, 8)) -> torch.Tensor:
    """Feature maps [N, gh, gw, A*(5+C)] -> rows [N, boxes, 4+1+C] of
    (x0, y0, x1, y1, sigmoid objectness, sigmoid classes), ordered by
    (scale, cell, anchor), in float32."""
    out = []
    for fm, stride in zip(fms, strides):
        n, gh, gw, _ = fm.shape
        a = len(anchors)
        f = fm.to(F32).reshape(n, gh, gw, a, 5 + classes)
        row, col = torch.meshgrid(
            torch.arange(gh, dtype=F32, device=fm.device),
            torch.arange(gw, dtype=F32, device=fm.device), indexing="ij")
        off = torch.stack([col, row], -1).reshape(gh, gw, 1, 2)
        anc = torch.tensor(anchors, dtype=F32, device=fm.device)
        xy = (torch.sigmoid(f[..., 0:2]) + off) * float(stride)
        wh = torch.exp(f[..., 2:4]) * anc
        rows = torch.cat([xy - 0.5 * wh, xy + 0.5 * wh,
                          torch.sigmoid(f[..., 4:5]),
                          torch.sigmoid(f[..., 5:])], -1)
        out.append(rows.reshape(n, -1, 5 + classes))
    return torch.cat(out, 1)


def scores(det: np.ndarray, img_hw, min_box_size: float
           ) -> Tuple[np.ndarray, np.ndarray]:
    """One image's rows [N, 5+C] -> (clipped boxes [N, 4], scores [C, N])."""
    h, w = img_hw
    b = det[:, 0:4].astype(np.float32).copy()
    b[:, 0] = np.clip(b[:, 0], 0, w)
    b[:, 2] = np.clip(b[:, 2], 0, w)
    b[:, 1] = np.clip(b[:, 1], 0, h)
    b[:, 3] = np.clip(b[:, 3], 0, h)
    obj = det[:, 4].astype(np.float32)
    big = ((b[:, 2] - b[:, 0]) > min_box_size) & (
        (b[:, 3] - b[:, 1]) > min_box_size)
    obj = np.where(big, obj, np.float32(0))
    prod = (det[:, 5:].astype(np.float32).T * obj[None, :]).astype(np.float32)
    return b, np.sqrt(prod.astype(np.float64)).astype(np.float32)


def candidates(boxes: np.ndarray, cls_scores: np.ndarray,
               score_threshold: float, max_boxes: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per class: the boxes scoring >= the threshold, in descending score
    order (ties: lower index first), the first `max_boxes`."""
    out = []
    for s in cls_scores:
        idx = np.nonzero(s >= score_threshold)[0]
        idx = idx[np.argsort(-s[idx], kind="stable")][:max_boxes]
        out.append((boxes[idx].reshape(-1, 4), s[idx]))
    return out


def objectness_shift(det: np.ndarray, share: float, score_threshold: float,
                     iters: int = 40) -> float:
    """The shift d of every objectness logit at which `share` of the raw
    boxes in `det` [N, boxes, 5+C] score >= `score_threshold` for some
    class (bisected; the share falls as d falls)."""
    obj = np.clip(det[..., 4].astype(np.float64), 1e-7, 1 - 1e-7)
    logit = np.log(obj) - np.log1p(-obj)
    cls = det[..., 5:].astype(np.float64)

    def above(d):
        o = 1.0 / (1.0 + np.exp(-(logit + d)))
        return float((np.sqrt(cls * o[..., None]) >= score_threshold
                      ).any(-1).mean())

    lo, hi = -40.0, 10.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if above(mid) < share else (lo, mid)
    return 0.5 * (lo + hi)
