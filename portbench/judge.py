"""The comparisons that decide `correct`: the numbers a run's outputs give
against the plain reference's, each held to its limit.

Serving, per image and class, over the candidates (the boxes scoring at
or above the threshold, in descending score order, at most K) and the
NMS keep mask the program returns, against the reference's candidates
for the same image:
- `score_gap`: the widest difference of the k-th highest scores of the
  two sides, the shorter side's list filled up with the threshold: the
  k-th largest of max(score, threshold) over all boxes, which moves by at
  most the widest per-box score difference, whatever order close scores
  take and whichever boxes cross the threshold;
- `box_gap`: the widest, over every candidate of either side scoring at
  least the threshold plus `margin` (the cell's `score_margin`, above the
  per-box score differences of sound runs: its partner is then a
  candidate of the other side too), of 1 - its best IoU with the other
  side's candidates of its class whose score lies within `margin` of its
  own; `box_gap_mean` the mean of the same over every candidate of every
  image compared (`box_gap_sum` / `box_gap_count`; a steady number where
  single boxes swing);
- `box_gap_rel` (`loops/serve_closed.py`): `box_gap_mean` as a share of
  the same number of the 8-bit reference against the same reference;
- `keep_diff`: the keep flags that differ from the reference's greedy
  NMS (IoU > threshold suppresses, ties survive) run on the program's own
  candidates: the suppression is exact given its input, which a small
  change of score order would reshuffle.

Training: with `norm_gap(a, b)` = |a - b| / max(b, the median leaf's b)
for per-leaf norms a (the program's) and b (the reference's):
- `loss_gap`: the widest |loss difference| / |reference loss| of the
  first steps;
- `grad_gap`: the worst leaf's norm_gap of the first step's gradient;
- `change_gap`: the worst leaf's norm_gap of the parameters' change over
  the first steps, among the leaves whose reference gradient norm is at
  least `MOVED` times the median leaf's (the others move by round-off
  alone under Adam);
- `feed_gap`: the widest |difference| of the preprocessed images;
- `label_diff`: the count of label-grid values that differ.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MOVED = 1e-3


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / (area_a[:, None] + area_b[None, :] - inter)
    return np.nan_to_num(iou)


def greedy_keep(boxes: np.ndarray, valid: np.ndarray,
                iou_threshold: float) -> np.ndarray:
    """keep[i] = valid[i] and no kept j < i with IoU(j, i) > threshold, in
    float32 (area (r-l)*(b-t))."""
    b = boxes.astype(np.float32)
    keep = np.zeros(len(b), bool)
    for i in range(len(b)):
        if not valid[i]:
            continue
        kept = np.nonzero(keep[:i])[0]
        if len(kept):
            lt = np.maximum(b[kept, :2], b[i, :2])
            rb = np.minimum(b[kept, 2:4], b[i, 2:4])
            wh = np.maximum(rb - lt, np.float32(0))
            inter = wh[:, 0] * wh[:, 1]
            area_k = (b[kept, 2] - b[kept, 0]) * (b[kept, 3] - b[kept, 1])
            area_i = (b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
            iou = inter / (area_k + area_i - inter)
            if (iou > np.float32(iou_threshold)).any():
                continue
        keep[i] = True
    return keep


def _box_gaps(a_boxes, a_scores, b_boxes, b_scores, floor,
              margin) -> List[float]:
    """Over a's candidates scoring >= floor: 1 - the best IoU with a
    candidate of b whose score is within `margin` of its own (1 where b
    has none)."""
    out = []
    for box, s in zip(a_boxes[a_scores >= floor], a_scores[a_scores >= floor]):
        near = np.abs(b_scores - s) <= margin
        best = _iou_matrix(box[None], b_boxes[near]).max() if near.any() \
            else 0.0
        out.append(1.0 - float(best))
    return out


def compare_image(boxes: np.ndarray, scores: np.ndarray, keep: np.ndarray,
                  ref: Sequence[Tuple[np.ndarray, np.ndarray]],
                  score_threshold: float, iou_threshold: float,
                  margin: float) -> Dict[str, float]:
    """The serving numbers of one image: the program's fixed-size output
    (boxes [C, K, 4], scores [C, K] with -1 below the threshold, keep
    [C, K]) against the reference's per-class candidates (boxes [N, 4],
    scores [N], descending)."""
    out = {"score_gap": 0.0, "box_gap": 0.0, "keep_diff": 0.0}
    floor = score_threshold + margin
    gaps = []
    for c, (rb, rs) in enumerate(ref):
        valid = scores[c] >= score_threshold
        pb, ps = boxes[c][valid], scores[c][valid]
        n = max(len(ps), len(rs))
        if n:
            a = np.full(n, score_threshold, np.float64)
            b = np.full(n, score_threshold, np.float64)
            a[:len(ps)], b[:len(rs)] = ps, rs
            out["score_gap"] = max(out["score_gap"],
                                   float(np.abs(a - b).max()))
        gaps += (_box_gaps(pb, ps, rb, rs, floor, margin)
                 + _box_gaps(rb, rs, pb, ps, floor, margin))
        want = greedy_keep(boxes[c], valid, iou_threshold)
        out["keep_diff"] += float((want != keep[c]).sum())
    out["box_gap"] = max(gaps, default=0.0)
    out["box_gap_sum"], out["box_gap_count"] = float(sum(gaps)), len(gaps)
    return out


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              among: Sequence[str] = None) -> Tuple[float, str]:
    """The worst leaf's |prog - ref| / max(ref, the median leaf's ref), and
    that leaf's name, over the leaves `among` (default: all)."""
    names = list(ref) if among is None else list(among)
    med = float(np.median([ref[k] for k in ref]))
    worst, at = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= MOVED * med]


def held(checks: Sequence[Tuple[str, float, float]]) -> bool:
    """Every number within its limit (a NaN never is)."""
    return all(v <= lim for _, v, lim in checks)
