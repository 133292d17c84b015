"""Host-side box geometry, greedy NMS and CSV I/O (numpy).

Own copy of the serving subset of `yolov3_tpu/ops/boxes.py`: the numpy
oracle that the device NMS must match bit for bit, the CSV readers and
writers (headers and layouts byte for byte as the reference,
reference/bbox_utils.py:47-124,284-300) and the debug box drawing.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# IoU + greedy NMS (reference/bbox_utils.py:200-281)
# ---------------------------------------------------------------------------

def compute_iou(box: np.ndarray, boxes: np.ndarray,
                box_area: Optional[np.ndarray] = None,
                boxes_area: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU of one ltrb `box` against many `boxes` [N,4]; areas are
    (r-l)*(b-t) with no +1 and the intersection clamps at zero."""
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:4], boxes[:, 2:4])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    if box_area is None:
        box_area = (box[2] - box[0]) * (box[3] - box[1])
    if boxes_area is None:
        boxes_area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (box_area + boxes_area - inter)


def single_class_nms(boxes: np.ndarray, scores: np.ndarray,
                     iou_threshold: float) -> List[int]:
    """Greedy descending-score suppression; returns kept indices. A box is
    dropped when its IoU with a kept box exceeds the threshold (ties at
    exactly the threshold are kept)."""
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = scores.argsort()[::-1]
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        order = order[1:]
        if order.size == 0:
            break
        iou = compute_iou(boxes[i], boxes[order], areas[i], areas[order])
        order = order[iou <= iou_threshold]
    return keep


def per_class_nms(boxes: np.ndarray, objectness: np.ndarray,
                  class_probs: np.ndarray, iou_threshold: float = 0.3,
                  score_threshold: float = 0.1,
                  ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
                             Optional[np.ndarray]]:
    """Per-class greedy NMS over one image's detections.

    Score is sqrt(class_prob * objectness); candidates with score >=
    `score_threshold` enter NMS. Returns (boxes[M,4], scores[M], labels[M])
    or (None, None, None) when no class has any candidate.
    """
    num_classes = class_probs.shape[1]
    scores = np.sqrt(class_probs * objectness)

    out_boxes, out_scores, out_labels = [], [], []
    for c in range(num_classes):
        sel = np.where(scores[:, c] >= score_threshold)
        cand_boxes = boxes[sel]
        cand_scores = scores[:, c][sel]
        if cand_boxes.shape[0] == 0:
            continue
        kept = single_class_nms(cand_boxes, cand_scores, iou_threshold)
        out_boxes.append(cand_boxes[kept])
        out_scores.append(cand_scores[kept])
        out_labels.append(np.full(len(kept), c, dtype=np.int32))

    if not out_boxes:
        return None, None, None
    return (np.concatenate(out_boxes, axis=0),
            np.concatenate(out_scores, axis=0),
            np.concatenate(out_labels, axis=0))


def filter_small_boxes(boxes: np.ndarray, min_size: float) -> np.ndarray:
    """Keep rows whose ltrb width AND height strictly exceed `min_size`;
    extra columns pass through untouched."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return boxes[np.logical_and(w > min_size, h > min_size), :]


# ---------------------------------------------------------------------------
# CSV I/O
# ---------------------------------------------------------------------------

def box_union(boxes: np.ndarray, weights: np.ndarray
              ) -> Tuple[np.ndarray, float]:
    """The hull of ltrb `boxes` ([1, 4]) and their mean weight
    (reference/bbox_utils.py:127-135)."""
    bb = np.array([[boxes[:, 0].min(), boxes[:, 1].min(),
                    boxes[:, 2].max(), boxes[:, 3].max()]])
    return bb, float(np.mean(weights))


def union_all_overlapping_bb(boxes: np.ndarray, scores: np.ndarray,
                             minimum_iou_for_merge: float = 0.0,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge overlapping ltrb boxes into their hulls until none overlap
    (reference/bbox_utils.py:138-197; no CLI calls it). A worklist in
    descending score: its head absorbs every box whose IoU with it
    exceeds the threshold (hull, mean score) and goes to the back; the
    loop ends once a whole pass merges nothing."""
    if len(scores) <= 1:
        return boxes, scores
    boxes = boxes.astype(np.float64, copy=True)
    scores = np.array(scores, copy=True)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    worklist = scores.argsort()[::-1].tolist()
    stale_passes = 0
    while len(worklist) > 1 and stale_passes <= len(worklist):
        idx = worklist.pop(0)
        rest = np.asarray(worklist)
        ious = compute_iou(boxes[idx], boxes[rest], areas[idx], areas[rest])
        hit = np.nonzero(ious > minimum_iou_for_merge)[0]
        if hit.size:
            stale_passes = 0
            members = np.append(rest[hit], idx)
            hull, w = box_union(boxes[members], scores[members])
            boxes[idx, :] = hull[0]
            scores[idx] = w
            areas[idx] = (hull[0, 2] - hull[0, 0]) * (hull[0, 3] - hull[0, 1])
            absorbed = set(hit.tolist())
            worklist = [v for k, v in enumerate(worklist)
                        if k not in absorbed]
        else:
            stale_passes += 1
        worklist.append(idx)
    sel = np.asarray(worklist)
    return boxes[sel, :], scores[sel]


def load_boxes_to_xywhc(filepath: str) -> np.ndarray:
    """Read an annotation CSV into [N,5] float (x, y, w, h, class); a
    missing file yields an empty [0,5] array."""
    rows: List[List[int]] = []
    if os.path.exists(filepath):
        with open(filepath, newline="") as fh:
            for row in csv.DictReader(fh, skipinitialspace=True):
                rows.append([int(row["X"]), int(row["Y"]), int(row["W"]),
                             int(row["H"]), int(row["C"])])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 5)


def load_boxes_to_ltrbc(filepath: str) -> np.ndarray:
    """Read an annotation CSV into [N,5] float (l, t, r, b, class) with
    inclusive right/bottom edges (r = x + w - 1)."""
    out = load_boxes_to_xywhc(filepath)
    out[:, 2] = out[:, 0] + out[:, 2] - 1
    out[:, 3] = out[:, 1] + out[:, 3] - 1
    return out


def write_boxes_from_xywhc(boxes: np.ndarray, csv_filename: str) -> None:
    """Write [N,5] (x, y, w, h, class) rows under an 'X,Y,W,H,C' header."""
    with open(csv_filename, "w") as fh:
        fh.write("X,Y,W,H,C\n")
        for row in np.asarray(boxes):
            fh.write("{:d},{:d},{:d},{:d},{:d}\n".format(
                int(row[0]), int(row[1]), int(row[2]), int(row[3]), int(row[4])))


def write_boxes_from_ltrbc(boxes: np.ndarray, csv_filename: str) -> None:
    """Write [N,5] (l, t, r, b, class) rows as X,Y,W,H,C with w=r-l+1."""
    with open(csv_filename, "w") as fh:
        fh.write("X,Y,W,H,C\n")
        for row in np.asarray(boxes):
            x, y = int(row[0]), int(row[1])
            fh.write("{:d},{:d},{:d},{:d},{:d}\n".format(
                x, y, int(row[2]) - x + 1, int(row[3]) - y + 1, int(row[4])))


def write_boxes_from_ltrbpc(boxes: np.ndarray, csv_filename: str) -> None:
    """Write [N,6] (l, t, r, b, score, class) rows as X,Y,W,H,P,C."""
    with open(csv_filename, "w") as fh:
        fh.write("X,Y,W,H,P,C\n")
        for row in np.asarray(boxes):
            x, y = int(row[0]), int(row[1])
            fh.write("{:d},{:d},{:d},{:d},{:f},{:d}\n".format(
                x, y, int(row[2]) - x + 1, int(row[3]) - y + 1,
                float(row[4]), int(row[5])))


def draw_boxes(img: np.ndarray, boxes: Optional[np.ndarray],
               thickness: int = 2) -> np.ndarray:
    """Rasterize zero-valued rectangle outlines for [N,>=4] xywh boxes
    (reference/bbox_utils.py:20-44)."""
    if boxes is None:
        return img
    for row in np.asarray(boxes):
        x0 = int(round(float(row[0])))
        y0 = int(round(float(row[1])))
        x1 = int(round(x0 + float(row[2]) + 1))
        y1 = int(round(y0 + float(row[3]) + 1))
        img[y0:y0 + thickness, x0:x1] = 0
        img[y1 - thickness:y1, x0:x1] = 0
        img[y0:y1, x0:x0 + thickness] = 0
        img[y0:y1, x1 - thickness:x1] = 0
    return img
