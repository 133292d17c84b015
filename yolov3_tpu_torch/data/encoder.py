"""YOLO dense label encoding: [N,5] boxes -> 3 label grids (copy of
`yolov3_tpu/data/encoder.py`).

Parity target: reference/imagereader.py:252-324 (`__format_boxes`).

Reference quirks preserved:
- corner->center shift uses floor(xy + (wh-1)/2) (reference/imagereader.py:288)
- best anchor chosen by IoU between the origin-centered GT box and each
  anchor (reference/imagereader.py:292-310)
- the GT is written into its best-anchor slot of ALL THREE scale grids
  (reference/imagereader.py:312-322), unlike canonical YOLOv3's per-scale
  anchor assignment
- later boxes overwrite earlier ones landing in the same (cell, anchor) slot
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from yolov3_tpu_torch.config import NETWORK_DOWNSAMPLE_FACTOR


def grid_shapes(image_size: Sequence[int], num_anchors: int,
                number_classes: int) -> List[Tuple[int, int, int, int]]:
    """Label grid shapes per scale for (H, W[, C]) images.

    Matches reference/imagereader.py:258-267 / :450-458.
    """
    h, w = int(image_size[0]), int(image_size[1])
    out = []
    for div in (NETWORK_DOWNSAMPLE_FACTOR, NETWORK_DOWNSAMPLE_FACTOR // 2,
                NETWORK_DOWNSAMPLE_FACTOR // 4):
        out.append((h // div, w // div, num_anchors, 5 + number_classes))
    return out


def encode_boxes(boxes: np.ndarray, image_size: Sequence[int],
                 anchors: Sequence[Tuple[float, float]],
                 number_classes: int) -> List[np.ndarray]:
    """Encode [N,5] (x, y, w, h, class) corner boxes into 3 dense grids.

    Returns [label_s32, label_s16, label_s8], each float32
    [gh, gw, A, 5+C] holding (center_x, center_y, w, h) in absolute pixels,
    an objectness flag, and a one-hot class vector at the best-anchor slot.
    """
    anchors_arr = np.asarray(anchors, dtype=np.float32)
    shapes = grid_shapes(image_size, len(anchors_arr), number_classes)
    labels = [np.zeros(s, dtype=np.float32) for s in shapes]

    if boxes is None or boxes.shape[0] == 0:
        return labels

    boxes = boxes.astype(np.float32).copy()
    wh = boxes[:, 2:4]
    # corner -> center, floored (reference/imagereader.py:288)
    boxes[:, 0:2] = np.floor(boxes[:, 0:2] + (wh - 1.0) / 2.0)

    # IoU of origin-centered GT vs. origin-centered anchors
    half_wh = wh[:, None, :] / 2.0                      # [N,1,2]
    half_anchor = anchors_arr[None, :, :] / 2.0          # [1,A,2]
    inter_wh = np.maximum(np.minimum(half_wh, half_anchor) * 2.0, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]          # [N,A]
    area_box = (wh[:, 0] * wh[:, 1])[:, None]
    area_anchor = (anchors_arr[:, 0] * anchors_arr[:, 1])[None, :]
    iou = inter / (area_box + area_anchor - inter)
    best_anchor = np.argmax(iou, axis=-1)

    img_h, img_w = float(image_size[0]), float(image_size[1])
    for t in range(boxes.shape[0]):
        n = int(best_anchor[t])
        c = int(boxes[t, 4])
        for label in labels:
            gh, gw = label.shape[0], label.shape[1]
            i = int(np.floor(boxes[t, 1] / img_h * gh))
            j = int(np.floor(boxes[t, 0] / img_w * gw))
            label[i, j, n, 0:4] = boxes[t, 0:4]
            label[i, j, n, 4] = 1.0
            label[i, j, n, 5 + c] = 1.0
    return labels


def decode_label_grid(label: np.ndarray, all_anchors: bool = True
                      ) -> np.ndarray:
    """Inverse of `encode_boxes` for one [gh, gw, A, 5+C] grid: the [M, 4]
    boxes (x, y, w, h with x, y the top-left corner) of its object cells.
    A debug helper after reference/imagereader.py:63-75, which inspects
    anchor slot 0 only (`all_anchors=False`); the corner is x - int(w/2),
    as the reference's inverse has it."""
    if label.ndim != 4:
        raise ValueError("expected [gh, gw, A, 5+C] grid")
    grid = label if all_anchors else label[:, :, 0:1, :]
    out = []
    for i, j, a in zip(*np.nonzero(grid[:, :, :, 4])):
        bb = grid[i, j, a, 0:4].copy()
        bb[0] = bb[0] - int(bb[2] / 2)
        bb[1] = bb[1] - int(bb[3] / 2)
        out.append(bb)
    if not out:
        return np.zeros((0, 4), dtype=np.float32)
    return np.vstack(out)


# Fixed per-image box capacity for static shapes on the device (the raw
# feed's padded boxes, which data/device_pipeline.py consumes).
MAX_BOXES = 64


def pad_boxes(box_arr: np.ndarray, max_boxes: int = MAX_BOXES
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: ragged [N,5] -> fixed ([M,5], valid [M]); overflow boxes
    beyond `max_boxes` are dropped."""
    n = min(box_arr.shape[0], max_boxes)
    out = np.zeros((max_boxes, 5), np.float32)
    val = np.zeros((max_boxes,), bool)
    out[:n] = box_arr[:n]
    val[:n] = True
    return out, val
