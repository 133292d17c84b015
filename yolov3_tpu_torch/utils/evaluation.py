"""Detection evaluation: per-class average precision and mAP@IoU (port of
`yolov3_tpu/utils/evaluation.py`).

    python -m yolov3_tpu_torch.utils.evaluation --pred_folder P \
        --gt_folder G [--iou_threshold 0.5]

VOC-style AP: greedy matching of score-sorted detections to ground truth
at an IoU threshold, the all-points interpolated precision/recall
integral. Consumes the CSVs the CLIs write: predictions as
'X,Y,W,H,P,C' (`write_boxes_from_ltrbpc`) or 'X,Y,W,H,C', ground truth as
'X,Y,W,H,C'. numpy only.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Tuple

import numpy as np

from yolov3_tpu_torch.ops import boxes as bbox


def _xywh_to_ltrb(rows: np.ndarray) -> np.ndarray:
    out = rows.astype(np.float64).copy()
    out[:, 2] = out[:, 0] + out[:, 2] - 1
    out[:, 3] = out[:, 1] + out[:, 3] - 1
    return out


def load_predictions(filepath: str
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a prediction CSV -> (boxes ltrb [N,4], scores [N], classes [N]).

    Accepts both the scored 'X,Y,W,H,P,C' layout and the unscored
    'X,Y,W,H,C' layout (score defaults to 1.0).
    """
    boxes, scores, classes = [], [], []
    if os.path.exists(filepath):
        with open(filepath, newline="") as fh:
            for row in csv.DictReader(fh, skipinitialspace=True):
                boxes.append([float(row["X"]), float(row["Y"]),
                              float(row["W"]), float(row["H"])])
                scores.append(float(row.get("P", 1.0)))
                classes.append(int(row["C"]))
    if not boxes:
        return (np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), np.int32))
    out = _xywh_to_ltrb(np.asarray(boxes))
    return out, np.asarray(scores), np.asarray(classes, np.int32)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-points interpolated AP (area under the PR envelope)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    steps = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


def evaluate_detections(
        predictions: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
        ground_truth: Dict[str, np.ndarray],
        iou_threshold: float = 0.5) -> Dict:
    """Compute per-class AP and mAP over a dataset.

    predictions: image id -> (ltrb boxes [N,4], scores [N], classes [N])
    ground_truth: image id -> [M,5] rows of (l, t, r, b, class)
    """
    class_ids: set = set()
    for _, (_, _, cls) in predictions.items():
        class_ids.update(int(c) for c in cls)
    for gt in ground_truth.values():
        class_ids.update(int(c) for c in gt[:, 4])

    per_class_ap: Dict[int, float] = {}
    for c in sorted(class_ids):
        found: List[Tuple[float, str, np.ndarray]] = []
        n_gt = 0
        gt_by_img = {}
        for img, gt in ground_truth.items():
            sel = gt[gt[:, 4] == c]
            gt_by_img[img] = sel
            n_gt += sel.shape[0]
        for img, (boxes, scores, cls) in predictions.items():
            for i in np.where(cls == c)[0]:
                found.append((float(scores[i]), img, boxes[i]))
        if not found:
            per_class_ap[c] = 0.0 if n_gt else float("nan")
            continue

        found.sort(key=lambda r: -r[0])
        matched = {img: np.zeros(len(gt_by_img.get(img, [])), bool)
                   for img in ground_truth}
        tp = np.zeros(len(found))
        fp = np.zeros(len(found))
        for k, (_, img, box) in enumerate(found):
            gt = gt_by_img.get(img, np.zeros((0, 5)))
            if gt.shape[0] == 0:
                fp[k] = 1
                continue
            ious = bbox.compute_iou(box, gt[:, :4])
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold and not matched[img][best]:
                tp[k] = 1
                matched[img][best] = True
            else:
                fp[k] = 1

        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recalls = tp_cum / max(n_gt, 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        per_class_ap[c] = average_precision(recalls, precisions)

    valid = [v for v in per_class_ap.values() if not np.isnan(v)]
    return {
        "per_class_ap": per_class_ap,
        "mAP": float(np.mean(valid)) if valid else 0.0,
        "iou_threshold": iou_threshold,
    }


def evaluate_folders(pred_folder: str, gt_folder: str,
                     iou_threshold: float = 0.5) -> Dict:
    """Evaluate a folder of prediction CSVs against a folder of GT CSVs,
    paired by basename (GT files with no prediction count as all-missed)."""
    gt_files = [f for f in os.listdir(gt_folder) if f.endswith(".csv")]
    predictions, ground_truth = {}, {}
    for fn in gt_files:
        img_id = os.path.splitext(fn)[0]
        ground_truth[img_id] = _xywh_to_ltrb(
            bbox.load_boxes_to_xywhc(os.path.join(gt_folder, fn)))
        predictions[img_id] = load_predictions(os.path.join(pred_folder, fn))
    return evaluate_detections(predictions, ground_truth, iou_threshold)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="evaluate", description="Compute mAP@IoU of detection CSVs "
                                     "against ground-truth CSVs")
    parser.add_argument("--pred_folder", type=str, required=True)
    parser.add_argument("--gt_folder", type=str, required=True)
    parser.add_argument("--iou_threshold", type=float, default=0.5)
    args = parser.parse_args(argv)
    result = evaluate_folders(args.pred_folder, args.gt_folder,
                              args.iou_threshold)
    for c, ap in sorted(result["per_class_ap"].items()):
        print(f"class {c}: AP@{args.iou_threshold} = {ap:.4f}")
    print(f"mAP@{args.iou_threshold} = {result['mAP']:.4f}")


if __name__ == "__main__":
    main()
