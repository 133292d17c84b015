"""Tiled inference CLI for images larger than one network pass.

Port of `yolov3_tpu/inference_tiled.py`: 96-px ghost zones with reflect
padding (`utils/tiling.py`), per-tile z-score on the device, the detector,
per-tile NMS (the device NMS, or with `--host_nms` the small-box filter
and the numpy per-class NMS), centre-based ghost culling, the shift to
global coordinates and the stitch with no cross-tile NMS, written as an
'X,Y,W,H,P,C' CSV per image. Tiles go through the detector in batches
of `--batch-size` (default 8); the last batch of an image holds the
tiles that are left.

`--int8` serves the int8 post-training-quantized detector
(`models/quantized.py::make_quantized_detector_fn`, on the device's
default kernel set), calibrated on the first image's first 8 tiles.
Everything runs on `device`, "cuda" unless the caller asks for "cpu"
(the tests do). `--num-devices N` > 1 shards each tile batch over the
first N cards, as `inference.py` does, the int8 detector too (its scales
calibrate once, on the first card); `inference_image_folder` also takes
an explicit device list.

    python -m yolov3_tpu_torch.inference_tiled --saved-model-filepath M \\
        --image-folder IN --output-folder OUT --image-format tif [--int8]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from yolov3_tpu_torch.config import EDGE_EFFECT_RANGE, InferenceConfig
from yolov3_tpu_torch.data.device_pipeline import zscore_images
from yolov3_tpu_torch.data.imaging import ensure_hwc, imread
from yolov3_tpu_torch.inference import make_detector_fn, resolve_devices
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.ops.nms import batched_nms_device, nms_to_host
from yolov3_tpu_torch.utils.tiling import (convert_image_to_tiles,
                                           ghost_zone_keep_mask,
                                           stitch_tile_detections)


def zscore_tiles(tiles, device) -> torch.Tensor:
    """HWC tiles (raw pixels) as one per-tile z-scored batch on `device`."""
    return zscore_images(torch.from_numpy(np.stack(tiles)).to(device))


def inference_image_tiled(detect_fn, num_classes: int, img: np.ndarray,
                          tile_size: Sequence[int], min_roi_size: int,
                          batch_size: int = 8,
                          use_host_nms: bool = False,
                          icfg: Optional[InferenceConfig] = None,
                          edge_range: int = EDGE_EFFECT_RANGE,
                          device: str = "cuda") -> np.ndarray:
    """Detect over one large HWC image; returns [M, 6] ltrb + score +
    class in global coordinates."""
    icfg = icfg or InferenceConfig(min_box_size=min_roi_size)
    img_size = img.shape
    tiles, tile_xs, tile_ys = convert_image_to_tiles(img, tile_size,
                                                     edge_range)
    boxes_list, scores_list, labels_list = [], [], []
    for start in range(0, len(tiles), batch_size):
        chunk = tiles[start:start + batch_size]
        dets = detect_fn(zscore_tiles(chunk, device))
        if use_host_nms:
            dets = dets.float().cpu().numpy()
        else:
            nms_out = batched_nms_device(
                dets, num_classes, iou_threshold=icfg.iou_threshold,
                score_threshold=icfg.score_threshold,
                max_boxes=icfg.max_boxes_per_class,
                min_box_size=float(min_roi_size))
            nms_out = tuple(o.cpu().numpy() for o in nms_out)
        for k in range(len(chunk)):
            idx = start + k
            if use_host_nms:
                det = bbox.filter_small_boxes(dets[k], min_roi_size)
                tile_boxes, tile_scores, tile_labels = bbox.per_class_nms(
                    det[:, 0:4], det[:, 4:5], det[:, 5:],
                    iou_threshold=icfg.iou_threshold,
                    score_threshold=icfg.score_threshold)
            else:
                tile_boxes, tile_scores, tile_labels = nms_to_host(
                    nms_out[0][k], nms_out[1][k], nms_out[2][k])
            if tile_boxes is None:
                continue
            keep = ghost_zone_keep_mask(tile_boxes, tile_xs[idx],
                                        tile_ys[idx], tile_size, img_size,
                                        edge_range)
            if not keep.any():
                continue
            tile_boxes = tile_boxes[keep].copy()
            tile_boxes[:, 0::2] += tile_xs[idx]
            tile_boxes[:, 1::2] += tile_ys[idx]
            boxes_list.append(tile_boxes)
            scores_list.append(tile_scores[keep])
            labels_list.append(tile_labels[keep])
    predictions = stitch_tile_detections(boxes_list, scores_list,
                                         labels_list, img_size)
    print(f"Found: {predictions.shape[0]} rois")
    return predictions


def inference_image_folder(image_folder: str, image_format: str,
                           saved_model_filepath: str, output_folder: str,
                           tile_size: Sequence[int], min_roi_size: int,
                           batch_size: int = 8,
                           use_host_nms: bool = False,
                           edge_range: int = EDGE_EFFECT_RANGE,
                           num_devices: int = 1,
                           icfg: Optional[InferenceConfig] = None,
                           use_int8: bool = False,
                           calib_percentile=None,
                           device: str = "cuda",
                           devices: Optional[Sequence[str]] = None) -> None:
    devices = resolve_devices(num_devices, device, devices)
    device = devices[0]
    if not os.path.exists(saved_model_filepath):
        raise RuntimeError("Missing saved model filepath")
    image_format = image_format.lstrip(".")
    files = sorted(fn for fn in os.listdir(image_folder)
                   if fn.endswith(f".{image_format}"))
    paths = [os.path.join(image_folder, fn) for fn in files]

    if use_int8 and paths:
        # the activation scales calibrate on tiles of the first image
        from yolov3_tpu_torch.models.quantized import \
            make_quantized_detector_fn
        tiles0, _, _ = convert_image_to_tiles(ensure_hwc(imread(paths[0])),
                                              tile_size, edge_range)
        detect, cfg = make_quantized_detector_fn(
            saved_model_filepath, zscore_tiles(tiles0[:8], device),
            calib_percentile=calib_percentile, device=device,
            devices=devices)
    else:
        detect, cfg = make_detector_fn(saved_model_filepath,
                                       devices=devices)
    expected_hw = (cfg.img_size[0], cfg.img_size[1])
    if tuple(tile_size) != expected_hw:
        raise ValueError(
            f"tile size {tuple(tile_size)} must match the exported model's "
            f"input {expected_hw}")

    os.makedirs(output_folder, exist_ok=True)
    print("Starting inference of file list")
    for i, fp in enumerate(paths):
        file_name = os.path.basename(fp)
        print(f"{i}/{len(paths)} : {file_name}")
        predictions = inference_image_tiled(
            detect, cfg.number_classes, ensure_hwc(imread(fp)), tile_size,
            min_roi_size, batch_size=batch_size, use_host_nms=use_host_nms,
            edge_range=edge_range, icfg=icfg, device=device)
        bbox.write_boxes_from_ltrbpc(predictions, os.path.join(
            output_folder, file_name.replace(image_format, "csv")))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="inference_tiled",
        description="Detect objects in large images by ghost-zone tiling")
    parser.add_argument("--saved-model-filepath", type=str, required=True)
    parser.add_argument("--output-folder", type=str, required=True)
    parser.add_argument("--image-folder", type=str, required=True)
    parser.add_argument("--image-format", type=str, default="tif")
    parser.add_argument("--min-box-size", type=int, default=32)
    parser.add_argument("--tile-height", type=int, default=512)
    parser.add_argument("--tile-width", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="tiles per device batch")
    parser.add_argument("--edge-range", type=int, default=EDGE_EFFECT_RANGE,
                        help="ghost-zone radius in pixels (multiple of 32)")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="shard tile batches across the first N "
                             "devices")
    parser.add_argument("--max-boxes", type=int, default=512,
                        help="per-class candidate cap for the device NMS")
    parser.add_argument("--host_nms", action="store_true")
    parser.add_argument("--calib-percentile", type=float, default=None,
                        help="int8 calibration percentile (default absmax)")
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 post-training-quantized path "
                             "(activation scales calibrate on tiles of the "
                             "first image)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)

    print("Arguments:")
    for k, v in sorted(vars(args).items()):
        print(f"{k} = {v}")

    inference_image_folder(args.image_folder, args.image_format,
                           args.saved_model_filepath, args.output_folder,
                           (args.tile_height, args.tile_width),
                           args.min_box_size, batch_size=args.batch_size,
                           use_host_nms=args.host_nms,
                           edge_range=args.edge_range,
                           num_devices=args.num_devices,
                           icfg=InferenceConfig(
                               min_box_size=args.min_box_size,
                               max_boxes_per_class=args.max_boxes),
                           use_int8=args.int8,
                           calib_percentile=args.calib_percentile,
                           device=args.device)


if __name__ == "__main__":
    main()
