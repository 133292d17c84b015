"""Whole-image inference CLI: exported model -> per-class NMS -> CSV boxes.

Port of `yolov3_tpu/inference.py`. Pipeline: image -> whole-image
z-score -> model -> clip corners to the image -> strict small-box filter
-> per-class NMS (sqrt score rule) -> corners to xywh + class id ->
'X,Y,W,H,C' CSV named after the image (or 'X,Y,W,H,P,C' with
--save-scores).

`--int8` serves the int8 post-training-quantized model
(`models/quantized.py`), calibrated on the first batch (absmax, or
`--calib-percentile`): through the fused serving function, the last
chunk padded to the batch size, or with `--host_nms` or `--num-devices`
> 1 through the int8 detector and the shared post-processing (the
reference's rule, inference.py:213-218). Everything runs on `device`,
"cuda" unless the caller asks for "cpu" (the tests do).

`--num-devices N` > 1 shards each batch over the first N cards (raises
when fewer exist; with `--device cpu`, the CPU N times): one model
replica per device, the batch padded to a multiple of N and split, the
detections gathered in order (`parallel/distributed.py::
shard_detector`, the reference's `shard_detector`). `make_detector_fn`
and `inference` also take an explicit device list, which may repeat a
device.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov3_tpu_torch.config import InferenceConfig
from yolov3_tpu_torch.data.device_pipeline import zscore_images
from yolov3_tpu_torch.data.imaging import ensure_hwc, imread
from yolov3_tpu_torch.models import quantized
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.ops.nms import batched_nms_device, nms_to_host
from yolov3_tpu_torch.parallel import distributed as D
from yolov3_tpu_torch.utils import checkpoint as ckpt
from yolov3_tpu_torch.utils import tracing


def resolve_devices(num_devices: int, device: str,
                    devices: Optional[Sequence[str]] = None) -> List[str]:
    """The serving device list: `devices` when given, else
    `--num-devices`' (`distributed.serving_devices`), else [device]."""
    if devices is not None:
        return [str(d) for d in devices]
    if num_devices > 1:
        return D.serving_devices(num_devices, device)
    return [device]


def make_detector_fn(saved_model_filepath: str, num_devices: int = 1,
                     device: str = "cuda",
                     devices: Optional[Sequence[str]] = None):
    """Load an exported model and return (detector_fn, config).

    detector_fn(images NHWC [B, H, W, C]) -> detections [B, num_boxes,
    4+1+C] float32 on `device`; over several devices (`num_devices` > 1,
    or an explicit `devices` list) the batch is sharded across replicas
    and the detections land on the first device.
    """
    devices = resolve_devices(num_devices, device, devices)
    params, batch_stats, cfg = ckpt.load_model(saved_model_filepath)
    models = {}
    for dev in devices:
        if dev not in models:
            models[dev] = ckpt.build_model(params, batch_stats, cfg, dev)

    def detector(dev):
        @torch.inference_mode()
        def detect(images) -> torch.Tensor:
            return models[dev](torch.as_tensor(images, device=dev))
        return detect

    if len(devices) == 1:
        return detector(devices[0]), cfg
    return D.shard_detector([detector(d) for d in devices], devices), cfg


def make_serving_fn(saved_model_filepath: str,
                    icfg: Optional[InferenceConfig] = None,
                    min_box_size: Optional[int] = None,
                    device: str = "cuda"):
    """The full serving path on the device: forward + decode + corner clip
    + small-box filter + per-class NMS.

    Returns (serve, cfg) where serve(images [B,H,W,C] float32) ->
    (boxes [B,C,K,4] ltrb, scores [B,C,K], keep [B,C,K] bool).
    """
    icfg = icfg or InferenceConfig()
    if min_box_size is None:
        min_box_size = icfg.min_box_size
    params, batch_stats, cfg = ckpt.load_model(saved_model_filepath)
    model = ckpt.build_model(params, batch_stats, cfg, device)

    @torch.inference_mode()
    def serve(images):
        with tracing.span("yolo.serve"):
            images = torch.as_tensor(images, device=device)
            return serving_tail(model(images), images, cfg.number_classes,
                                icfg, min_box_size)

    return serve, cfg


def serving_tail(det: torch.Tensor, images: torch.Tensor, num_classes: int,
                 icfg: InferenceConfig, min_box_size: float):
    """The serving functions' tail: decoded detections [B, N, 4+1+C] ->
    corners clipped to the served images' bounds (not cfg.img_size: the
    network is fully convolutional) -> strict small-box filter ->
    per-class NMS: (boxes [B,C,K,4] ltrb, scores [B,C,K], keep [B,C,K]).

    While recording (`utils/tracing.py`), counts `nms.candidates`, the
    candidates at or above the score threshold, and `nms.kept`; their
    kernels run after the `yolo.nms` span."""
    img_h, img_w = images.shape[1], images.shape[2]
    with tracing.span("yolo.nms"):
        clipped = torch.cat([
            det[..., 0:1].clamp(0, img_w), det[..., 1:2].clamp(0, img_h),
            det[..., 2:3].clamp(0, img_w), det[..., 3:4].clamp(0, img_h),
            det[..., 4:]], dim=-1)
        out = batched_nms_device(clipped, num_classes,
                                 iou_threshold=icfg.iou_threshold,
                                 score_threshold=icfg.score_threshold,
                                 max_boxes=icfg.max_boxes_per_class,
                                 min_box_size=float(min_box_size))
    if tracing.is_on():
        tracing.count("nms.candidates", out[1] >= icfg.score_threshold)
        tracing.count("nms.kept", out[2])
    return out


def detections_to_csv_rows(det: np.ndarray, img_hw, min_box_size: int,
                           icfg: InferenceConfig, use_host_nms: bool,
                           num_classes: int, return_scores: bool = False,
                           device: str = "cuda"):
    """Post-process one image's raw detections to [M, 5] xywhc int rows
    (and the [M] NMS scores with `return_scores`)."""
    det = np.array(det, dtype=np.float32)  # writable host copy
    det[:, 0] = np.clip(det[:, 0], 0, img_hw[1])
    det[:, 1] = np.clip(det[:, 1], 0, img_hw[0])
    det[:, 2] = np.clip(det[:, 2], 0, img_hw[1])
    det[:, 3] = np.clip(det[:, 3], 0, img_hw[0])

    det = bbox.filter_small_boxes(det, min_box_size)
    if use_host_nms:
        boxes, scores, labels = bbox.per_class_nms(
            det[:, 0:4], det[:, 4:5], det[:, 5:],
            iou_threshold=icfg.iou_threshold,
            score_threshold=icfg.score_threshold)
    else:
        out = batched_nms_device(torch.from_numpy(det[None]).to(device),
                                 num_classes,
                                 iou_threshold=icfg.iou_threshold,
                                 score_threshold=icfg.score_threshold,
                                 max_boxes=icfg.max_boxes_per_class)
        boxes, scores, labels = nms_to_host(out[0][0], out[1][0], out[2][0])
    rows, scores = _csv_rows(boxes, scores, labels)
    return (rows, scores) if return_scores else rows


def _csv_rows(boxes, scores, labels) -> Tuple[np.ndarray, np.ndarray]:
    """NMS survivors (ltrb boxes, scores, labels; None for none) -> the
    [M, 5] xywhc int rows and the [M] scores."""
    if boxes is None:
        return np.zeros((0, 5), np.int32), np.zeros((0,), np.float32)
    boxes = boxes.copy()
    boxes[:, 2] = boxes[:, 2] - boxes[:, 0]
    boxes[:, 3] = boxes[:, 3] - boxes[:, 1]
    rows = np.concatenate([boxes, labels.reshape(-1, 1)],
                          axis=-1).astype(np.int32)
    return rows, np.asarray(scores, np.float32).reshape(-1)


def detect_images(images: Sequence[np.ndarray], detect, num_classes: int,
                  icfg: InferenceConfig, min_box_size: int,
                  use_host_nms: bool = False, device: str = "cuda"
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One CLI batch: HWC images (raw pixels, one size) -> per image the
    [M, 5] xywhc rows and the [M] scores. The z-score runs on `device`."""
    batch = zscore_images(torch.from_numpy(np.stack(images)).to(device))
    dets = detect(batch).cpu().numpy()
    pairs = [detections_to_csv_rows(det, img.shape[:2], min_box_size, icfg,
                                    use_host_nms, num_classes,
                                    return_scores=True, device=device)
             for det, img in zip(dets, images)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def serve_batch(serve, batch: torch.Tensor, batch_size: int
                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One --int8 CLI batch through a fused serving function: the z-scored
    batch, zero-padded to `batch_size` so every call has one shape -> per
    image of the batch the [M, 5] xywhc rows and the [M] scores."""
    count = batch.shape[0]
    if count < batch_size:
        batch = torch.cat([batch, batch.new_zeros(
            (batch_size - count, *batch.shape[1:]))])
    boxes, scores, keep = serve(batch)
    pairs = [_csv_rows(*nms_to_host(boxes[i], scores[i], keep[i]))
             for i in range(count)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def write_detections_csv(rows: np.ndarray, scores: np.ndarray, out_csv: str,
                         save_scores: bool) -> None:
    """Write one image's rows as X,Y,W,H,C, or as X,Y,W,H,P,C with
    `save_scores` (write_boxes_from_ltrbpc takes inclusive ltrb corners)."""
    if save_scores:
        ltrbpc = np.concatenate([
            rows[:, 0:1], rows[:, 1:2],
            rows[:, 0:1] + rows[:, 2:3] - 1,
            rows[:, 1:2] + rows[:, 3:4] - 1,
            scores.reshape(-1, 1), rows[:, 4:5]], axis=-1)
        bbox.write_boxes_from_ltrbpc(ltrbpc, out_csv)
    else:
        bbox.write_boxes_from_xywhc(rows, out_csv)


def save_overlay(img: np.ndarray, rows: np.ndarray, out_path: str) -> None:
    """Write a PNG with detection rectangles burned in."""
    from yolov3_tpu_torch.data.imaging import imwrite
    vis = img - img.min()
    rng = vis.max()
    if rng > 0:
        vis = vis / rng
    vis = np.ascontiguousarray((vis * 255).astype(np.uint8))
    imwrite(bbox.draw_boxes(vis, rows), out_path)


def inference(image_folder: str, image_format: str,
              saved_model_filepath: str, output_folder: str,
              min_box_size: int, batch_size: int = 1,
              use_host_nms: bool = False,
              num_devices: int = 1,
              overlay_folder: Optional[str] = None,
              icfg: Optional[InferenceConfig] = None,
              use_int8: bool = False,
              calib_percentile=None,
              save_scores: bool = False,
              device: str = "cuda",
              devices: Optional[Sequence[str]] = None) -> None:
    devices = resolve_devices(num_devices, device, devices)
    device = devices[0]
    os.makedirs(output_folder, exist_ok=True)
    icfg = icfg or InferenceConfig(min_box_size=min_box_size)
    image_format = image_format.lstrip(".")

    files = sorted(fn for fn in os.listdir(image_folder)
                   if fn.endswith(f".{image_format}"))
    paths = [os.path.join(image_folder, fn) for fn in files]
    # the int8 variants calibrate on the first batch, so they build
    # lazily; the fused int8 serving function runs on one device only
    serve = detect = None
    int8_fused = use_int8 and not use_host_nms and len(devices) == 1
    if not use_int8:
        detect, cfg = make_detector_fn(saved_model_filepath,
                                       devices=devices)

    print("Starting inference of file list")
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        images = [ensure_hwc(imread(fp)) for fp in chunk]
        if int8_fused:
            batch = zscore_images(torch.from_numpy(np.stack(images)).to(
                device))
            if serve is None:
                serve, cfg, _ = quantized.make_quantized_serving_fn(
                    saved_model_filepath, batch, icfg=icfg,
                    min_box_size=min_box_size,
                    calib_percentile=calib_percentile, device=device)
            rows_per_image, scores_per_image = serve_batch(serve, batch,
                                                           batch_size)
        else:
            if detect is None:  # int8 with --host_nms or several devices
                detect, cfg = quantized.make_quantized_detector_fn(
                    saved_model_filepath, zscore_images(torch.from_numpy(
                        np.stack(images)).to(device)),
                    calib_percentile=calib_percentile, device=device,
                    devices=devices)
            rows_per_image, scores_per_image = detect_images(
                images, detect, cfg.number_classes, icfg, min_box_size,
                use_host_nms, device)
        for fp, rows, scores, img in zip(chunk, rows_per_image,
                                         scores_per_image, images):
            file_name = os.path.basename(fp)
            print(f"{start}/{len(paths)} : {file_name}")
            print(f"Found: {rows.shape[0]} rois")
            write_detections_csv(rows, scores, os.path.join(
                output_folder, file_name.replace(image_format, "csv")),
                save_scores)
            if overlay_folder:
                os.makedirs(overlay_folder, exist_ok=True)
                save_overlay(img, rows, os.path.join(
                    overlay_folder, file_name.replace(image_format, "png")))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="inference",
        description="Detect objects in a folder of images with a trained model")
    parser.add_argument("--saved-model-filepath", type=str, required=True,
                        help="Filepath to the exported model to use")
    parser.add_argument("--output-folder", type=str, required=True)
    parser.add_argument("--image-folder", type=str, required=True,
                        help="folder containing images to inference (Required)")
    parser.add_argument("--image-format", type=str, default="tif",
                        help="format (extension) of the input images. "
                             "E.g {tif, jpg, png}")
    parser.add_argument("--min-box-size", type=int, default=32,
                        help="Smallest detection to consider. Default (32, 32).")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="images per device batch")
    parser.add_argument("--max-boxes", type=int, default=512,
                        help="per-class candidate cap for the device NMS")
    parser.add_argument("--save-overlays", type=str, default=None,
                        help="also write detection-overlay PNGs to this folder")
    parser.add_argument("--save-scores", action="store_true",
                        help="write the scored X,Y,W,H,P,C CSV layout "
                             "instead of the reference's unscored X,Y,W,H,C")
    parser.add_argument("--host_nms", action="store_true",
                        help="run NMS on the host (numpy) instead of on device")
    parser.add_argument("--calib-percentile", type=float, default=None,
                        help="int8 activation-scale calibration clips each "
                             "tensor's range at this percentile of "
                             "|activations| (default: absmax)")
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 post-training-quantized path "
                             "(calibrated on the first batch)")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="shard image batches across the first N "
                             "devices")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)

    print("Arguments:")
    for k, v in sorted(vars(args).items()):
        print(f"{k} = {v}")

    inference(args.image_folder, args.image_format,
              args.saved_model_filepath, args.output_folder,
              args.min_box_size, batch_size=args.batch_size,
              use_host_nms=args.host_nms, num_devices=args.num_devices,
              overlay_folder=args.save_overlays,
              icfg=InferenceConfig(min_box_size=args.min_box_size,
                                   max_boxes_per_class=args.max_boxes),
              use_int8=args.int8, calib_percentile=args.calib_percentile,
              save_scores=args.save_scores, device=args.device)


if __name__ == "__main__":
    main()
