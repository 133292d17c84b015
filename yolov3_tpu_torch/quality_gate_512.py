"""The closed-loop detection-quality gate at the shipping shape (512 px,
the full-depth model, bf16) on one card: train on planted rectangles,
export, serve the training images through the real inference function in
bf16 and with `--int8`, score the scored CSVs with `evaluate_folders`;
mAP@0.5 must reach 0.9 on both (a copy of `scripts/quality_gate_512.py`).

    python -m yolov3_tpu_torch.quality_gate_512 [--steps 8000] \
        [--out DIR] [--device cuda]

The images are written as `.npy` arrays (`data/imaging.py` reads them
with numpy, no codec). `plant_dataset`, `overfit` and `serve_and_score`
are the loop's three parts; the 64 px gates (`chip_smoke.py` phase 12,
tests/test_torch_quality.py) run the same parts at their own sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def lr_schedule(lr: float, warmup: int, decay_start: int,
                decay_end: int) -> Callable[[int], float]:
    """The gate's learning rate at step i: lr / 10 for `warmup` steps, a
    linear ramp to lr over the next `warmup`, lr until `decay_start`, a
    linear decay to lr / 20 at `decay_end`, then lr / 20
    (scripts/quality_gate_512.py:26-40, 108-120)."""
    assert 2 * warmup <= decay_start < decay_end, (warmup, decay_start,
                                                   decay_end)

    def at(i: int) -> float:
        if i < warmup:
            frac = 0.1
        elif i < 2 * warmup:
            frac = 0.1 + 0.9 * (i - warmup) / warmup
        elif i < decay_start:
            frac = 1.0
        elif i < decay_end:
            frac = 1.0 - 0.95 * (i - decay_start) / (decay_end - decay_start)
        else:
            frac = 0.05
        return lr * frac
    return at


def plant_dataset(out: str, n: int, size: int, box: int,
                  rng: np.random.RandomState
                  ) -> Tuple[str, str, List[np.ndarray], List[np.ndarray]]:
    """`n` size x size x 3 uint8 images of dark noise, each with one bright
    box x box square at a random place, as `<out>/images/im<i>.npy`, and
    their boxes as `<out>/gt/im<i>.csv` (tests/test_quality_e2e.py:44-62).
    Returns (image folder, ground-truth folder, images, boxes)."""
    from yolov3_tpu_torch.data.imaging import imwrite
    from yolov3_tpu_torch.ops import boxes as bbox
    img_dir, gt_dir = os.path.join(out, "images"), os.path.join(out, "gt")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    images, gts = [], []
    for i in range(n):
        img = (rng.rand(size, size, 3) * 40).astype(np.float32)
        x = rng.randint(0, size - box)
        y = rng.randint(0, size - box)
        img[y:y + box, x:x + box] += 180 + rng.rand() * 40
        img = np.clip(img, 0, 255).astype(np.uint8)
        rows = np.array([[x, y, box, box, 0]], np.int32)
        imwrite(img, os.path.join(img_dir, f"im{i}.npy"))
        bbox.write_boxes_from_xywhc(rows, os.path.join(gt_dir, f"im{i}.csv"))
        images.append(img)
        gts.append(rows)
    return img_dir, gt_dir, images, gts


def overfit(cfg, images: List[np.ndarray], gts: List[np.ndarray],
            steps: int, lr_at: Callable[[int], float], device: str,
            recalibrate_every: Optional[int] = None, log_every: int = 0):
    """Train `cfg` from `init_train_params(cfg, 0)` on the one batch of
    all `images` for `steps` steps at lr_at(step); under static QAT the
    scales are recalibrated on the batch every `recalibrate_every` steps
    from step 0. Returns (state, the last step's loss, {step: loss} every
    `log_every` steps); raises on a non-finite loss."""
    import torch

    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.data.imaging import zscore_normalize
    from yolov3_tpu_torch.models.quantized import qat_recalibrator
    from yolov3_tpu_torch.parallel.train_step import (create_train_state,
                                                      make_train_step)
    n = len(images)
    tcfg = TrainConfig(batch_size=n)
    state = create_train_state(cfg, tcfg, 0, device)
    step = make_train_step(cfg, tcfg, n)
    labels = [encode_boxes(g.astype(np.float32), cfg.img_size, cfg.anchors,
                           cfg.number_classes) for g in gts]
    batch = [np.stack([zscore_normalize(im) for im in images])] + [
        np.stack([lab[i] for lab in labels]) for i in range(3)]
    batch = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
             for a in batch]
    recalibrate = (qat_recalibrator(cfg, device)
                   if cfg.int8_train and cfg.int8_train_static else None)
    logged: Dict[int, float] = {}
    metrics = None
    t0 = time.perf_counter()
    for i in range(steps):
        if recalibrate is not None and i % recalibrate_every == 0:
            recalibrate(state.model, batch[0])
        state, metrics = step(state, batch, lr_at(i))
        if log_every and i % log_every == 0:
            loss = float(metrics["loss"])
            logged[i] = loss
            print(f"step {i:5d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {i}")
    final = float(metrics["loss"])
    if not np.isfinite(final):
        raise RuntimeError(f"non-finite final loss {final}")
    return state, final, logged


def serve_and_score(state, cfg, img_dir: str, gt_dir: str, out: str,
                    min_box_size: int, batch_size: int, device: str,
                    save_scores: bool = False) -> Dict[str, float]:
    """Export the state's model, run `inference.inference` on the image
    folder in bf16 and with `--int8` (the device's default kernel set),
    and score each CSV folder: {"bf16": mAP@0.5, "int8": mAP@0.5}."""
    from yolov3_tpu_torch import inference
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    from yolov3_tpu_torch.utils.evaluation import evaluate_folders
    params, stats = ckpt.params_to_jax(state.model.state_dict())
    export = ckpt.export_model(os.path.join(out, "model"), params, stats,
                               cfg)
    maps = {}
    for tag, int8 in (("bf16", False), ("int8", True)):
        pred = os.path.join(out, f"pred_{tag}")
        inference.inference(img_dir, "npy", export, pred,
                            min_box_size=min_box_size, batch_size=batch_size,
                            use_int8=int8, save_scores=save_scores,
                            device=device)
        maps[tag] = evaluate_folders(pred, gt_dir, iou_threshold=0.5)["mAP"]
    return maps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--images", type=int, default=8)
    # the full-depth bf16 model diverges at the 64 px gate's 5e-3: a
    # linear warm-up from lr / 10 into a cooler peak, then a decay
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--decay_start", type=int, default=2500)
    p.add_argument("--decay_end", type=int, default=6000)
    p.add_argument("--out", default="qg512_out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from yolov3_tpu_torch.config import ModelConfig

    size, box = 512, 96
    lr_at = lr_schedule(args.lr, args.warmup, args.decay_start,
                        args.decay_end)
    if os.path.exists(args.out):
        shutil.rmtree(args.out)
    img_dir, gt_dir, images, gts = plant_dataset(
        args.out, args.images, size, box, np.random.RandomState(42))
    cfg = ModelConfig(img_size=(size, size, 3), number_classes=1,
                      anchors=((96, 96), (48, 48)),
                      compute_dtype="bfloat16")
    t0 = time.perf_counter()
    state, final, logged = overfit(cfg, images, gts, args.steps, lr_at,
                                   args.device, log_every=50)
    train_s = time.perf_counter() - t0
    print(f"final loss {final:.4f} after {args.steps} steps "
          f"({train_s:.0f}s)", flush=True)
    maps = serve_and_score(state, cfg, img_dir, gt_dir, args.out,
                           min_box_size=32, batch_size=args.images,
                           device=args.device, save_scores=True)
    results = {"steps": args.steps, "final_loss": final, "train_s": train_s,
               "mAP_bf16": maps["bf16"], "mAP_int8": maps["int8"],
               "loss_at": logged}
    print(json.dumps(results), flush=True)
    ok = maps["bf16"] >= 0.9 and maps["int8"] >= 0.9
    print("GATE " + ("PASSED" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
