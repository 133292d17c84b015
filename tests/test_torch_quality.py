"""The port's closed-loop quality gate (tests/test_quality_e2e.py's twin):
overfit planted squares, export, serve the training images through the
port's inference function in bf16 and with `--int8`, and score the CSVs
with the port's `evaluate_folders`; mAP@0.5 must reach 0.9 on both.

The reference's recipe and sizes (64 px images, 1 block, 32 filters, one
fixed batch of 8, 1000 steps at lr 5e-3, f32), in the three training
modes: plain, QAT with dynamic scales, QAT with static scales refreshed
every 250 steps. On the CPU, so slow; the card runs it at 512 filters
(`chip_smoke.py` phase 12) and at the shipping shape
(`python -m yolov3_tpu_torch.quality_gate_512`).
"""

import numpy as np
import pytest

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.quality_gate_512 import (overfit, plant_dataset,
                                               serve_and_score)

SIZE, BOX, N_IMAGES, STEPS, LR = 64, 24, 8, 1000, 5e-3


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["bf16_train", "int8_ste_train",
                                  "int8_static_train"])
def test_overfit_toy_dataset_reaches_high_map(tmp_path, rng, mode):
    img_dir, gt_dir, images, gts = plant_dataset(str(tmp_path), N_IMAGES,
                                                 SIZE, BOX, rng)
    cfg = ModelConfig(img_size=(SIZE, SIZE, 3), number_classes=1,
                      anchors=((24, 24), (12, 12)), block_count=1,
                      filter_count=32, compute_dtype="float32",
                      int8_train=mode != "bf16_train",
                      int8_train_static=mode == "int8_static_train")
    state, final, _ = overfit(cfg, images, gts, STEPS, lambda i: LR, "cpu",
                              recalibrate_every=250)
    assert np.isfinite(final)
    assert final < 0.5, f"failed to overfit: final loss {final}"
    maps = serve_and_score(state, cfg, img_dir, gt_dir, str(tmp_path),
                           min_box_size=8, batch_size=N_IMAGES,
                           device="cpu")
    assert maps["bf16"] >= 0.9, maps
    assert maps["int8"] >= 0.9, maps
