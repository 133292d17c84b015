#!/usr/bin/env python3
"""Drive the PyTorch port (`yolov3_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, in order; any failure exits non-zero:
  1. Print the card's name and power limit; build the CUDA kernels from
     `yolov3_tpu_torch/csrc/` with nvcc, all eight libraries at once (the
     region library holds the region and the tail entry points).
  2. Reference check at 64 px, full width, f32: the port on the card
     (plain path, and 1x1 blocks through the kernel) against the port's
     plain path on the CPU.
  3. Full-width bf16 serving (512 px, batch 8, 1024 filters, 8 blocks,
     `use_pallas_pointwise`), weights from `init_params` (a seed) through
     the exported artifact and `params_from_jax`. The launch counters are
     set to 0 just before one `make_serving_fn` call and read just after:
     the 1x1 kernel must launch 34 times and the NMS kernel once. Then
     images/s over repeated calls, and device time by kernel over three
     calls under torch.profiler.
  4. Each bf16-path kernel against its plain version on the inputs the
     serving call handed it (recorded on a warm-up call), plus the NMS
     kernels at the batch-64 shapes (C = 128, K = 512), saturated and
     sparse: the box kernel's keep masks bit-equal to its plain version
     and to its first design (the chain twin `suppress_boxes_chain`),
     both timed in turns (chain, kernel, kernel, chain) at each shape;
     the IoU-slab kernel (`greedy_suppress`, called once between the
     counters' reset and read on the slab of `pairwise_iou`) bit-equal to
     its plain version, its first design (`greedy_suppress_chain`) and
     the box kernel, timed in turns beside the chain; the 1x1 block
     within rtol = atol = 2e-2 in bf16 of its plain version and of its
     WMMA twin
     (`pointwise_conv_block_wmma`), both timed in turns per launch shape.
     Each kernel's time beside each call's bound.
  5. int8 reference check at 64 px, full width, bf16, both sides under
     the card's default kernel set: the port's int8 model on the card
     (kernels) and on the CPU (plain versions) with one scale dict. Every
     kernel launch against its plain version on the same inputs: s8 codes
     within 1, float outputs within a bf16 ulp, and the int8 1x1, 3x3 and
     stride-2 (the wgmma core) exactly: 0 codes differ, floats bit-equal,
     also against their WMMA twins; the share of s8 codes that differ
     along the two chains; decode fidelity >= 0.99.
  6. Full-width int8 serving (`make_quantized_serving_fn`, 512 px, batch
     8, the default kernel set: the stem region in one launch with the
     fast epilogue), calibrated (absmax) on the served batch. Counters set
     to 0 just before one call and read just after: 33 int8 1x1, 31 int8
     3x3, 3 stride-2, 1 region and 1 NMS launch. images/s, the profile by
     kernel, and the int8-vs-bf16 decode fidelity (> 0.9, top 20). Then
     one call under each of the other stem routes, its launches asserted
     the same way: {region_pallas, exit_pallas} 33 / 31 / 4 and 1 tail;
     {exit_pallas} 34 / 32 / 4 and 1 exit conv; each of those calls'
     stride-2 launches (ConvBlock_1 among them) equal to its plain version
     and its WMMA twin.
  7. Each int8 kernel against its plain version on every input the int8
     serving calls handed it (s8 within 1 code, the 1x1, 3x3, stride-2
     and exit exactly and equal to their WMMA twins; for the region, tail
     and exit also the share of codes that differ; the region and the
     tail equal to their first design, the `_mma` twins, timed in turns
     beside them), and per shape the kernel's (with the 1x1's, 3x3's,
     stride-2's and exit's tile plan, and their WMMA twins timed in turns,
     twin, kernel, kernel, twin, as `previous_ms`), the plain version's
     and the library
     yardstick's time
     (`torch._int_mm` on the rows or an im2col, plus the epilogue ops,
     stage by stage for the region) beside the bound; for the region also
     the unfused chain of the stride-2, 1x1, 3x3 and stride-2 kernels on
     the same input, and PyTorch's quantize of its bf16 input followed by
     the kernel on the s8 codes (equal codes).
  8. The CLI's per-batch functions on 4 uint8 images, bf16 and --int8;
     CSVs in both layouts; the tiled CLI on a 2048 x 1536 image.
  9. Training at full width (512 px, 1024 filters, 8 blocks, bf16, batch
     16, `TrainConfig` defaults), on a seeded store of planted rectangles
     written by the port's `RecordWriter` (96 train, 32 test images):
     ms/step on a resident batch (CUDA events over 10 steps after 3),
     peak memory, one profiled step by kernel, `train_mfu`; 30 steps on
     one batch whose loss must fall; the train-graph gate
     (`phase_train_graph`: replayed steps bit-equal to eager ones, plain,
     QAT, static QAT and remat, the capturable Adam's update against the
     plain one's, 30 replayed steps whose loss falls, ms a step eager and
     replayed in turns; `--phase train_graph` runs this phase's step
     parts alone); `train.train_model` end to end (two
     epochs of 9 steps, augmentation, 3 reader workers): steps/s with the
     feed, the share of the loop spent waiting for batches,
     `test_loss.csv`, checkpoint and export; the export served in bf16
     (1x1 kernel) and int8 (the default set) with the serving phases'
     launch counts; one f32 step's gradients on the card against the
     CPU's at 64 px. One JSON line each.
 10. The training feed's device half at full width, on phase 9's stores:
     `preprocess_batch` at b16, 512 px, augmentation on: ms per batch
     (CUDA events over 10 batches after 2) and device ops per batch
     (profile); one batch's draws, made on the card, through the port on
     the card and on the CPU (boxes, valid and grids identical, pixels
     within 8 float32 ulps of 256); the native and pure-Python store
     readers' get_batch records/s; /dev/shm's free bytes beside the
     ring's; `train.train_model` with `--device_augment 1` and with
     `--device_augment 1 --shm_feed 1` (two epochs of 9 steps each, the
     native reader asserted, the eval steps' 1x1 launches counted: 34 a
     step), beside phase 9's host-feed figures; the device-feed export
     served in bf16 and int8 with the serving launch counts;
     `find_anchors` (k 2-4) on the planted boxes, and `evaluate_folders`
     of the served rows against them. One JSON line.
 11. Quantization-aware training at full width on phase 9's stores and
     batch: the step at b16 in three modes (plain, `int8_train`, with
     `int8_train_static`), timed in turns (CUDA events over 10 steps,
     plain, dynamic, static, static, dynamic, plain), each mode's peak
     memory, one profiled step each with the device time of
     `torch._int_mm` and of the whole `ops/quant.py::int8_conv_sums`; on
     one QAT forward of one image every STE conv's int32 sums on the
     card equal the CPU's float64 sums of the same codes; 30 steps on one
     batch whose loss must fall, in both QAT modes; `train.train_model`
     with `--int8_train 1` and with `--int8_train 1 --int8_static 1` (two
     epochs of 9 steps: one recalibration an epoch, every checkpointed
     scale finite and > 0 under `calibrate`'s keys, the export's flags
     cleared), each export served bf16 and int8 with the serving phases'
     launch counts; one f32 QAT step's gradients on the card within 2e-3
     of the CPU's at 64 px. One JSON line.
 12. The quality gates, tests/test_quality_e2e.py's closed loop on the
     card (`GATE`): 8 planted squares at 64 px, 1 block, 512 filters (the
     card's int8 kernels take channel counts in multiples of 16), 1000
     steps at peak lr 5e-3 under scripts/quality_gate_512.py's warm-up
     and decay, f32, in each of `bf16_train`, `int8_ste_train` and
     `int8_static_train` (its scales recalibrated every 250 steps), one
     process each, side by side; the
     loss under 0.5, then the export served through
     `inference.inference` in bf16 and with `--int8` and scored by
     `evaluate_folders`: mAP@0.5 >= 0.9 on both. One JSON line.
 13. Multi-device and G1 (`G1`, the 512 px gate's setting): the G1
     probe's MXU conv at every flagship conv shape at the gate's batch,
     forward and VJP, the route it takes within `MXU_BOUND` of the f64
     sums (`phase_mxu_exact`); the gate's first 30 steps at full depth, bf16, from `init_train_params(cfg,
     0)`, a step's loss and per scale its largest |objectness logit| and
     wh logit of the cells without an object as one JSON line; one
     full-depth f32 step's gradients on the card (TF32 off) against the
     CPU's, each leaf within the larger of 2e-3 of its largest |g| and
     `SPREAD_FACTOR` times the CPU's own spread when the batch is
     reversed or rolled. Data-parallel training at full width, bf16, 2
     ranks on the one card over gloo (NCCL takes one rank a device),
     global batch 8 = one half twice: `loss` within 1e-3 of one
     process's on the global batch, `loss_sum` twice its, the summed
     gradients exactly twice one rank's and, halved, within the spread
     bound of one process's; ms a step per rank beside one process's,
     each rank's peak memory with the replicated Adam and with ZeRO-1,
     whose parameters after 3 steps equal the replicated run's within
     rtol 2e-6 / atol 1e-7 (the reference's bound). The sharded
     detectors on [cuda:0, cuda:0], bf16 (the 1x1 kernel) and int8 (the
     default set), against one device: each sharded call's launches
     twice one replica's, decode fidelity >= 0.999. One forward and
     backward with and without `remat_blocks` (full width, bf16, b8,
     after a warm-up): equal loss and gradients, the peak memory and
     time of each. One JSON line.
 14. One JSON line of kernel results, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

A kernel's `ms` is device time: `device_ms` captures 20 calls in a CUDA
graph and times its replays with CUDA events, so the Python wrapper's
dispatch is not counted. `event_ms` beside it is the older measure, CUDA
events around 20 calls issued from Python after warm-up. Plain times are
event times; library times are device times in phases 4 and 7's region
rows (`library_event_ms` beside them), event times elsewhere. Inputs are
warm in the 50 MB L2.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 non-tensor operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12
# dense int8 tensor-core operations/s of the H100 SXM
INT8_OPS_S = 1979e12
# f32 operations of one IoU test in the NMS recurrence: 4 min/max, 2 sub,
# 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare. The function tests each
# valid candidate i only against the kept j < i.
IOU_OPS = 13
# f32 operations of quantizing one element: mul, round, 2 clamp
QUANT_OPS = 4
# f32 operations of stem1's fast epilogue on one element: add, mul, max,
# mul, add and the quantize's round and 2 clamps
STEM1_EPI_OPS = 8

FULL = dict(img_size=(512, 512, 3), number_classes=2,
            anchors=((64, 384), (384, 64)), filter_count=1024, block_count=8,
            compute_dtype="bfloat16", use_pallas_pointwise=True)
BATCH = 8
# the NMS problems of a batch-64 serving call: 64 images x 2 classes, 512
# candidates each
NMS_C, NMS_K = 128, 512
SEED = 0
DEVICE = "cuda"
# launches of one serving call at FULL: FeatureBlocks 1+2+8+8+4 1x1s,
# three YoloBlocks of three 1x1s and two neck 1x1s; one NMS launch
EXPECTED_LAUNCHES = {"pointwise_conv_block": 34, "nms_suppress": 1}
# int8 serving at FULL under the reference's default kernel set: the stem
# region (stem2, FeatureBlock_0's 1x1 and 3x3, ConvBlock_2) is one launch;
# 1x1s = 22 feature-block + 6 YoloBlock mid + 3 YoloBlock entry + 2 neck;
# 3x3s = 22 feature-block + 9 YoloBlock; 3 stride-2 blocks; one NMS launch
EXPECTED_INT8_LAUNCHES = {"pointwise_conv_block_q": 33,
                          "conv3x3_block_q": 31, "down_conv_block_q": 3,
                          "s2d_region_block_q": 1, "nms_suppress": 1}
# the region kernel's modes: their flag sets, counted per launch under
# s2d_region_q.variant(affine2, rawimg)
RAWIMG_SET = {"region_full": True, "region_fast": True,
              "region_rawimg": True}
AFFINE2_SET = {"region_full": True, "region_fast": True,
               "region_affine2": True}
BOTH_SET = dict(RAWIMG_SET, region_affine2=True)
REGION_MODES = {"s2d_region_block_q_rawimg": RAWIMG_SET,
                "s2d_region_block_q_affine2": AFFINE2_SET,
                "s2d_region_block_q_rawimg_affine2": BOTH_SET}


def region_set_launches(variant):
    return {"pointwise_conv_block_q": 33, "conv3x3_block_q": 31,
            "down_conv_block_q": 3, variant: 1, "nms_suppress": 1}


# the other stem routes and region modes: (kernel flags, launches of one
# serving call)
INT8_SETS = (
    ({"region_pallas": True, "exit_pallas": True},
     {"pointwise_conv_block_q": 33, "conv3x3_block_q": 31,
      "down_conv_block_q": 4, "s2d_tail_block_q": 1, "nms_suppress": 1}),
    ({"exit_pallas": True},
     {"pointwise_conv_block_q": 34, "conv3x3_block_q": 32,
      "down_conv_block_q": 4, "exit_conv_block_q": 1, "nms_suppress": 1}),
) + tuple((flags, region_set_launches(v)) for v, flags in REGION_MODES.items())
# the training phase: batch 16 at FULL; a store of 96 train and 32 test
# images of planted rectangles (1-4 per image, 48-200 px a side)
TRAIN_BATCH = 16
TRAIN_STORE = {"train": 96, "test": 32}
TRAIN_RECT = (48, 200)
# the trainer's epochs: 8 steps between tests, two epochs (the warm-up and
# one more), each size + 1 steps
TRAIN_EVERY, TRAIN_EPOCHS = 8, 2
# the device feed's phase: preprocess_batch timed over this many batches
# after two, and the card-vs-CPU bound on raw augmented pixels (8 float32
# ulps of a pixel in [256, 512), as tests/test_torch_device_pipeline.py)
FEED_REPS = 10
FEED_RAW_ATOL = 8 * 2.0 ** -15
# the CPU parity tests' bound on a gradient leaf against JAX, relative to
# the leaf's largest |g| (tests/test_torch_train_step.py)
GRAD_BOUND = 2e-3
# phase 11: the train step's modes, timed in turns at FULL, b16
QAT_MODES = {"plain": {}, "dynamic": {"int8_train": True},
             "static": {"int8_train": True, "int8_train_static": True}}
# phase 12: tests/test_quality_e2e.py's recipe (8 planted 24 px squares in
# 64 px images, 1 block, one batch, 1000 steps at lr 5e-3, f32, the static
# scales recalibrated every 250 steps, mAP@0.5 >= 0.9 served bf16 and
# int8) at 512 filters: the card's int8 kernels take channel counts in
# multiples of 16 (the stem's fc / 32). There the reference's constant lr
# leaves the QAT modes' loss at 0.45-0.63, so the lr follows
# scripts/quality_gate_512.py's warm-up and decay (`schedule`: its
# 8000-step warmup 300, decay 2500-6000, scaled to 1000 steps)
GATE = dict(size=64, box=24, images=8, steps=1000, lr=5e-3,
            schedule=(38, 312, 750), recalibrate=250, filter_count=512,
            min_box_size=8, min_map=0.9, max_loss=0.5)
GATE_MODES = {"bf16_train": {}, "int8_ste_train": {"int8_train": True},
              "int8_static_train": {"int8_train": True,
                                    "int8_train_static": True}}
# phase 13: the 512 px gate's setting (8 planted 96 px squares,
# scripts/quality_gate_512.py:72-122): its first `steps` steps at full
# depth in bf16 on its lr schedule (lr, warm-up, decay start, decay end),
# and one f32 step card vs CPU. `model` narrows the model (only a CPU
# rehearsal does)
G1 = dict(size=512, box=96, images=8, steps=30, anchors=((96, 96), (48, 48)),
          lr=(3e-4, 300, 2500, 6000), model={})
# a full-depth gradient leaf is held to the larger of GRAD_BOUND and this
# many times the reference's own spread (its gradient with the batch
# reversed, or rolled by one image): from the init, the same math in
# another summation order moves 280 of 294 leaves by more than
# GRAD_BOUND (up to 0.26 of their largest |g|), and XLA's step against
# the port's lies within 5.3x of that spread (median 1.8x;
# scripts/g1_trajectory.py, f32, teacher-forced at step 0)
SPREAD_FACTOR = 16
# the data-parallel check: ranks on the one card, the global batch (one
# half twice, 4 images a rank), steps with the replicated Adam and ZeRO-1
DP_WORLD, DP_BATCH, DP_STEPS = 2, 8, 3
# the tiled CLI phase: a seeded image of 2048 x 1536, 512 px tiles with 96
# px ghost zones (35 tiles: 4 batches of 8 and one of 3)
TILED_IMAGE = (2048, 1536, 3)
TILED_BATCH = 8
# int8 kernel -> (wrapper module, the TPU kernel's pallas_call)
INT8_KERNELS = {
    "pointwise_conv_block_q": (
        "pointwise_q", "yolov3_tpu/ops/pallas/pointwise_kernel.py:154"),
    "conv3x3_block_q": (
        "conv3x3_q", "yolov3_tpu/ops/pallas/conv3x3_kernel.py:205"),
    "down_conv_block_q": (
        "down_conv_q", "yolov3_tpu/ops/pallas/down_conv_kernel.py:156"),
    "s2d_region_block_q": (
        "s2d_region_q", "yolov3_tpu/ops/pallas/s2d_region_kernel.py:798"),
    "s2d_tail_block_q": (
        "s2d_tail_q", "yolov3_tpu/ops/pallas/s2d_tail_kernel.py:214"),
    "exit_conv_block_q": (
        "exit_conv_q", "yolov3_tpu/ops/pallas/exit_conv_kernel.py:130"),
}
CONV_KERNELS = ("pointwise_conv_block_q", "conv3x3_block_q",
                "down_conv_block_q")
# a bf16 image's rawimg region (stem1 on tensor cores) against its plain
# version: the TPU kernel's class against its reference, at most 1 code on
# at most 10% of the codes (tests/test_s2d_region_kernel.py:339-343)
TC_CODES, TC_SHARE = 1, 0.10
# the kernels on the wgmma core: exact against their plain versions and
# against their WMMA twins (entry NAME + "_wmma")
WGMMA_KERNELS = ("pointwise_conv_block_q", "conv3x3_block_q",
                 "down_conv_block_q", "exit_conv_block_q")
REGION_KERNELS = ("s2d_region_block_q", "s2d_tail_block_q",
                  "exit_conv_block_q")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20, replays=5):
    """Device time of one call of `fn` (ms): `reps` calls captured in a
    CUDA graph, replayed `replays` times between CUDA events, so the
    host's dispatch of each call is not timed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def turns_ms(old, new):
    """(new, old) device times (`device_ms`) of two versions of one call,
    timed in turns: old, new, new, old, each the mean of its two runs."""
    t = [device_ms(f) for f in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def bound(nbytes, ops, rate, f32_ops=0.0, bf16_ops=0.0):
    """The least time (ms, and what sets it) for `nbytes` of memory
    traffic, `ops` tensor-core operations at `rate` and `bf16_ops` more
    at the bf16 rate (the tensor cores take them one after the other),
    and `f32_ops` on the f32 CUDA-core pipe, which overlaps the tensor
    cores."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(ops / rate + bf16_ops / BF16_OPS_S, f32_ops / F32_OPS_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def record(module, name, store):
    """Wrap `module.name` so every call's arguments land in `store`;
    returns the function to put back."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        store.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return orig


def phase_reference(torch, ckpt, ModelConfig):
    """64 px, full width, f32: card vs CPU, kernel path vs plain path."""
    import numpy as np
    out = {}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3), dtype=np.float32))
    for flag in (False, True):
        cfg = ModelConfig(**dict(FULL, img_size=(64, 64, 3),
                                 compute_dtype="float32",
                                 use_pallas_pointwise=flag))
        params, stats = ckpt.init_params(cfg, SEED)
        with torch.inference_mode():
            cpu = ckpt.build_model(params, stats, cfg, "cpu").backbone(x)
            gpu = ckpt.build_model(params, stats, cfg, DEVICE).backbone(
                x.to(DEVICE))
        err = max(float(((g.cpu() - c).abs() / c.abs().clamp_min(1.0)).max())
                  for g, c in zip(gpu, cpu))
        out["kernel" if flag else "plain"] = err
        log(f"reference 64px f32 full width, use_pallas_pointwise={flag}: "
            f"max |card - cpu| / max(|cpu|, 1) = {err:.3e}")
    # plain f32 on both sides: only the summation order differs; with the
    # kernel, both sides round the 1x1 operands to bf16 (the JAX kernel's
    # bound, tests/test_pallas_conv_block.py::test_full_model_flag)
    if not (out["plain"] < 1e-3 and out["kernel"] < 5e-2):
        raise AssertionError(f"card disagrees with the CPU reference: {out}")
    return out


def phase_serving(torch, ckpt, inf, build, ModelConfig, InferenceConfig,
                  workdir, card):
    import numpy as np
    from yolov3_tpu_torch.ops.kernels import conv_block, nms_suppress

    cfg = ModelConfig(**FULL)
    params, stats = ckpt.init_params(cfg, SEED)
    path = ckpt.export_model(workdir, params, stats, cfg)
    serve, _ = inf.make_serving_fn(path, device=DEVICE)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, *cfg.img_size), dtype=np.float32)).to(DEVICE)

    # warm-up call that records what the path hands each kernel
    calls = {"pw": [], "nms": []}
    orig_pw = record(conv_block, "pointwise_conv_block", calls["pw"])
    orig_nms = record(nms_suppress, "suppress_boxes_t", calls["nms"])
    try:
        serve(images)
    finally:
        conv_block.pointwise_conv_block = orig_pw
        nms_suppress.suppress_boxes_t = orig_nms
    torch.cuda.synchronize()
    recorded = {"pointwise_conv_block": len(calls["pw"]),
                "nms_suppress": len(calls["nms"])}
    if recorded != EXPECTED_LAUNCHES:
        raise AssertionError(f"recorded kernel calls {recorded} != "
                             f"{EXPECTED_LAUNCHES}")

    build.launch_counts.clear()
    boxes, scores, keep = serve(images)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"serving b{BATCH} 512px bf16 launches: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"expected launches {EXPECTED_LAUNCHES}, got "
                             f"{launches}")
    k = min(InferenceConfig().max_boxes_per_class, cfg.number_output_boxes)
    for t, shape in ((boxes, (BATCH, 2, k, 4)), (scores, (BATCH, 2, k)),
                     (keep, (BATCH, 2, k))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"output shape {tuple(t.shape)} != {shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("serving output is not finite")
    kept = int(keep.sum())
    if kept == 0:
        raise AssertionError("serving kept no detection")

    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve(images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    log(f"serving b{BATCH} 512px bf16 (kernels on): {dt * 1e3:.3f} ms/batch, "
        f"{BATCH / dt:.2f} images/s, {kept} boxes kept, on {card}")
    serving = {"batch": BATCH, "ms_per_batch": dt * 1e3,
               "images_per_s": BATCH / dt, "kept": kept,
               "profile": phase_profile(torch, serve, images)}
    return path, calls, launches, serving


def phase_profile(torch, serve, images, reps=3, top=15,
                  what="serving calls", ops=()):
    """Device time by kernel over `reps` serving calls (torch.profiler),
    and the device's busy share of the window's wall time; with `ops`,
    also the device time of the kernels each named host op (or
    `record_function` span) launched, per call."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # acc_events: keep every call's events (the profiler may otherwise
    # drop those of earlier cycles, and count fewer ops than ran)
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            serve(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a `record_function` span also appears as a CUDA-typed annotation
    # whose time covers its kernels and the gaps between them: not a
    # device op, and left out of the sums
    cuda, cpu = (torch.autograd.DeviceType.CUDA,
                 torch.autograd.DeviceType.CPU)
    events = [e for e in prof.key_averages() if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)
              and e.key not in ops]
    total = sum(e.self_device_time_total for e in events) / 1e3
    n_ops = sum(e.count for e in events) / reps
    log(f"profile {reps} {what}: wall {wall_ms:.3f} ms, device busy "
        f"{total:.3f} ms ({100 * total / wall_ms:.1f}%), {n_ops:.0f} device "
        f"ops per call")
    rows = []
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / reps
        rows.append({"name": e.key, "ms_per_call": ms, "count": e.count / reps})
        log(f"profile  {ms:9.4f} ms/call  x{e.count / reps:6.1f}  {e.key[:90]}")
    out = {"wall_ms": wall_ms / reps, "device_ms": total / reps,
           "device_ops_per_call": n_ops, "top": rows}
    if ops:
        # the host op's (or span's) own entry: the kernels launched under
        # it, its children's included
        spans = {e.key: e for e in prof.key_averages()
                 if e.key in ops and e.device_type == cpu}
        out["op_device_ms"] = {
            name: getattr(spans[name], "device_time_total", 0.0) / 1e3 / reps
            if name in spans else 0.0 for name in ops}
        log(f"profile  op device ms per call: {out['op_device_ms']}")
    return out


def phase_pointwise(torch, calls):
    """The bf16 1x1 kernel vs its plain version and its WMMA twin on every
    recorded call (within 2e-2); per launch shape, the kernel's and the
    twin's device time in turns (twin, kernel, kernel, twin), the library
    yardstick's device time, the plain version's event time and the
    bound; per-forward sums."""
    import torch.nn.functional as F
    from yolov3_tpu_torch.ops.kernels import _conv_q, conv_block as K

    groups, max_err = {}, 0.0
    for args, _ in calls:
        x, w, b, mul, add, alpha, out_dtype = args
        got = K.pointwise_conv_block(*args)
        want = K.pointwise_conv_block_plain(*args)
        twin = K.pointwise_conv_block_wmma(*args)
        for other in (want, twin):
            torch.testing.assert_close(got.float(), other.float(), rtol=2e-2,
                                       atol=2e-2)
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
        key = (*x.shape, w.shape[0], str(out_dtype))
        groups.setdefault(key, []).append(args)
    rows = []
    for (m, ci, co, _), members in groups.items():
        x, w, b, mul, add, alpha, out_dtype = members[0]

        def library():
            y = torch.matmul(x, w.t()).float() + b
            return (F.leaky_relu(y, alpha) * mul + add).to(out_dtype)

        def kern():
            return K.pointwise_conv_block(x, w, b, mul, add, alpha, out_dtype)

        def old():
            return K.pointwise_conv_block_wmma(x, w, b, mul, add, alpha,
                                               out_dtype)

        ms, previous = turns_ms(old, kern)
        event = cuda_ms(kern, 20)
        plain = cuda_ms(lambda: K.pointwise_conv_block_plain(
            x, w, b, mul, add, alpha, out_dtype), 5)
        lib, lib_event = device_ms(library), cuda_ms(library, 20)
        out_bytes = torch.finfo(out_dtype).bits // 8
        nbytes = (m * ci + ci * co) * 2 + 3 * co * 4 + m * co * out_bytes
        ops = 2 * m * ci * co + 5 * m * co
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_S)
        plan = _conv_q.conv_plan(1, 1, m, ci, co, 1, esize=2)
        rows.append(dict(m=m, ci=ci, co=co, out_dtype=str(out_dtype),
                         launches=len(members), ms=ms, previous_ms=previous,
                         event_ms=event, plain_ms=plain, library_ms=lib,
                         library_event_ms=lib_event, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes, ops=ops,
                         plan=list(plan)))
        log(f"pointwise_conv_block M={m} Ci={ci} Co={co} {out_dtype} "
            f"x{len(members)}: kernel {ms:.4f} ms (events {event:.4f}), WMMA "
            f"twin {previous:.4f} ms, plan {tuple(plan)}, plain {plain:.4f} "
            f"ms, library {lib:.4f} ms (events {lib_event:.4f}), bound "
            f"{b_ms:.4f} ms ({b_by}), {ops / ms / 1e9:.1f} TFLOP/s")
    keys = ("ms", "previous_ms", "event_ms", "plain_ms", "library_ms",
            "library_event_ms", "bound_ms", "bytes", "ops")
    per = {k: sum(r[k] * r["launches"] for r in rows) for k in keys}
    t_bytes, t_ops = per["bytes"] / HBM_BYTES_S, per["ops"] / BF16_OPS_S
    summary = dict(per, bound_by="bytes" if t_bytes >= t_ops
                   else "operations", max_abs_err=max_err)
    log(f"pointwise_conv_block per forward ({len(calls)} launches): "
        f"kernel {per['ms']:.3f} ms (WMMA twin {per['previous_ms']:.3f} "
        f"ms), plain {per['plain_ms']:.3f} ms, library "
        f"{per['library_ms']:.3f} ms, bound {per['bound_ms']:.3f} ms")
    return summary, rows


def nms_case(torch, cand, valid, label):
    """The box kernel against its plain version and its first design (the
    chain twin), both timed in turns."""
    from yolov3_tpu_torch.ops.kernels import nms_suppress as K
    got = K.suppress_boxes_t(cand, valid, 0.3)
    want = K.suppress_boxes_plain(cand, valid, 0.3)
    chain = K.suppress_boxes_chain(cand, valid, 0.3)
    err = float((got.int() - want.int()).abs().max())
    if err != 0 or not torch.equal(got, chain):
        raise AssertionError(f"NMS kernel keep mask differs ({label}): "
                             f"{int((got != want).sum())} slots from plain, "
                             f"{int((got != chain).sum())} from the chain")
    ms, previous = turns_ms(lambda: K.suppress_boxes_chain(cand, valid, 0.3),
                            lambda: K.suppress_boxes_t(cand, valid, 0.3))
    event = cuda_ms(lambda: K.suppress_boxes_t(cand, valid, 0.3), 20)
    plain = cuda_ms(lambda: K.suppress_boxes_plain(cand, valid, 0.3), 2, 1)
    c, k = valid.shape
    kept = want.to(torch.float64)
    pairs = float(((kept.cumsum(dim=1) - kept) * valid).sum())
    b_ms, b_by = bound(c * k * (16 + 1 + 1), pairs * IOU_OPS, F32_OPS_S)
    log(f"nms_suppress {label} C={c} K={k} valid={int(valid.sum())}: kernel "
        f"{ms:.4f} ms (events {event:.4f}), chain twin {previous:.4f} ms, "
        f"plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}, {pairs:.0f} "
        f"IoU tests), keep bit-equal to plain and chain ({int(got.sum())} "
        f"kept)")
    return dict(label=label, c=c, k=k, ms=ms, previous_ms=previous,
                event_ms=event, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                iou_tests=pairs, max_abs_err=err)


def greedy_case(torch, cand, valid, label):
    """The IoU-slab kernel (greedy_suppress) on the slab of `cand`: keep
    bit-equal to its plain version, to its first design (the chain twin
    greedy_suppress_chain) and to the box kernel (nms_suppress); the
    kernel and the chain timed in turns."""
    from yolov3_tpu_torch.ops.kernels import nms_suppress as K
    from yolov3_tpu_torch.ops.nms import pairwise_iou
    from yolov3_tpu_torch.ops.kernels import _build as build
    # the entry as a caller holding an IoU slab calls it, between the
    # counters' reset and read
    iou = pairwise_iou(cand).contiguous()
    build.launch_counts.clear()
    got = K.greedy_suppress(iou, valid, 0.3)
    torch.cuda.synchronize()
    launches = build.launch_counts[K.GREEDY]
    if launches != 1:
        raise AssertionError(f"greedy_suppress launched {launches} times")
    want = K.greedy_suppress_plain(iou, valid, 0.3)
    chain = K.greedy_suppress_chain(iou, valid, 0.3)
    boxes = K.suppress_boxes_t(cand, valid, 0.3)
    err = float((got.int() - want.int()).abs().max())
    if not (err == 0 and torch.equal(got, chain)
            and torch.equal(got, boxes)):
        raise AssertionError(f"greedy_suppress keep mask differs ({label}): "
                             f"{int((got != want).sum())} slots from plain, "
                             f"{int((got != chain).sum())} from the chain, "
                             f"{int((got != boxes).sum())} from nms_suppress")
    ms, previous = turns_ms(lambda: K.greedy_suppress_chain(iou, valid, 0.3),
                            lambda: K.greedy_suppress(iou, valid, 0.3))
    event = cuda_ms(lambda: K.greedy_suppress(iou, valid, 0.3), 20)
    plain = cuda_ms(lambda: K.greedy_suppress_plain(iou, valid, 0.3), 2, 1)
    c, k = valid.shape
    # as for the box kernel: the function needs iou[i, j] only for each
    # valid i and kept j < i (4 bytes and one compare each), plus valid
    # and keep
    kept = want.to(torch.float64)
    pairs = float(((kept.cumsum(dim=1) - kept) * valid).sum())
    b_ms, b_by = bound(pairs * 4 + 2 * c * k, pairs, F32_OPS_S)
    log(f"greedy_suppress {label} C={c} K={k} valid={int(valid.sum())}: "
        f"kernel {ms:.4f} ms (events {event:.4f}), chain twin "
        f"{previous:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}, {pairs:.0f} IoU entries; the whole slab "
        f"{c * k * k * 4 / 1e6:.1f} MB), keep bit-equal to plain, the "
        f"chain and nms_suppress ({int(got.sum())} kept)")
    return dict(label=label, c=c, k=k, ms=ms, previous_ms=previous,
                event_ms=event, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, iou_entries=pairs,
                slab_bytes=c * k * k * 4, max_abs_err=err,
                launches=launches)


def phase_nms(torch, calls):
    """Kernel 1 on the serving call's candidates and both kernels at the
    batch-64 shapes; returns (nms rows, greedy rows)."""
    import numpy as np
    (cand, valid, _), _ = calls[0]
    rows = [nms_case(torch, cand, valid, f"serving b{BATCH}")]
    rng = np.random.default_rng(3)
    c, k = NMS_C, NMS_K
    xy = rng.random((c, k, 2), np.float32) * 400
    wh = rng.random((c, k, 2), np.float32) * 100 + 5
    cand = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(DEVICE)
    counts = torch.from_numpy(rng.integers(0, k + 1, c)).to(DEVICE)
    sparse = torch.arange(k, device=DEVICE)[None, :] < counts[:, None]
    greedy = []
    for valid, label in ((torch.ones_like(sparse), "b64 saturated"),
                         (sparse.contiguous(), "b64 sparse")):
        rows.append(nms_case(torch, cand, valid, label))
        greedy.append(greedy_case(torch, cand, valid, label))
    return rows, greedy


def record_io(module, name, store):
    """Wrap `module.name` so every call's (name, args, kwargs, output)
    lands in `store`; returns the function to put back."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        store.append((name, args, kwargs, out))
        return out

    setattr(module, name, wrapper)
    return orig


def int8_module(name):
    return importlib.import_module(
        f"yolov3_tpu_torch.ops.kernels.{INT8_KERNELS[name][0]}")


def int8_compare(torch, got, want):
    """(max s8 code difference, s8 codes differing, s8 codes, max float
    difference) between two int8 kernel results; floats must agree within
    a bf16 ulp."""
    code = differ = total = 0
    fl = 0.0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            code = max(code, int(d.max()))
            differ += int((d > 0).sum())
            total += d.numel()
        else:
            d = (g.float() - w.float()).abs()
            fl = max(fl, float(d.max()))
            if bool((d > 2.0 ** -7 * w.float().abs() + 1e-6).any()):
                raise AssertionError(f"float output beyond a bf16 ulp: "
                                     f"{float(d.max())}")
    return code, differ, total, fl


def int8_exact(torch, got, want):
    """True when 0 s8 codes differ and float outputs are bit-equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())
        for g, w in zip(got, want))


def wmma_twin(name, args, kw):
    """A recorded call of a wgmma kernel's wrapper, on its WMMA twin (the
    entry NAME + "_wmma" of the same library, same contract); timed and
    compared here only, never on a serving path."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    if name == "exit_conv_block_q":
        return int8_module(name).exit_conv_block_q_wmma(*args, **kw)
    x, w_t, epi = args
    out = kw.get("out_dtype")
    res = kw.get("residual_q")
    if name == "pointwise_conv_block_q":
        shape = dict(ksize=1, stride=1, cast_bf16=out != _conv_q.F32,
                     residual_in=res)
    else:
        shape = dict(ksize=3, stride=launch_stride(name),
                     cast_bf16=kw["cast_bf16"], residual_out=res)
    return _conv_q.launch(name, x, w_t, epi, inv_in=kw["inv_in"],
                          inv_next=kw["inv_next"], alpha=kw["alpha"],
                          res_scale=kw.get("res_scale", 0.0),
                          emit_s8=kw.get("emit_s8", True), out_dtype=out,
                          wmma=True, **shape)


def launch_stride(name):
    return 2 if name in ("down_conv_block_q", "exit_conv_block_q") else 1


def launch_plan(name, args):
    """The tile plan `_conv_q.launch` gives a wgmma kernel's call."""
    import torch
    from yolov3_tpu_torch.ops.kernels import _conv_q
    x, w_t, _ = args
    n, h, w, ci = x.shape
    return _conv_q.conv_plan(n, h, w, ci, w_t.shape[1],
                             1 if w_t.shape[0] == 1 else 3,
                             x.dtype != torch.int8,
                             stride=launch_stride(name))


def phase_int8_reference(torch, ckpt, TQ, ModelConfig):
    """64 px, full width, bf16, one scale dict: the int8 model on the card
    (kernels) against the same model on the CPU (plain versions)."""
    import numpy as np
    cfg = ModelConfig(**dict(FULL, img_size=(64, 64, 3)))
    params, stats = ckpt.init_params(cfg, SEED)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3), dtype=np.float32))
    # both sides under the card's default kernel set (the CPU's is {})
    kernels = TQ.default_serving_kernels("cuda")
    cpu = TQ.build_quantized_model(params, stats, cfg, "cpu",
                                   kernels=kernels)
    scales = TQ.calibrate(cpu, x)
    cpu.set_act_scales(scales)
    card = TQ.build_quantized_model(params, stats, cfg, DEVICE, scales,
                                    kernels=kernels)
    runs, dets = {"cpu": [], "card": []}, {}
    for side, model, xin in (("cpu", cpu, x), ("card", card, x.to(DEVICE))):
        origs = {n: record_io(TQ, n, runs[side]) for n in INT8_KERNELS}
        try:
            with torch.inference_mode():
                dets[side] = model.forward_detections(xin).float().cpu()
        finally:
            for n, f in origs.items():
                setattr(TQ, n, f)
    torch.cuda.synchronize()
    # each card launch against its plain version on the same inputs; the
    # wgmma kernels exactly, and equal to their WMMA twins
    code, fl, inexact = 0, 0.0, []
    for name, args, kw, out in runs["card"]:
        want = getattr(int8_module(name), f"{name}_plain")(
            *(a.cpu() for a in args),
            **{k: v.cpu() if torch.is_tensor(v) else v
               for k, v in kw.items()})
        c, _, _, f = int8_compare(torch, out, want)
        code, fl = max(code, c), max(fl, f)
        if name in WGMMA_KERNELS and not (
                int8_exact(torch, out, want)
                and int8_exact(torch, out, wmma_twin(name, args, kw))):
            inexact.append((name, tuple(args[0].shape)))
    # the two chains, launch by launch (the bf16 stem1 convolution differs
    # between cuDNN and the CPU, so the chains' inputs drift apart)
    chain = [0, 0, 0]
    for (n1, _, _, o1), (n2, _, _, o2) in zip(runs["card"], runs["cpu"]):
        assert n1 == n2, (n1, n2)
        c, differ, total, _ = int8_compare(torch, o1, o2)
        chain = [max(chain[0], c), chain[1] + differ, chain[2] + total]
    fid = TQ.decode_iou_fidelity(dets["cpu"].numpy(), dets["card"].numpy(),
                                 top_k=20)
    out = dict(launches=len(runs["card"]), max_code_diff=code,
               max_float_diff=fl, wgmma_inexact=len(inexact),
               chain_max_code_diff=chain[0],
               chain_codes_differing=chain[1] / max(chain[2], 1),
               fidelity=fid)
    log(f"int8 reference 64px bf16 full width, {len(runs['card'])} kernel "
        f"launches: kernel vs plain on the same inputs max code diff {code}, "
        f"max float diff {fl:.3e}; wgmma launches not exact vs plain and "
        f"WMMA: {inexact}; card vs CPU chains: max code diff "
        f"{chain[0]}, {100 * out['chain_codes_differing']:.4f}% of "
        f"{chain[2]} s8 codes differ; decode fidelity {fid:.6f}")
    if (len(runs["card"]) != len(runs["cpu"]) or code > 1 or fid < 0.99
            or inexact
            or sum(r[0] == "s2d_region_block_q" for r in runs["card"]) != 1):
        raise AssertionError(f"int8 card disagrees with the CPU: {out}")
    return out


def int8_serving_call(torch, TQ, build, serve, images, expected, label):
    """A warm-up call that records what the path hands each kernel, then
    one call between the counters' reset and read; both must launch
    `expected`. Returns (recorded calls, launches, outputs)."""
    from yolov3_tpu_torch.ops.kernels import nms_suppress
    calls, nms_calls = [], []
    origs = {n: record_io(TQ, n, calls) for n in INT8_KERNELS}
    orig_nms = record(nms_suppress, "suppress_boxes_t", nms_calls)
    try:
        serve(images)
    finally:
        for n, f in origs.items():
            setattr(TQ, n, f)
        nms_suppress.suppress_boxes_t = orig_nms
    torch.cuda.synchronize()
    recorded = {n: sum(c[0] == n for c in calls) for n in INT8_KERNELS}
    recorded["nms_suppress"] = len(nms_calls)
    recorded = {n: v for n, v in recorded.items() if v}
    # a region mode's launches are counted under its variant, its calls
    # under the wrapper
    want = {("s2d_region_block_q" if n in REGION_MODES else n): v
            for n, v in expected.items()}
    if recorded != want:
        raise AssertionError(f"{label}: recorded int8 kernel calls "
                             f"{recorded} != {want}")

    build.launch_counts.clear()
    outputs = serve(images)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"serving b{BATCH} 512px {label} launches: {launches}")
    if launches != expected:
        raise AssertionError(f"{label}: expected launches {expected}, got "
                             f"{launches}")
    return calls, launches, outputs


def phase_int8_sets(torch, TQ, build, path, images):
    """One full-width serving call under each of the other stem routes'
    and region modes' kernel sets, each of its stride-2 launches equal to
    its plain version and its WMMA twin; returns the tail's, the exit's
    and the region modes' recorded calls, their launches, and the region
    modes' serving functions."""
    calls, launches, serves = [], {}, {}
    for kernels, expected in INT8_SETS:
        serve, _, _ = TQ.make_quantized_serving_fn(path, images,
                                                   device=DEVICE,
                                                   kernels=kernels)
        rec, got, (boxes, scores, keep) = int8_serving_call(
            torch, TQ, build, serve, images, expected, f"int8 {kernels}")
        if not (torch.isfinite(boxes).all() and int(keep.sum()) > 0):
            raise AssertionError(f"int8 {kernels}: bad serving output")
        name = "down_conv_block_q"
        down = [c for c in rec if c[0] == name]
        with torch.inference_mode():
            for _, args, kw, out in down:
                want = int8_module(name).down_conv_block_q_plain(*args, **kw)
                if not (int8_exact(torch, out, want) and int8_exact(
                        torch, out, wmma_twin(name, args, kw))):
                    raise AssertionError(
                        f"int8 {kernels}: {name} {tuple(args[0].shape)} not "
                        f"equal to its plain version and WMMA twin")
        log(f"int8 {kernels}: {len(down)} stride-2 launches "
            f"{[tuple(c[1][0].shape) for c in down]} equal to plain and "
            f"WMMA twin")
        calls += [c for c in rec if c[0] in REGION_KERNELS]
        launches.update({n: v for n, v in got.items()
                         if n in REGION_KERNELS or n in REGION_MODES})
        modes = [n for n in got if n in REGION_MODES]
        if modes:
            serves[modes[0]] = serve
            if not (torch.isfinite(scores).all()
                    and tuple(boxes.shape[:2]) == (BATCH, 2)):
                raise AssertionError(f"int8 {kernels}: bad serving output")
    return calls, launches, serves


def phase_int8_serving(torch, inf, TQ, build, path, images, card):
    serve, cfg, scales = TQ.make_quantized_serving_fn(path, images,
                                                      device=DEVICE)
    calls, launches, (boxes, scores, keep) = int8_serving_call(
        torch, TQ, build, serve, images, EXPECTED_INT8_LAUNCHES,
        "int8 (default kernels)")
    k = min(inf.InferenceConfig().max_boxes_per_class,
            cfg.number_output_boxes)
    for t, shape in ((boxes, (BATCH, 2, k, 4)), (scores, (BATCH, 2, k)),
                     (keep, (BATCH, 2, k))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"output shape {tuple(t.shape)} != {shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("int8 serving output is not finite")
    kept = int(keep.sum())
    if kept == 0:
        raise AssertionError("int8 serving kept no detection")

    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve(images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    log(f"serving b{BATCH} 512px int8 (kernels on): {dt * 1e3:.3f} ms/batch, "
        f"{BATCH / dt:.2f} images/s, {kept} boxes kept, {len(scales)} "
        f"scales, on {card}")
    serving = {"batch": BATCH, "ms_per_batch": dt * 1e3,
               "images_per_s": BATCH / dt, "kept": kept,
               "profile": phase_profile(torch, serve, images)}

    # quality gate at the serving shape (bench.py:162-171)
    detect_f, _ = inf.make_detector_fn(path, device=DEVICE)
    detect_q, _ = TQ.make_quantized_detector_fn(path, images, device=DEVICE)
    det_f = detect_f(images).float().cpu().numpy()
    det_q = detect_q(images).float().cpu().numpy()
    fid = TQ.decode_iou_fidelity(det_f, det_q, top_k=20)
    log(f"int8 vs bf16 decode fidelity (top 20, b{BATCH} 512px): {fid:.6f}")
    if not fid > 0.9:
        raise AssertionError(f"int8 decode fidelity {fid} <= 0.9")
    serving["fidelity"] = fid
    # the exact epilogue table of the served model (the chain of phase 7)
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    params, stats, _ = ckpt.load_model(path)
    exact_epi = TQ.build_quantized_model(
        params, stats, cfg, DEVICE, scales,
        kernels={"region_full": True}).q_region_epi
    return calls, launches, serving, exact_epi, serve


def conv_macs(n, h, w, ci, co, k, s):
    """Multiply-adds of an NHWC SAME conv: the taps inside the image."""
    from yolov3_tpu_torch.ops.kernels._conv_q import same_pads
    oh, ow = -(-h // s), -(-w // s)
    pt, pl = same_pads(h, k, s)[0], same_pads(w, k, s)[0]

    def inside(size, out, pad, u):
        return sum(0 <= i * s - pad + u < size for i in range(out))

    return n * ci * co * sum(inside(h, oh, pt, u) * inside(w, ow, pl, v)
                             for u in range(k) for v in range(k))


def int8_work(name, args, kw):
    """(bytes moved, int8 operations) of one int8 kernel call: each input
    read once, each output written once; the products of the taps that
    fall inside the image."""
    x, w_t, epi = args
    taps, co, ci = w_t.shape
    k = 1 if taps == 1 else 3
    s = 2 if name == "down_conv_block_q" else 1
    n, h, w, _ = x.shape
    oh, ow = -(-h // s), -(-w // s)
    res = kw.get("residual_q")
    out_f = kw.get("out_dtype")
    nbytes = (x.numel() * x.element_size() + w_t.numel() + epi.numel() * 4
              + (res.numel() if res is not None else 0)
              + n * oh * ow * co * (int(kw.get("emit_s8", True))
                                    + (out_f.itemsize if out_f else 0)))
    return nbytes, 2 * conv_macs(n, h, w, ci, co, k, s)


def int8_sums(torch, q, w_t, stride):
    """Exact int32 sums of an s8 SAME conv with torch._int_mm (cuBLAS
    int8) on the rows, or on an im2col of the 3x3 taps."""
    import torch.nn.functional as F
    from yolov3_tpu_torch.ops.kernels import _conv_q
    taps, co, ci = w_t.shape
    n, h, w, _ = q.shape
    if taps == 1:
        oh, ow, a = h, w, q.reshape(-1, ci)
    else:
        (pt, pb), (pl, pr) = (_conv_q.same_pads(h, 3, stride),
                              _conv_q.same_pads(w, 3, stride))
        oh, ow = -(-h // stride), -(-w // stride)
        cols = F.unfold(F.pad(q.permute(0, 3, 1, 2).to(torch.float16),
                              (pl, pr, pt, pb)), 3, stride=stride)
        a = cols.transpose(1, 2).reshape(-1, ci * 9).to(torch.int8)
    # column-major [K, Co], K in unfold's (channel, tap) order
    b = w_t.permute(1, 2, 0).reshape(co, ci * taps).t()
    return torch._int_mm(a, b).reshape(n, oh, ow, co)


def int8_library(torch, name, args, kw):
    """The library yardstick: the same function with `int8_sums` plus the
    epilogue as PyTorch ops. Timed here only; the port never calls it."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    x, w_t, epi = args
    res = kw.get("residual_q")
    pointwise = name == "pointwise_conv_block_q"
    q = _conv_q.quantized_input(x, kw["inv_in"], res if pointwise else None,
                                kw.get("res_scale", 0.0))
    acc = int8_sums(torch, q, w_t, 2 if name == "down_conv_block_q" else 1)
    out_f = kw.get("out_dtype")
    cast = kw.get("cast_bf16", out_f != torch.float32)
    return _conv_q.epilogue(acc, epi, inv_next=kw["inv_next"],
                            alpha=kw["alpha"], cast_bf16=cast,
                            residual_out=None if pointwise else res,
                            res_scale=kw.get("res_scale", 0.0),
                            emit_s8=kw.get("emit_s8", True), out_dtype=out_f)


def phase_int8_kernels(torch, calls):
    """Every recorded int8 launch against its plain version (the wgmma
    kernels exactly, and equal to their WMMA twins); per distinct shape,
    the kernel's device time (`device_ms`) beside its event time, the
    plain and library times and the bound; for the wgmma kernels the WMMA
    twin's device time in turns (twin, kernel, kernel, twin) as
    `previous_ms`, and the tile plan."""
    errs, lib_errs, groups = {}, {}, {}
    for name, args, kw, out in calls:
        if name not in CONV_KERNELS:
            continue
        mod = int8_module(name)
        want = getattr(mod, f"{name}_plain")(*args, **kw)
        c, _, _, f = int8_compare(torch, out, want)
        if c > 1:
            raise AssertionError(f"{name} {tuple(args[0].shape)}: s8 codes "
                                 f"differ from the plain version by {c}")
        if name in WGMMA_KERNELS and not (
                int8_exact(torch, out, want)
                and int8_exact(torch, out, wmma_twin(name, args, kw))):
            raise AssertionError(f"{name} {tuple(args[0].shape)}: not equal "
                                 f"to its plain version and WMMA twin")
        errs[name] = max(errs.get(name, 0.0), float(c), f)
        res = kw.get("residual_q")
        key = (name, tuple(args[0].shape), str(args[0].dtype),
               tuple(args[1].shape), kw.get("emit_s8", True),
               str(kw.get("out_dtype")), res is not None)
        groups.setdefault(key, []).append((args, kw))
    rows = []
    for key, members in groups.items():
        name = key[0]
        mod = int8_module(name)
        kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        args, kw = members[0]
        lib_c, _, _, lib_f = int8_compare(
            torch, int8_library(torch, name, args, kw), plain(*args, **kw))
        lib_errs[name] = max(lib_errs.get(name, 0.0), float(lib_c), lib_f)

        def new():
            return kern(*args, **kw)

        extra = {}
        if name in WGMMA_KERNELS:
            def old():
                return wmma_twin(name, args, kw)

            ms, extra["previous_ms"] = turns_ms(old, new)
            extra["plan"] = list(launch_plan(name, args))
        else:
            ms = device_ms(new)
        event = cuda_ms(new, 20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 2, 1)
        lib = cuda_ms(lambda: int8_library(torch, name, args, kw), 10)
        nbytes, ops = int8_work(name, args, kw)
        b_ms, b_by = bound(nbytes, ops, INT8_OPS_S)
        n, h, w, ci = args[0].shape
        co = args[1].shape[1]
        rows.append(dict(kernel=name, shape=f"{n}x{h}x{w}x{ci}->{co}",
                         x_dtype=key[2], emit_s8=key[4], out_dtype=key[5],
                         residual=key[6], launches=len(members), ms=ms,
                         event_ms=event, plain_ms=plain_ms, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                         **extra))
        old_s = (f", WMMA twin {extra['previous_ms']:.4f} ms, plan "
                 f"{tuple(extra['plan'])}" if extra else "")
        log(f"{name} {rows[-1]['shape']} {key[2]} x{len(members)}: kernel "
            f"{ms:.4f} ms (events {event:.4f}){old_s}, plain "
            f"{plain_ms:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {ops / ms / 1e9:.1f} TOP/s")
    summary = {}
    for name in CONV_KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        keys = ["ms", "event_ms", "plain_ms", "library_ms", "bound_ms",
                "bytes", "ops"]
        if name in WGMMA_KERNELS:
            keys.append("previous_ms")
        per = {k: sum(r[k] * r["launches"] for r in mine) for k in keys}
        t_bytes, t_ops = per["bytes"] / HBM_BYTES_S, per["ops"] / INT8_OPS_S
        summary[name] = dict(per, bound_by="bytes" if t_bytes >= t_ops
                             else "operations", max_abs_err=errs[name],
                             library_max_err=lib_errs[name])
        prev = (f" (WMMA twin {per['previous_ms']:.3f} ms)"
                if "previous_ms" in per else "")
        log(f"{name} per forward ({sum(r['launches'] for r in mine)} "
            f"launches): kernel {per['ms']:.3f} ms{prev}, events "
            f"{per['event_ms']:.3f} ms, plain {per['plain_ms']:.3f} ms, "
            f"library {per['library_ms']:.3f} ms, bound "
            f"{per['bound_ms']:.3f} ms, {per['ops'] / per['ms'] / 1e9:.1f} "
            f"TOP/s; max err vs plain {errs[name]}, library vs plain "
            f"{lib_errs[name]}")
    return summary, rows


def region_work(name, args, kw=None):
    """(bytes moved, int8 operations, f32 operations, bf16 operations) of
    one stem-region launch: its input, weights and epi read once and its
    output written once; each stage's products of the taps inside the
    image; the quantize of a float input; with `w_s1` (rawimg) stem1's
    products and adds of the taps inside the image, bf16 x bf16 products
    for a bf16 image (tensor-core work) and f32 ones for an f32 image, and
    its epilogue (STEM1_EPI_OPS an element) on the f32 pipe."""
    x, *weights, epi = args
    w_s1 = (kw or {}).get("w_s1")
    f32_ops = QUANT_OPS * x.numel() if x.dtype.is_floating_point else 0
    bf16_ops = 0
    strides = {"s2d_region_block_q": (2, 1, 1, 2),
               "s2d_tail_block_q": (1, 1, 2), "exit_conv_block_q": (2,)}
    n, h, w, ci = x.shape
    extra = 0
    if w_s1 is not None:
        c1 = w_s1.shape[1]
        stem1_ops = 2 * conv_macs(n, h, w, ci, c1, 3, 1)
        f32_ops = STEM1_EPI_OPS * n * h * w * c1
        if x.dtype == w_s1.dtype and x.element_size() == 2:
            bf16_ops = stem1_ops
        else:
            f32_ops += stem1_ops
        extra = w_s1.numel() * w_s1.element_size()
        ci = c1
    macs = 0
    for wt, st in zip(weights, strides[name]):
        co = wt.shape[1]
        macs += conv_macs(n, h, w, ci, co, 1 if wt.shape[0] == 1 else 3, st)
        h, w, ci = -(-h // st), -(-w // st), co
    nbytes = (x.numel() * x.element_size() + sum(wt.numel() for wt in weights)
              + extra + epi.numel() * 4 + n * h * w * ci)
    return nbytes, 2 * macs, f32_ops, bf16_ops


def region_library(torch, name, args, kw):
    """The library yardstick of a stem-region launch: its stages one at a
    time, each as `int8_library` computes a ConvBlock (torch._int_mm sums,
    then the epilogue as PyTorch ops): the plain version with its exact
    float64 sums replaced by `int8_sums`; with `w_s1` (rawimg), stem1 first
    as cuDNN's conv of the image in its type and the epilogue as PyTorch
    ops. Timed here only."""
    mod = int8_module(name)
    kw = dict(kw)
    w_s1 = kw.pop("w_s1", None)
    if w_s1 is not None:
        import torch.nn.functional as F
        x, *weights, epi = args
        c1, ci = w_s1.shape[1], w_s1.shape[2]
        w = w_s1.reshape(3, 3, c1, ci).permute(2, 3, 0, 1)
        acc = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(
            0, 2, 3, 1).float()
        q1 = mod.stage_plain(acc, epi[17:21], alpha=kw["alpha"],
                             cast_bf16=kw["cast_bf16"], fast=kw["fast"])
        args = (q1, *weights, epi[:17])
    return getattr(mod, f"{name}_plain")(
        *args, **kw, sums=lambda q, w_t, k, st: int8_sums(torch, q, w_t, st))


def region_chain(torch, args, kw, epi):
    """The region's function as the unfused chain of the port's own
    kernels (stride-2 -> 1x1 -> 3x3 + residual -> stride-2), with the
    exact epilogue table `epi`; returns a function of no arguments."""
    from yolov3_tpu_torch.ops.kernels import (conv3x3_q, down_conv_q,
                                              pointwise_q)
    x, w_s2, w_pw, w_fb0, w_ex, _ = args
    c, cm, co = w_s2.shape[1], w_pw.shape[1], w_ex.shape[1]
    rows = {i: epi[i:i + 3, :n].contiguous()
            for i, n in ((13, c), (0, cm), (4, c), (9, co))}
    inv = {i: float(epi[i, 0]) for i in (3, 7, 8, 12, 16)}
    a, cast = dict(alpha=kw["alpha"]), kw["cast_bf16"]

    def run():
        q2 = down_conv_q.down_conv_block_q(
            x, w_s2, rows[13], inv_in=kw["inv_in"], inv_next=inv[16],
            cast_bf16=cast, **a)
        q3 = pointwise_q.pointwise_conv_block_q(q2, w_pw, rows[0], inv_in=1.0,
                                                inv_next=inv[3], **a)
        y = conv3x3_q.conv3x3_block_q(
            q3, w_fb0, rows[4], inv_in=1.0, inv_next=0.0, cast_bf16=cast,
            residual_q=q2, res_scale=inv[7], emit_s8=False,
            out_dtype=torch.bfloat16, **a)
        return down_conv_q.down_conv_block_q(
            y, w_ex, rows[9], inv_in=inv[8], inv_next=inv[12],
            cast_bf16=cast, **a)

    return run


def phase_region_kernels(torch, calls, exact_epi):
    """Every recorded stem-region launch (region, tail, exit) against its
    plain version on the serving inputs (s8 within 1 code, and the share
    of codes that differ; the exit, on the wgmma core, exactly); each
    against its first design (the region's and the tail's `_mma` twin,
    the exit's WMMA twin): 0 codes may differ. The kernel's (and the
    twin's, in turns: twin, kernel, kernel, twin) and the library's device
    times, the plain version's event time, beside the bound (and the
    exit's tile plan); for the region also the unfused chain of kernels
    7, 5, 6 and 7 on the same input. A region launch in a mode (affine2,
    rawimg) is a row of its own, `s2d_region_q.variant`'s name, equal to
    its plain version code for code, but for a bf16 image's rawimg: stem1
    on the tensor cores sums in the hardware's order, so within
    TC_CODES code on TC_SHARE of the codes, the TPU kernel's class against
    its reference. The rawimg rows' twin is the mode with stem1 on CUDA
    cores (`_cores`), equal to the plain version code for code and timed
    in turns with the kernel; the same launch on the image in f32 (stem1
    on CUDA cores) is equal to its plain version code for code. The first
    design has no such mode."""
    from yolov3_tpu_torch.ops.kernels.s2d_region_q import variant
    summary = {}
    for name, args, kw, out in calls:
        key = name
        rawimg = kw.get("w_s1") is not None
        if name == "s2d_region_block_q":
            key = variant(kw.get("affine2", False), rawimg)
        tc = rawimg and args[0].dtype == torch.bfloat16
        mod = int8_module(name)
        kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        want = plain(*args, **kw)
        code, differ, total, _ = int8_compare(torch, out, want)
        exact = name in WGMMA_KERNELS or (key in REGION_MODES and not tc)
        if code > (TC_CODES if tc else 1) or (exact and differ) or (
                tc and differ > TC_SHARE * total):
            raise AssertionError(f"{key}: {differ} s8 codes differ from the "
                                 f"plain version, by up to {code}")
        lib_c, lib_differ, _, _ = int8_compare(
            torch, region_library(torch, name, args, kw), want)
        extra = {}
        # the first design: the region's and the tail's `_mma`, the exit's
        # WMMA twin
        twin = (getattr(mod, f"{name}_mma", None)
                or getattr(mod, f"{name}_wmma", None))
        # the first design takes the region's arguments but its modes
        twin_kw = {k: v for k, v in kw.items()
                   if k not in ("affine2", "w_s1")}
        twin_ref = out
        if key in REGION_MODES:
            twin = mod.s2d_region_block_q_cores if rawimg else None
            twin_kw, twin_ref = kw, want
        if name in WGMMA_KERNELS:
            extra["plan"] = list(launch_plan(name, args))
        if rawimg:
            # the image in f32: stem1 on CUDA cores, code for code
            f32_args = (args[0].float(), *args[1:])
            f32_kw = dict(kw, w_s1=kw["w_s1"].float())
            f_code, f_differ, _, _ = int8_compare(
                torch, kern(*f32_args, **f32_kw), plain(*f32_args, **f32_kw))
            if f_differ:
                raise AssertionError(f"{key} on an f32 image: {f_differ} "
                                     f"codes differ from the plain version "
                                     f"(max {f_code})")
            extra["f32_image_codes_differing"] = 0
        if twin is not None:
            t_code, t_differ, _, _ = int8_compare(torch, twin_ref,
                                                  twin(*args, **twin_kw))
            if t_differ:
                raise AssertionError(f"{key}: {t_differ} codes differ from "
                                     f"the first design (max {t_code})")
            ms, extra["previous_ms"] = turns_ms(
                lambda: twin(*args, **twin_kw), lambda: kern(*args, **kw))
        else:
            ms = device_ms(lambda: kern(*args, **kw))
        plan_s = f", plan {tuple(extra['plan'])}" if "plan" in extra else ""
        event = cuda_ms(lambda: kern(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 2, 1)
        lib = device_ms(lambda: region_library(torch, name, args, kw), 5, 2)
        lib_event = cuda_ms(lambda: region_library(torch, name, args, kw), 5)
        nbytes, ops, f32_ops, bf16_ops = region_work(name, args, kw)
        b_ms, b_by = bound(nbytes, ops, INT8_OPS_S, f32_ops, bf16_ops)
        row = dict(shape=f"{tuple(args[0].shape)}->{tuple(out.shape)}",
                   x_dtype=str(args[0].dtype), f32_ops=f32_ops,
                   bf16_ops=bf16_ops,
                   fast=kw.get("fast", False), mode=key, ms=ms,
                   event_ms=event,
                   plain_ms=plain_ms,
                   library_ms=lib, library_event_ms=lib_event, bound_ms=b_ms,
                   bound_by=b_by,
                   bytes=nbytes, ops=ops, max_abs_err=float(code),
                   codes_differing=differ / total,
                   library_codes_differing=lib_differ / total, **extra)
        old_s = (f", first design {extra['previous_ms']:.4f} ms (0 codes "
                 f"differ{' from plain' if rawimg else ''})"
                 if "previous_ms" in extra else "")
        log(f"{key} {row['shape']} fast={row['fast']}: kernel {ms:.4f} ms "
            f"(events {event:.4f}){old_s}{plan_s}, "
            f"plain {plain_ms:.4f} ms, library {lib:.4f} ms (events "
            f"{lib_event:.4f}), bound "
            f"{b_ms:.4f} ms ({b_by}), {ops / ms / 1e9:.1f} TOP/s; vs plain "
            f"max code diff {code}, {100 * differ / total:.4f}% of {total} "
            f"codes differ (library {lib_c}, {lib_differ})")
        if key == "s2d_region_block_q":
            chain = region_chain(torch, args, kw, exact_epi)
            exact = kern(*args[:-1], exact_epi, **dict(kw, fast=False))
            c_code, c_differ, _, _ = int8_compare(torch, chain(), exact)
            f_code, f_differ, _, _ = int8_compare(torch, out, exact)
            row.update(chain_ms=device_ms(chain),
                       exact_ms=device_ms(lambda: kern(
                           *args[:-1], exact_epi, **dict(kw, fast=False))),
                       chain_vs_exact_codes=c_differ / total,
                       fast_vs_exact_max=f_code,
                       fast_vs_exact_codes=f_differ / total)
            log(f"  the unfused chain 7->5->6->7 on the same input "
                f"{row['chain_ms']:.4f} ms ({100 * c_differ / total:.4f}% "
                f"of codes differ from the exact region, max {c_code}); "
                f"exact region {row['exact_ms']:.4f} ms; fast vs exact max "
                f"{f_code}, {100 * f_differ / total:.4f}% of codes")
            # the bf16 input quantized by PyTorch first, then the kernel on
            # the s8 codes: the same codes out
            from yolov3_tpu_torch.ops.quant import quantize_act

            def s8_route():
                q1 = quantize_act(args[0], kw["inv_in"])
                return kern(q1, *args[1:], **dict(kw, inv_in=None))

            s_code, _, _, _ = int8_compare(torch, s8_route(), out)
            if s_code:
                raise AssertionError(f"region on s8 codes differs from the "
                                     f"region on floats by {s_code}")
            row["quantize_then_s8_ms"] = device_ms(s8_route)
            log(f"  PyTorch's quantize, then the region on the s8 codes: "
                f"{row['quantize_then_s8_ms']:.4f} ms (equal codes)")
        summary[key] = row
    return summary


def phase_cli_int8(torch, inf, TQ, path, workdir):
    """The --int8 CLI's per-batch step: z-score on the card, calibrate on
    the batch, the fused serving function, rows per image; both CSVs."""
    import numpy as np
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, FULL["img_size"], dtype=np.uint8)
              for _ in range(3)]
    batch = zscore_images(torch.from_numpy(np.stack(images)).to(DEVICE))
    serve, _, _ = TQ.make_quantized_serving_fn(path, batch, device=DEVICE)
    rows, scores = inf.serve_batch(serve, batch, 4)
    check_csvs(inf, rows, scores, workdir, "int8")
    n = [r.shape[0] for r in rows]
    log(f"CLI --int8 per-batch function: 3 images padded to 4, rows per "
        f"image {n}, CSVs ok")
    return n


def check_csvs(inf, rows, scores, workdir, tag):
    for i, (r, s) in enumerate(zip(rows, scores)):
        for save_scores, header in ((False, "X,Y,W,H,C"),
                                    (True, "X,Y,W,H,P,C")):
            out = os.path.join(workdir, f"{tag}_im{i}_{int(save_scores)}.csv")
            inf.write_detections_csv(r, s, out, save_scores)
            with open(out) as fh:
                lines = fh.read().splitlines()
            if lines[0] != header or len(lines) != r.shape[0] + 1:
                raise AssertionError(f"bad CSV {out}: {lines[:2]}")


def phase_int8_ab(torch, serves, images, card, reps=10):
    """The full-model int8 A/B of the region modes: device ms per b8
    serving call (profiled, 3 calls) of the default set and of each mode's
    set, in turns (the sets in order, then in reverse), and host-clock ms
    per call over `reps` calls, in the same turns."""
    order = list(serves)
    dev, wall = {n: [] for n in order}, {n: [] for n in order}
    for n in order + order[::-1]:
        dev[n].append(phase_profile(torch, serves[n], images,
                                    top=0)["device_ms"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            serves[n](images)
        torch.cuda.synchronize()
        wall[n].append((time.perf_counter() - t0) / reps * 1e3)
    out = {}
    for n in order:
        out[n] = {"device_ms": dev[n], "wall_ms": wall[n]}
        log(f"int8 A/B {n}: device {dev[n][0]:.4f} / {dev[n][1]:.4f} ms "
            f"per b{BATCH} call, wall {wall[n][0]:.3f} / {wall[n][1]:.3f} "
            f"ms, in turns, on {card}")
    return out


def greedy_nms_stable(boxes, scores, iou_threshold):
    """The host's greedy NMS (`ops/boxes.py::single_class_nms`) with the
    device's order among tied scores: descending, the lower index first
    (a stable sort, as lax.top_k orders). Returns the kept indices."""
    import numpy as np
    from yolov3_tpu_torch.ops.boxes import compute_iou
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        order = order[1:]
        if order.size:
            iou = compute_iou(boxes[i], boxes[order], areas[i], areas[order])
            order = order[iou <= iou_threshold]
    return keep


def nms_agreement(torch, tiled, detect, cfg, tiles, icfg):
    """Device NMS against host NMS on every tile and class of `tiles`, the
    device's candidates uncapped: (tile-classes, equal to the host's
    reference NMS, equal once the host takes the device's order among
    tied scores). The second must be all of them; the first differs
    only where a tie in score falls to another box first (the device
    keeps the lower index first, as lax.top_k; the reference's host NMS
    takes numpy's reversed argsort)."""
    import numpy as np
    from yolov3_tpu_torch.ops import boxes as bbox
    from yolov3_tpu_torch.ops.nms import batched_nms_device, nms_to_host
    total = equal = 0
    for start in range(0, len(tiles), TILED_BATCH):
        chunk = tiles[start:start + TILED_BATCH]
        dets = detect(tiled.zscore_tiles(chunk, DEVICE))
        out = [o.cpu().numpy() for o in batched_nms_device(
            dets, cfg.number_classes, iou_threshold=icfg.iou_threshold,
            score_threshold=icfg.score_threshold,
            max_boxes=icfg.max_boxes_per_class,
            min_box_size=float(icfg.min_box_size))]
        dets = dets.float().cpu().numpy()
        for k in range(len(chunk)):
            det = bbox.filter_small_boxes(dets[k], icfg.min_box_size)
            host = bbox.per_class_nms(det[:, 0:4], det[:, 4:5], det[:, 5:],
                                      iou_threshold=icfg.iou_threshold,
                                      score_threshold=icfg.score_threshold)
            dev = nms_to_host(out[0][k], out[1][k], out[2][k])
            scores = np.sqrt(det[:, 5:] * det[:, 4:5])
            for c in range(cfg.number_classes):
                total += 1
                h, d = (np.zeros((0, 4), np.float32) if r[0] is None
                        else r[0][r[2] == c] for r in (host, dev))
                sel = np.where(scores[:, c] >= icfg.score_threshold)[0]
                stable = det[sel][greedy_nms_stable(
                    det[sel, 0:4], scores[sel, c], icfg.iou_threshold), 0:4]
                if not (stable.shape == d.shape and np.array_equal(stable,
                                                                   d)):
                    raise AssertionError(
                        f"tile {start + k} class {c}: device NMS keeps "
                        f"{d.shape[0]} boxes, the host's greedy rule in "
                        f"the same order {stable.shape[0]}")
                equal += int(h.shape == d.shape and np.array_equal(h, d))
    return total, equal


def phase_tiled(torch, TQ, inf, path, workdir, card):
    """The tiled CLI on a seeded 2048 x 1536 image (512 px tiles, 96 px
    ghost zones, 35 tiles in batches of 8), bf16 and --int8 (calibrated on
    the first 8 tiles, as the CLI does): tiles/s (host clock, per image,
    after one warm-up image), the CSV, and host against device NMS."""
    import numpy as np
    from yolov3_tpu_torch import inference_tiled as tiled
    from yolov3_tpu_torch.config import InferenceConfig
    from yolov3_tpu_torch.ops import boxes as bbox
    from yolov3_tpu_torch.utils.tiling import convert_image_to_tiles
    img = np.random.default_rng(6).integers(0, 256, TILED_IMAGE,
                                            dtype=np.uint8)
    size = tuple(FULL["img_size"][:2])
    tiles, _, _ = convert_image_to_tiles(img, size, 96)
    zone = [t - 2 * 96 for t in size]
    want = math.ceil(img.shape[0] / zone[0]) * math.ceil(img.shape[1] /
                                                         zone[1])
    if len(tiles) != want:
        raise AssertionError(f"{len(tiles)} tiles, not {want}")
    detect_b, cfg = inf.make_detector_fn(path, device=DEVICE)
    detect_q, _ = TQ.make_quantized_detector_fn(
        path, tiled.zscore_tiles(tiles[:8], DEVICE), device=DEVICE)
    out = {}
    for label, detect in (("bf16", detect_b), ("int8", detect_q)):
        def run():
            return tiled.inference_image_tiled(
                detect, cfg.number_classes, img, size, 32,
                batch_size=TILED_BATCH, edge_range=96, device=DEVICE)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = run()
        dt = time.perf_counter() - t0
        csv = os.path.join(workdir, f"tiled_{label}.csv")
        bbox.write_boxes_from_ltrbpc(pred, csv)
        with open(csv) as fh:
            lines = fh.read().splitlines()
        ok = (lines[0] == "X,Y,W,H,P,C" and len(lines) == pred.shape[0] + 1
              and pred.shape[0] > 0 and np.isfinite(pred).all()
              and (pred[:, 0:4] >= 0).all()
              and (pred[:, [0, 2]] < TILED_IMAGE[1]).all()
              and (pred[:, [1, 3]] < TILED_IMAGE[0]).all())
        if not ok:
            raise AssertionError(f"tiled {label}: bad CSV {lines[:2]}, "
                                 f"{pred.shape[0]} rows")
        icfg = InferenceConfig(min_box_size=32,
                               max_boxes_per_class=cfg.number_output_boxes)
        total, equal = nms_agreement(torch, tiled, detect, cfg, tiles,
                                     icfg)
        out[label] = dict(tiles=len(tiles), seconds=dt,
                          tiles_per_s=len(tiles) / dt, rows=pred.shape[0],
                          nms_classes=total, nms_equal_reference=equal)
        log(f"tiled CLI {label}: {len(tiles)} tiles of {size} in "
            f"{dt * 1e3:.1f} ms, {len(tiles) / dt:.2f} tiles/s, "
            f"{pred.shape[0]} rows, CSV ok; device NMS (uncapped) equal to "
            f"the host's greedy rule in its tie order on all {total} "
            f"tile-classes, to the reference's host NMS on {equal} (the "
            f"rest differ in tied scores' order), on {card}")
    return out


def phase_cli(torch, inf, InferenceConfig, path, workdir):
    import numpy as np
    detect, cfg = inf.make_detector_fn(path, device=DEVICE)
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, cfg.img_size, dtype=np.uint8)
              for _ in range(4)]
    rows, scores = inf.detect_images(images, detect, cfg.number_classes,
                                     InferenceConfig(), 32, device=DEVICE)
    check_csvs(inf, rows, scores, workdir, "bf16")
    n = [r.shape[0] for r in rows]
    log(f"CLI per-batch function: 4 images, rows per image {n}, CSVs ok")
    return n


def plant_store(path, n, seed):
    """`n` seeded 512 x 512 x 3 uint8 images of dark noise, each with 1-4
    rectangles of the two classes (red, green), 48-200 px a side, and
    their boxes, written with the port's `RecordWriter`."""
    import numpy as np
    from yolov3_tpu_torch.data import records
    from yolov3_tpu_torch.data.store import RecordWriter
    rng = np.random.default_rng(seed)
    h, w, _ = FULL["img_size"]
    with RecordWriter(path) as writer:
        for i in range(n):
            img = rng.integers(0, 96, (h, w, 3), dtype=np.uint8)
            boxes = []
            for _ in range(rng.integers(1, 5)):
                bw, bh = rng.integers(TRAIN_RECT[0], TRAIN_RECT[1] + 1, 2)
                x, y = rng.integers(0, w - bw + 1), rng.integers(0, h - bh + 1)
                c = int(rng.integers(0, 2))
                img[y:y + bh, x:x + bw] = (220, 40, 40) if c == 0 else (
                    40, 220, 40)
                boxes.append([x, y, bw, bh, c])
            boxes = np.asarray(boxes, np.int32)
            writer.put(records.make_record_key(i, f"img{i}", boxes),
                       records.encode_record(img, boxes))


def store_examples(path, n, anchors):
    """The first `n` records of a store: their uint8 images, and the
    train step's batch (z-scored images, three label grids), in numpy."""
    import numpy as np
    from yolov3_tpu_torch.data import records
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.data.imaging import zscore_normalize
    from yolov3_tpu_torch.data.store import RecordReader
    with RecordReader(path) as reader:
        pairs = [records.decode_record(reader.get(k))
                 for k in reader.keys()[:n]]
    raw = np.stack([img for img, _ in pairs])
    grids = [encode_boxes(b, raw.shape[1:], anchors, 2) for _, b in pairs]
    batch = [np.stack([zscore_normalize(img) for img, _ in pairs])] + [
        np.stack([g[i] for g in grids]) for i in range(3)]
    return raw, batch


def train_flops(torch, cfg):
    """Conv FLOPs of one image's forward (2 per multiply-add of the taps
    inside the image), from the shapes `conv2d_same` receives in the
    train-mode forward (every conv goes through it there)."""
    from yolov3_tpu_torch.models import yolo
    calls = []
    orig = record(yolo, "conv2d_same", calls)
    try:
        model = yolo.YoloV3(cfg).to(DEVICE).train()
        with torch.no_grad():
            model(torch.zeros((1, *cfg.img_size), device=DEVICE))
    finally:
        yolo.conv2d_same = orig
    macs = 0
    for (x, w, _, stride), _ in calls:
        macs += conv_macs(1, x.shape[1], x.shape[2], w.shape[1], w.shape[0],
                          w.shape[-1], stride)
    return 2 * macs


def phase_train_step(torch, ModelConfig, batch, card):
    """ms/step of the train step on a resident batch, peak memory, the
    profile of one step, train_mfu; then 30 steps on one batch at lr
    1e-4, whose loss must fall."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.parallel.train_step import (create_train_state,
                                                      make_train_step)
    cfg = ModelConfig(**FULL)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, tcfg, SEED, DEVICE)
    step = make_train_step(cfg, tcfg, TRAIN_BATCH)
    lr = tcfg.learning_rate
    for _ in range(3):
        step(state, batch, lr)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timed = 10
    start.record()
    for _ in range(timed):
        step(state, batch, lr)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    peak = torch.cuda.max_memory_allocated()
    profile = phase_profile(torch, lambda _: step(state, batch, lr), None,
                            reps=1, what="train steps")
    flops = train_flops(torch, cfg)
    mfu = 3 * flops * TRAIN_BATCH / (ms * 1e-3 * BF16_OPS_S)
    out = {"card": card, "batch": TRAIN_BATCH, "ms_per_step": ms,
           "images_per_s": TRAIN_BATCH / (ms * 1e-3),
           "max_memory_allocated": peak, "forward_flops_per_image": flops,
           "train_mfu": mfu, "profile": profile}
    log(f"train step b{TRAIN_BATCH} 512px bf16: {ms:.3f} ms/step, "
        f"{out['images_per_s']:.2f} images/s, peak {peak / 2**30:.2f} GiB, "
        f"train_mfu {mfu:.4f} ({flops / 1e9:.2f} GFLOP forward per image), "
        f"on {card}")
    del state

    state = create_train_state(cfg, tcfg, SEED, DEVICE)
    losses = []
    for _ in range(30):
        _, metrics = step(state, batch, 1e-4)
        losses.append(float(metrics["loss"]))
    del state
    learn = {"card": card, "lr": 1e-4,
             "loss_at": {i: losses[i] for i in (0, 10, 20, 29)}}
    log(f"train 30 steps on one batch: loss {learn['loss_at']}")
    if not (all(math.isfinite(v) for v in losses)
            and losses[29] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")
    return out, learn


def graph_batches(torch, batch, n):
    """`n` batches from one: the images plus seeded noise, the labels
    rolled over the batch."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = []
    for k in range(n):
        noise = torch.randn(batch[0].shape, generator=gen, device=DEVICE)
        out.append([batch[0] + 0.25 * k * noise]
                   + [g.roll(k, 0) for g in batch[1:]])
    return out


def step_state(torch, state):
    """Copies of the model's state_dict and Adam's state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return {k: v.detach().clone() for k, v in out.items()}


def run_steps(torch, T, cfg, tcfg, batches, lrs, eager):
    """Steps on `batches` at `lrs` from `init_train_params(cfg, SEED)`;
    `eager` keeps the step off the graph. (state, losses, {counter:
    steps})."""
    from yolov3_tpu_torch.utils import tracing
    state = T.create_train_state(cfg, tcfg, SEED, DEVICE)
    step = T.make_train_step(cfg, tcfg, batches[0][0].shape[0])
    graphable = T.graphable
    if eager:
        T.graphable = lambda model, group=None: False
    tracing.clear()
    try:
        with tracing.recording():
            losses = [float(step(state, b, lr)[1]["loss"])
                      for b, lr in zip(batches, lrs)]
        counts = tracing.counters()
    finally:
        T.graphable = graphable
        tracing.clear()
    return state, losses, counts


def graph_modes(torch, T, ModelConfig, batch, card):
    """QAT, static QAT (scales 1.0) and `remat_blocks` at FULL on `batch`
    (bf16): three steps replayed (warm-up, capture, replay) against three
    eager ones from the same state, bit for bit, cuDNN deterministic."""
    from yolov3_tpu_torch.config import TrainConfig
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    batches = graph_batches(torch, batch, 3)
    out = {}
    for name, flags in (("int8_train", {"int8_train": True}),
                        ("int8_train_static", {"int8_train": True,
                                               "int8_train_static": True}),
                        ("remat_blocks", {"remat_blocks": True})):
        cfg = ModelConfig(**FULL, **flags)
        runs = {}
        for eager in (True, False):
            state, losses, counts = run_steps(torch, T, cfg, tcfg, batches,
                                              [1e-4] * 3, eager)
            runs[eager] = losses, step_state(torch, state), counts
            del state
            torch.cuda.empty_cache()
        (le, te, _), (lg, tg, cg) = runs[True], runs[False]
        differ = [k for k in te if not torch.equal(te[k], tg[k])]
        out[name] = {"counts": cg, "losses": lg, "loss_equal": le == lg,
                     "tensors": len(te), "tensors_differing": len(differ),
                     "first_differing": differ[:3]}
        del runs, te, tg
    log(f"train graph modes b{TRAIN_BATCH} on {card}: {out}")
    return out


def phase_train_graph(torch, ModelConfig, batch, card):
    """The train step replayed as one CUDA graph, at FULL (bf16, b16):
    five replayed steps bit-equal to five eager steps with the same
    capturable Adam from the same state and batches (cuDNN deterministic:
    loss, parameters, BatchNorm statistics, moments), and the same for
    QAT, static QAT and remat over three steps (`graph_modes`); the
    capturable Adam's update against the plain one's on one eager step's
    gradients, each leaf within GRAD_BOUND of its largest; the loss
    falling over 30 replayed steps on one batch; ms a step eager and
    replayed in turns, and the peak memory allocated while each ran."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.parallel import train_step as T
    cfg = ModelConfig(**FULL)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    batches = graph_batches(torch, batch, 5)
    lrs = [tcfg.learning_rate * (k + 1) / 5 for k in range(5)]
    out = {"card": card}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for eager in (True, False):
            state, losses, counts = run_steps(torch, T, cfg, tcfg, batches,
                                              lrs, eager)
            runs[eager] = losses, step_state(torch, state), counts
            del state
            torch.cuda.empty_cache()
        (le, te, ce), (lg, tg, cg) = runs[True], runs[False]
        differ = [k for k in te if not torch.equal(te[k], tg[k])]
        out["bit_equal"] = {"losses_eager": le, "losses_replayed": lg,
                            "counts_eager": ce, "counts_replayed": cg,
                            "tensors": len(te),
                            "tensors_differing": len(differ),
                            "first_differing": differ[:5]}
        del runs, te, tg

        # Adam's update alone: each optimizer steps zero parameters that
        # hold one eager step's gradients (a parameter near 1 would round
        # the update to its ulps)
        state, _, _ = run_steps(torch, T, cfg, tcfg, batches[:1], lrs[:1],
                                True)
        grads = {n: p.grad.detach().clone()
                 for n, p in state.model.named_parameters()}
        del state
        updates = {}
        for name in ("capturable", "plain"):
            shadow = {n: torch.zeros_like(g, requires_grad=True)
                      for n, g in grads.items()}
            for n, p in shadow.items():
                p.grad = grads[n].clone()
            kw = dict(betas=(tcfg.adam_b1, tcfg.adam_b2), eps=tcfg.adam_eps)
            if name == "capturable":
                kw.update(lr=torch.full((), lrs[0], device=DEVICE),
                          capturable=True)
            else:
                kw.update(lr=lrs[0])
            torch.optim.Adam(list(shadow.values()), **kw).step()
            updates[name] = {n: p.detach() for n, p in shadow.items()}
        worst, at = 0.0, None
        for n, want in updates["plain"].items():
            err = float((updates["capturable"][n] - want).abs().max()
                        / (want.abs().max() or 1.0))
            if err > worst:
                worst, at = err, n
        out["adam"] = {"worst_update_err_rel_leaf_max": worst, "at": at,
                       "bound": GRAD_BOUND}
        del grads, updates, shadow
        out["modes"] = graph_modes(torch, T, ModelConfig, batch, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()

    state, losses, counts = run_steps(torch, T, cfg, tcfg, [batch] * 30,
                                      [1e-4] * 30, False)
    del state
    out["learns"] = {"lr": 1e-4, "counts": counts,
                     "loss_at": {i: losses[i] for i in (0, 10, 20, 29)}}
    torch.cuda.empty_cache()

    # ms a step in turns on one state: eager, replayed, replayed, eager
    state = T.create_train_state(cfg, tcfg, SEED, DEVICE)
    step = T.make_train_step(cfg, tcfg, TRAIN_BATCH)
    graphable = T.graphable
    timed, ms, peaks = 10, {"eager": [], "replayed": []}, {}
    try:
        for mode in ("eager", "replayed", "replayed", "eager"):
            if mode == "eager":
                T.graphable = lambda model, group=None: False
            for _ in range(3):
                step(state, batch, 1e-4)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(timed):
                _, metrics = step(state, batch, 1e-4)
                float(metrics["loss"])
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) / timed * 1e3)
            peaks[mode] = torch.cuda.max_memory_allocated()
            T.graphable = graphable
    finally:
        T.graphable = graphable
    del state, step
    torch.cuda.empty_cache()
    out["ms_per_step"] = ms
    out["peak_bytes"] = peaks
    b = out["bit_equal"]
    log(f"train graph b{TRAIN_BATCH} 512px bf16 on {card}: replayed vs "
        f"eager {b['tensors_differing']} of {b['tensors']} tensors differ, "
        f"losses {b['losses_replayed']} vs {b['losses_eager']}; capturable "
        f"vs plain Adam worst leaf {out['adam']['worst_update_err_rel_leaf_max']:.3e} "
        f"({out['adam']['at']}); 30 replayed steps {out['learns']}; ms a "
        f"step (loss read each step) eager {ms['eager']} replayed "
        f"{ms['replayed']}; peak {peaks}")
    if not (b["tensors_differing"] == 0
            and b["losses_eager"] == b["losses_replayed"]
            and b["counts_replayed"] == {"step.eager": 1.0,
                                         "step.replayed": 4.0}
            and out["adam"]["worst_update_err_rel_leaf_max"] <= GRAD_BOUND
            and all(m["tensors_differing"] == 0 and m["loss_equal"]
                    and m["counts"] == {"step.eager": 1.0,
                                        "step.replayed": 2.0}
                    for m in out["modes"].values())
            and all(math.isfinite(v) for v in losses)
            and losses[29] < losses[0]
            and counts == {"step.eager": 1.0, "step.replayed": 29.0}):
        raise AssertionError(f"train graph gate: {out}")
    return out


def phase_trainer(torch, workdir, card, overrides=None, name="train_out"):
    """`train.train_model` on the planted store, end to end, with the 1x1
    kernel and the model `overrides` (QAT's flags)."""
    from yolov3_tpu_torch import train
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    out_dir = os.path.join(workdir, name)
    report = {}
    t0 = time.perf_counter()
    export = train.train_model(
        TRAIN_BATCH, TRAIN_EVERY, os.path.join(workdir, "train.ydb"),
        os.path.join(workdir, "test.ydb"), out_dir, early_stopping_count=10,
        learning_rate=1e-4, use_augmentation=True, anchors=FULL["anchors"],
        seed=SEED, max_epochs=TRAIN_EPOCHS, compute_dtype="bfloat16",
        model_overrides=dict(overrides or {}, use_pallas_pointwise=True),
        device=DEVICE, report=report)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "test_loss.csv")) as fh:
        test_loss = [float(v) for v in fh if v.strip()]
    out = {"card": card, "wall_s": wall, "train_steps": report["train_steps"],
           "steps_per_s_with_feed": report["train_steps"] / report["train_s"],
           "feed_wait_share": report["feed_wait_s"] / report["train_s"],
           "test_loss": test_loss, "recalibrations": report["recalibrations"],
           "checkpoint": ckpt.has_checkpoint(out_dir),
           "export": export is not None and os.path.exists(
               os.path.join(export, ckpt.WEIGHTS_FILE))}
    log(f"trainer: {out['train_steps']} steps in {report['train_s']:.2f} s "
        f"of train loops ({out['steps_per_s_with_feed']:.3f} steps/s with "
        f"the feed, {100 * out['feed_wait_share']:.1f}% waiting for "
        f"batches), test_loss.csv {test_loss}, wall {wall:.1f} s")
    if not (len(test_loss) == TRAIN_EPOCHS
            and all(math.isfinite(v) for v in test_loss)
            and out["checkpoint"] and out["export"]
            and out["train_steps"] == TRAIN_EPOCHS * (TRAIN_EVERY + 1)):
        raise AssertionError(f"trainer run incomplete: {out}")
    return export, out


def phase_train_served(torch, inf, TQ, build, export, workdir, card):
    """The trainer's export served in bf16 (the 1x1 kernel) and int8 (the
    default kernel set) on 8 test images, with the serving phases'
    launch counts; the int8 fidelity against bf16."""
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    raw, _ = store_examples(os.path.join(workdir, "test.ydb"), BATCH,
                            FULL["anchors"])
    images = zscore_images(torch.from_numpy(raw).to(DEVICE))
    serve, _ = inf.make_serving_fn(export, device=DEVICE)
    serve_q, _, _ = TQ.make_quantized_serving_fn(export, images,
                                                 device=DEVICE)
    out = {"card": card}
    for label, fn, expected in (("bf16", serve, EXPECTED_LAUNCHES),
                                ("int8", serve_q, EXPECTED_INT8_LAUNCHES)):
        build.launch_counts.clear()
        boxes, scores, keep = fn(images)
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        if launches != expected:
            raise AssertionError(f"trained export {label}: launches "
                                 f"{launches} != {expected}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError(f"trained export {label}: output not finite")
        out[label] = {"launches": launches, "kept": int(keep.sum())}
    detect_f, _ = inf.make_detector_fn(export, device=DEVICE)
    detect_q, _ = TQ.make_quantized_detector_fn(export, images,
                                                device=DEVICE)
    out["int8_fidelity"] = TQ.decode_iou_fidelity(
        detect_f(images).float().cpu().numpy(),
        detect_q(images).float().cpu().numpy(), top_k=20)
    log(f"trained export served on {BATCH} test images: bf16 "
        f"{out['bf16']}, int8 {out['int8']}, int8 vs bf16 fidelity "
        f"{out['int8_fidelity']:.6f}")
    return out


def phase_train_reference(torch, ModelConfig, card, **overrides):
    """One f32 train-step's gradients at 64 px on the card against the
    CPU's, the same seeded weights and batch, TF32 off; `overrides` (QAT's
    flags) on the model config."""
    import numpy as np
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.parallel import train_step as T
    cfg = ModelConfig(**dict(FULL, img_size=(64, 64, 3), block_count=1,
                             filter_count=32, compute_dtype="float32",
                             anchors=((16, 16), (32, 32)),
                             use_pallas_pointwise=False, **overrides))
    rng = np.random.default_rng(SEED)
    images = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    grids = [encode_boxes(np.array([[8 + 20 * b, 8, 20, 24, b],
                                    [30, 30, 28, 16, 1]]), cfg.img_size,
                          cfg.anchors, 2) for b in range(2)]
    batch = [images] + [np.stack([g[i] for g in grids]) for i in range(3)]
    grads, losses = [], []
    for device in ("cpu", DEVICE):
        state = T.create_train_state(cfg, TrainConfig(), SEED, device)
        b = [torch.from_numpy(a).to(device) for a in batch]
        loss, _ = T._loss(state.model, cfg, TrainConfig(), 2, b[0], b[1:])
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().cpu()
                      for n, p in state.model.named_parameters()})
    worst = max(float((grads[1][n] - g).abs().max() / g.abs().max())
                for n, g in grads[0].items())
    out = {"card": card, "loss_cpu": losses[0], "loss_card": losses[1],
           "worst_grad_err_rel_leaf_max": worst, "bound": GRAD_BOUND,
           "overrides": overrides}
    log(f"f32 train step 64px {overrides} card vs CPU: loss {losses[1]} vs "
        f"{losses[0]}, "
        f"worst gradient leaf error {worst:.3e} of its largest |g| (bound "
        f"{GRAD_BOUND})")
    # QAT's loss: the CPU tests' 1e-4 (a code on a .5 boundary may round
    # either way)
    loss_rtol = 1e-4 if overrides else 1e-5
    if not (worst <= GRAD_BOUND
            and abs(losses[1] - losses[0]) <= loss_rtol * abs(losses[0])):
        raise AssertionError(f"card gradients disagree with the CPU: {out}")
    return out


def phase_training(torch, inf, TQ, build, ModelConfig, workdir, card):
    """Phase 9: the training slice at full width; one JSON line each."""
    t0 = time.perf_counter()
    for name, n in TRAIN_STORE.items():
        plant_store(os.path.join(workdir, f"{name}.ydb"), n,
                    SEED + (name == "test"))
    log(f"planted stores written in {time.perf_counter() - t0:.1f} s")
    _, batch = store_examples(os.path.join(workdir, "train.ydb"),
                              TRAIN_BATCH, FULL["anchors"])
    batch = [torch.from_numpy(a).to(DEVICE) for a in batch]
    step, learn = phase_train_step(torch, ModelConfig, batch, card)
    graph = phase_train_graph(torch, ModelConfig, batch, card)
    del batch
    torch.cuda.empty_cache()
    export, trainer = phase_trainer(torch, workdir, card)
    served = phase_train_served(torch, inf, TQ, build, export, workdir, card)
    reference = phase_train_reference(torch, ModelConfig, card)
    lines = {"train_step": step, "train_learns": learn,
             "train_graph": graph, "trainer": trainer,
             "train_export_served": served, "train_card_vs_cpu": reference}
    log(f"training phase took {time.perf_counter() - t0:.1f} s")
    return lines


def qat_state(torch, TQ, cfg, tcfg, images):
    """A fresh train state; under static QAT its scales calibrated on
    `images` (as the trainer does at an epoch's start)."""
    from yolov3_tpu_torch.parallel.train_step import create_train_state
    state = create_train_state(cfg, tcfg, SEED, DEVICE)
    if cfg.int8_train and cfg.int8_train_static:
        TQ.qat_recalibrator(cfg, DEVICE)(state.model, images)
    return state


def phase_qat_steps(torch, TQ, ModelConfig, batch, card):
    """The train step at FULL, b16, in the three modes: each mode's peak
    memory over what was allocated before its state (3 warm-up steps, the
    graph's capture among them), ms/step of the replayed step by CUDA
    events over 10 steps, in turns (plain, dynamic, static, static,
    dynamic, plain), and one profiled eager step, with the device time of
    `torch._int_mm` and of the whole `int8_conv_sums` (the im2col with
    it)."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.ops import quant
    from yolov3_tpu_torch.parallel import train_step as T
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    lr = tcfg.learning_rate
    runs, out = {}, {}
    for mode, kw in QAT_MODES.items():
        cfg = ModelConfig(**dict(FULL, **kw))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = qat_state(torch, TQ, cfg, tcfg, batch[0])
        step = T.make_train_step(cfg, tcfg, TRAIN_BATCH)
        for _ in range(3):
            step(state, batch, lr)
        torch.cuda.synchronize()
        runs[mode] = (state, step)
        out[mode] = {"peak_bytes": torch.cuda.max_memory_allocated() - base}
    times = {mode: [] for mode in QAT_MODES}
    for mode in list(QAT_MODES) + list(QAT_MODES)[::-1]:
        state, step = runs[mode]
        times[mode].append(cuda_ms(lambda: step(state, batch, lr), 10,
                                   warmup=1))
    orig, graphable = quant.int8_conv_sums, T.graphable

    def spanned(*args):
        with torch.profiler.record_function("int8_conv_sums"):
            return orig(*args)
    quant.int8_conv_sums = spanned
    # the profiled steps eager: a replay runs no host op to give kernels to
    T.graphable = lambda model, group=None: False
    try:
        for mode, (state, step) in runs.items():
            ms = sum(times[mode]) / len(times[mode])
            prof = phase_profile(torch, lambda _: step(state, batch, lr),
                                 None, reps=1, what=f"{mode} train steps",
                                 ops=("aten::_int_mm", "int8_conv_sums"))
            out[mode].update(ms_per_step=ms, ms_turns=times[mode],
                             images_per_s=TRAIN_BATCH / (ms * 1e-3),
                             profile=prof)
            log(f"train step {mode} b{TRAIN_BATCH} 512px bf16: {ms:.3f} "
                f"ms/step (turns {[round(t, 3) for t in times[mode]]}), "
                f"peak {out[mode]['peak_bytes'] / 2**30:.2f} GiB over "
                f"what was allocated before its state, on {card}")
    finally:
        quant.int8_conv_sums, T.graphable = orig, graphable
    del runs
    return dict(out, card=card, batch=TRAIN_BATCH)


def phase_qat_sums(torch, TQ, ModelConfig, batch):
    """One QAT train forward at FULL on one image: every STE conv's int32
    sums on the card (recorded at `ops/quant.py::int8_conv_sums`) equal
    the CPU's float64 sums of the same codes."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.models.yolo import ConvBlock
    from yolov3_tpu_torch.ops import quant
    cfg = ModelConfig(**dict(FULL, int8_train=True))
    state = qat_state(torch, TQ, cfg, TrainConfig(), None)
    calls, orig = [], quant.int8_conv_sums

    def recorded(q_x, q_w, stride):
        sums = orig(q_x, q_w, stride)
        calls.append((q_x.cpu(), q_w.cpu(), stride, sums.cpu()))
        return sums
    quant.int8_conv_sums = recorded
    try:
        with torch.no_grad():
            state.model(batch[0][:1])
    finally:
        quant.int8_conv_sums = orig
    want = sum(1 for m in state.model.modules()
               if isinstance(m, ConvBlock) and m.int8_ste)
    del state
    t0 = time.perf_counter()
    differ = [i for i, (q_x, q_w, stride, sums) in enumerate(calls)
              if not torch.equal(orig(q_x, q_w, stride), sums)]
    out = {"convs": len(calls), "ste_blocks": want, "differ": differ,
           "largest_abs_sum": max(int(c[3].abs().max()) for c in calls),
           "cpu_s": time.perf_counter() - t0}
    log(f"QAT int32 sums, one 512px image: {len(calls)} STE convs on the "
        f"card against the CPU's float64 sums, {len(differ)} differ "
        f"(largest |sum| {out['largest_abs_sum']}; CPU "
        f"{out['cpu_s']:.1f} s)")
    if differ or len(calls) != want:
        raise AssertionError(f"QAT sums: card and CPU disagree: {out}")
    return out


def phase_qat_learns(torch, TQ, ModelConfig, batch, card):
    """30 QAT steps on one batch at lr 1e-4 in each QAT mode (static:
    calibrated first): the loss finite and falling."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.parallel.train_step import make_train_step
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    out = {"card": card, "lr": 1e-4}
    for mode in ("dynamic", "static"):
        cfg = ModelConfig(**dict(FULL, **QAT_MODES[mode]))
        state = qat_state(torch, TQ, cfg, tcfg, batch[0])
        step = make_train_step(cfg, tcfg, TRAIN_BATCH)
        losses = [float(step(state, batch, 1e-4)[1]["loss"])
                  for _ in range(30)]
        del state
        out[mode] = {i: losses[i] for i in (0, 10, 20, 29)}
        log(f"QAT {mode} 30 steps on one batch: loss {out[mode]}")
        if not (all(math.isfinite(v) for v in losses)
                and losses[29] < losses[0]):
            raise AssertionError(f"QAT {mode}: the loss did not fall: "
                                 f"{losses}")
    return out


def phase_qat_trainer(torch, inf, TQ, build, workdir, card):
    """`train.train_model` with --int8_train 1, and with --int8_train 1
    --int8_static 1, two epochs of 9 steps each on phase 9's stores: one
    recalibration an epoch (static), every checkpointed scale finite and
    > 0 under `calibrate`'s keys, the export's config with both flags
    cleared, the export served bf16 and int8 with the serving launch
    counts."""
    import numpy as np
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    out = {}
    for mode in ("dynamic", "static"):
        static = mode == "static"
        export, run = phase_trainer(torch, workdir, card, QAT_MODES[mode],
                                    name=f"qat_{mode}_out")
        saved = ckpt._load_checkpoint(os.path.dirname(export), "cpu")
        scales = {ckpt.flax_module_path(k.rsplit(".", 1)[0]): float(v)
                  for k, v in saved["model"].items()
                  if k.endswith(".act_scale")}
        _, _, cfg = ckpt.load_model(export)
        keys = {name for name, _ in TQ.QuantizedYoloV3(
            cfg, kernels={}).conv_blocks()}
        run.update(scales=len(scales),
                   scale_range=[min(scales.values()), max(scales.values())]
                   if scales else None,
                   export_flags=[cfg.int8_train, cfg.int8_train_static])
        log(f"QAT trainer {mode}: {run['recalibrations']} recalibrations, "
            f"{len(scales)} scales in the checkpoint "
            f"{run['scale_range']}, export flags {run['export_flags']}")
        ok = (run["recalibrations"] == (TRAIN_EPOCHS if static else 0)
              and bool(scales) == static and set(scales) <= keys
              and all(np.isfinite(v) and v > 0 for v in scales.values())
              and not (cfg.int8_train or cfg.int8_train_static))
        if not ok:
            raise AssertionError(f"QAT trainer {mode}: {run}")
        run["export_served"] = phase_train_served(torch, inf, TQ, build,
                                                  export, workdir, card)
        out[mode] = run
    return out


def phase_qat(torch, inf, TQ, build, ModelConfig, workdir, card):
    """Phase 11: quantization-aware training at full width on phase 9's
    stores; one JSON line."""
    t0 = time.perf_counter()
    _, batch = store_examples(os.path.join(workdir, "train.ydb"),
                              TRAIN_BATCH, FULL["anchors"])
    batch = [torch.from_numpy(a).to(DEVICE) for a in batch]
    out = {"steps": phase_qat_steps(torch, TQ, ModelConfig, batch, card)}
    torch.cuda.empty_cache()
    out["sums"] = phase_qat_sums(torch, TQ, ModelConfig, batch)
    out["learns"] = phase_qat_learns(torch, TQ, ModelConfig, batch, card)
    del batch
    torch.cuda.empty_cache()
    out["trainer"] = phase_qat_trainer(torch, inf, TQ, build, workdir, card)
    out["card_vs_cpu"] = phase_train_reference(torch, ModelConfig, card,
                                               int8_train=True)
    log(f"QAT phase took {time.perf_counter() - t0:.1f} s")
    return out


def gate_run(mode, workdir):
    """One training mode of phase 12 in a process of its own (the step
    is host-bound, so the modes run side by side): plant, overfit, serve,
    score. Returns its record."""
    import numpy as np
    import torch
    from yolov3_tpu_torch.config import ModelConfig
    from yolov3_tpu_torch.quality_gate_512 import (lr_schedule, overfit,
                                                   plant_dataset,
                                                   serve_and_score)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    g = GATE
    t0 = time.perf_counter()
    d = os.path.join(workdir, f"gate_{mode}")
    img_dir, gt_dir, images, gts = plant_dataset(
        d, g["images"], g["size"], g["box"], np.random.RandomState(42))
    cfg = ModelConfig(img_size=(g["size"], g["size"], 3), number_classes=1,
                      anchors=((24, 24), (12, 12)), block_count=1,
                      filter_count=g["filter_count"], compute_dtype="float32",
                      **GATE_MODES[mode])
    lr_at = lr_schedule(g["lr"], *g["schedule"])
    state, final, logged = overfit(cfg, images, gts, g["steps"], lr_at,
                                   DEVICE, recalibrate_every=g["recalibrate"],
                                   log_every=250)
    train_s = time.perf_counter() - t0
    maps = serve_and_score(state, cfg, img_dir, gt_dir, d, g["min_box_size"],
                           g["images"], DEVICE)
    out = {"final_loss": final, "loss_at": logged, "mAP_bf16": maps["bf16"],
           "mAP_int8": maps["int8"], "train_s": train_s}
    log(f"gate {mode}: final loss {final:.4f} after {g['steps']} steps "
        f"({train_s:.1f} s), mAP@0.5 bf16 {maps['bf16']:.4f}, int8 "
        f"{maps['int8']:.4f}")
    return out


def phase_gates(workdir, card):
    """Phase 12: tests/test_quality_e2e.py's closed loop on the card in
    its three training modes (`GATE`), one process each, side by side:
    the loss under 0.5, then the export served through
    `inference.inference` in bf16 and with `--int8` (the card's default
    kernel set) and scored by `evaluate_folders`: mAP@0.5 >= 0.9 on both.
    Every mode runs before a failure is raised."""
    import concurrent.futures
    import multiprocessing
    g = GATE
    out, failed = {"card": card, "recipe": dict(g)}, []
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(GATE_MODES),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {mode: pool.submit(gate_run, mode, workdir)
                for mode in GATE_MODES}
        for mode, run in runs.items():
            out[mode] = run.result()
            if not (out[mode]["final_loss"] < g["max_loss"]
                    and min(out[mode]["mAP_bf16"],
                            out[mode]["mAP_int8"]) >= g["min_map"]):
                failed.append(mode)
    out["wall_s"] = time.perf_counter() - t0
    log(f"quality gates took {out['wall_s']:.1f} s")
    print(json.dumps({"quality_gates": out}), flush=True)
    if failed:
        raise AssertionError(f"quality gates failed: {failed}: {out}")
    return out

def raw_batch(path, n):
    """The first `n` records of a store as the raw feed carries them:
    uint8 images, boxes padded to MAX_BOXES, and their mask."""
    import numpy as np
    from yolov3_tpu_torch.data import records
    from yolov3_tpu_torch.data.encoder import pad_boxes
    from yolov3_tpu_torch.data.store import RecordReader
    with RecordReader(path) as reader:
        pairs = [records.decode_record(reader.get(k))
                 for k in reader.keys()[:n]]
    padded = [pad_boxes(b.astype(np.float32)) for _, b in pairs]
    return (np.stack([img for img, _ in pairs]),
            np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]))


def phase_preprocess(torch, workdir, card):
    """`preprocess_batch` at b16, 512 px, augmentation on: device ms per
    batch (CUDA events over FEED_REPS batches after two), device ops per
    batch; then one batch's draws, made on the card, through the port on
    the card and on the CPU: boxes, valid and grids identical, raw pixels
    within FEED_RAW_ATOL, z-scored ones within that over each image's
    std, plus 1e-6."""
    from yolov3_tpu_torch import train
    from yolov3_tpu_torch.config import AugmentConfig
    from yolov3_tpu_torch.data import device_pipeline as DP
    raw = raw_batch(os.path.join(workdir, "train.ydb"), TRAIN_BATCH)
    dev = [torch.from_numpy(a).to(DEVICE) for a in raw]
    acfg, size, anchors = AugmentConfig(), FULL["img_size"], FULL["anchors"]
    gens = [train.batch_generator(SEED, i, DEVICE)
            for i in range(1, FEED_REPS + 4)]

    def run(gen):
        return DP.preprocess_batch(*dev, gen, acfg, size, anchors, 2)

    for gen in gens[:2]:
        run(gen)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for gen in gens[2:2 + FEED_REPS]:
        run(gen)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FEED_REPS
    profile = phase_profile(torch, lambda _: run(gens[-1]), None, reps=1,
                            what="preprocess batches")
    log(f"preprocess_batch b{TRAIN_BATCH} 512px augmented: {ms:.3f} ms per "
        f"batch (events), {profile['device_ms']:.3f} ms device time and "
        f"{profile['device_ops_per_call']:.0f} device ops per batch "
        f"(profile), on {card}")

    draws = DP.draw_augment(train.batch_generator(SEED, 0, DEVICE),
                            TRAIN_BATCH, size, raw[1].shape[1], acfg)
    card_img, card_box, card_valid = (t.cpu() for t in DP.augment_batch(
        dev[0].float(), dev[1], dev[2], draws, acfg))
    card_z, *card_grids = (t.cpu() for t in DP.preprocess_batch(
        *dev, None, acfg, size, anchors, 2, draws=draws))
    # the CPU runs preprocess_batch's chain once, on the same draws
    cpu_img, cpu_box, cpu_valid = DP.augment_batch(
        torch.from_numpy(raw[0]).float(), torch.from_numpy(raw[1]),
        torch.from_numpy(raw[2]), draws.to("cpu"), acfg)
    cpu_z = DP.zscore_images(cpu_img)
    cpu_grids = DP.encode_labels_device(cpu_box, cpu_valid, size, anchors, 2)
    raw_err = float((card_img - cpu_img).abs().max())
    z_err = (card_z - cpu_z).abs().amax(dim=(1, 2, 3))
    z_bound = FEED_RAW_ATOL / cpu_img.std(dim=(1, 2, 3), correction=0) + 1e-6
    same = (torch.equal(card_box, cpu_box)
            and torch.equal(card_valid, cpu_valid)
            and all(torch.equal(a, b) for a, b in zip(card_grids, cpu_grids)))
    out = {"card": card, "batch": TRAIN_BATCH, "ms_per_batch": ms,
           "profile": profile, "boxes_valid_grids_identical": same,
           "valid_boxes": int(card_valid.sum()),
           "objects_s8": int(card_grids[2][..., 4].sum()),
           "raw_max_abs_err": raw_err, "raw_bound": FEED_RAW_ATOL,
           "z_max_abs_err": float(z_err.max()),
           "z_bound_min": float(z_bound.min())}
    log(f"preprocess card vs CPU on the same draws: boxes, valid, grids "
        f"identical {same} ({out['valid_boxes']} valid boxes, "
        f"{out['objects_s8']} s8 objects), raw pixels max |err| "
        f"{raw_err:.3e} (bound {FEED_RAW_ATOL:.3e}), z-scored "
        f"{out['z_max_abs_err']:.3e} (bound >= {out['z_bound_min']:.3e})")
    if not (same and raw_err <= FEED_RAW_ATOL and bool((z_err <= z_bound)
                                                       .all())):
        raise AssertionError(f"device preprocessing: card and CPU "
                             f"disagree: {out}")
    return out


def store_rates(workdir, card, reps=50):
    """get_batch records/s of the native and the pure-Python store
    readers (lookups and views, no decode) on the train store, host
    time; the ring's bytes at the trainer's shape beside /dev/shm's
    free bytes."""
    from yolov3_tpu_torch.data import shm_ring, store, store_native
    from yolov3_tpu_torch.data.encoder import MAX_BOXES
    path = os.path.join(workdir, "train.ydb")
    rates = {}
    for name, reader in (("native", store_native.NativeRecordReader(path)),
                         ("python", store.RecordReader(path))):
        keys = reader.keys()
        t0 = time.perf_counter()
        for _ in range(reps):
            recs = reader.get_batch(keys)
        rates[name] = reps * len(keys) / (time.perf_counter() - t0)
        del recs
        reader.close()
    base = shm_ring.ring_dir()
    free = shm_ring.free_bytes(base)
    slots = 3 + 2  # reader_count_per_device workers + 2, as ShmBatchReader
    ring = shm_ring.BatchRing(TRAIN_BATCH, FULL["img_size"], "uint8",
                              MAX_BOXES, slots)
    ring_bytes = ring.total_bytes
    ring.close(unlink=True)
    out = {"card": card, "get_batch_records_per_s": rates,
           "shm_dir": base, "shm_free_bytes": free, "ring_bytes": ring_bytes,
           "ring_slots": slots}
    log(f"store get_batch on the host: native {rates['native']:.0f} "
        f"records/s, pure-Python {rates['python']:.0f}; {base} has {free} "
        f"bytes free, the b{TRAIN_BATCH} ring takes {ring_bytes} ({slots} "
        f"slots)")
    return out


def phase_feed_trainer(torch, build, workdir, card, shm):
    """`train.train_model` with --device_augment 1 (and --shm_feed 1 when
    `shm`) on phase 9's stores; the eval steps' 1x1 launches counted
    over the run."""
    from yolov3_tpu_torch import train
    out_dir = os.path.join(workdir, "feed_shm" if shm else "feed_device")
    report = {}
    build.launch_counts.clear()
    t0 = time.perf_counter()
    export = train.train_model(
        TRAIN_BATCH, TRAIN_EVERY, os.path.join(workdir, "train.ydb"),
        os.path.join(workdir, "test.ydb"), out_dir, early_stopping_count=10,
        learning_rate=1e-4, use_augmentation=True, anchors=FULL["anchors"],
        seed=SEED, max_epochs=TRAIN_EPOCHS, compute_dtype="bfloat16",
        model_overrides={"use_pallas_pointwise": True}, device=DEVICE,
        device_augment=True, shm_feed=shm, report=report)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    wall = time.perf_counter() - t0
    expected = {"pointwise_conv_block":
                EXPECTED_LAUNCHES["pointwise_conv_block"]
                * report["eval_steps"]}
    with open(os.path.join(out_dir, "test_loss.csv")) as fh:
        test_loss = [float(v) for v in fh if v.strip()]
    out = {"card": card, "feed": report["feed"],
           "store_reader": report["store_kind"], "wall_s": wall,
           "train_steps": report["train_steps"],
           "steps_per_s_with_feed": report["train_steps"] / report["train_s"],
           "feed_wait_share": report["feed_wait_s"] / report["train_s"],
           "eval_steps": report["eval_steps"], "eval_launches": launches,
           "test_loss": test_loss}
    log(f"trainer, {report['feed']}: {out['train_steps']} steps in "
        f"{report['train_s']:.2f} s of train loops "
        f"({out['steps_per_s_with_feed']:.3f} steps/s with the feed, "
        f"{100 * out['feed_wait_share']:.1f}% waiting for batches), "
        f"{report['eval_steps']} eval steps launching {launches}, "
        f"{report['store_kind']} store reader, test_loss.csv {test_loss}, "
        f"wall {wall:.1f} s, on {card}")
    if not (report["store_kind"] == "native" and launches == expected
            and len(test_loss) == TRAIN_EPOCHS
            and all(math.isfinite(v) for v in test_loss)
            and export is not None
            and out["train_steps"] == TRAIN_EPOCHS * (TRAIN_EVERY + 1)):
        raise AssertionError(f"device-feed trainer run incomplete: {out}, "
                             f"launches expected {expected}")
    return export, out


def phase_tools(torch, inf, export, workdir, card):
    """find_anchors (k 2-4, no plot) on the planted train boxes, and
    evaluate_folders of the served export's CSVs on 8 test images against
    their planted boxes (the mAP of a two-epoch model: informational)."""
    import numpy as np
    from yolov3_tpu_torch.data import records
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    from yolov3_tpu_torch.data.store import RecordReader
    from yolov3_tpu_torch.find_anchors import find_anchors
    from yolov3_tpu_torch.ops import boxes as bbox
    from yolov3_tpu_torch.utils.evaluation import evaluate_folders
    dirs = {n: os.path.join(workdir, n) for n in ("anchor_csv", "gt", "pred")}
    for d in dirs.values():
        os.makedirs(d)
    for name, n, d in (("train", None, dirs["anchor_csv"]),
                       ("test", BATCH, dirs["gt"])):
        with RecordReader(os.path.join(workdir, f"{name}.ydb")) as reader:
            for i, key in enumerate(reader.keys()[:n]):
                _, boxes = records.decode_record(reader.get(key))
                bbox.write_boxes_from_xywhc(boxes, os.path.join(
                    d, f"im{i}.csv"))
    anchors = find_anchors(dirs["anchor_csv"], k_range=(2, 4),
                           plot_path=None)
    raw, _ = store_examples(os.path.join(workdir, "test.ydb"), BATCH,
                            FULL["anchors"])
    serve, _ = inf.make_serving_fn(export, device=DEVICE)
    rows, scores = inf.serve_batch(
        serve, zscore_images(torch.from_numpy(raw).to(DEVICE)), BATCH)
    for i, (r, sc) in enumerate(zip(rows, scores)):
        inf.write_detections_csv(r, sc, os.path.join(dirs["pred"],
                                                     f"im{i}.csv"), True)
    ev = evaluate_folders(dirs["pred"], dirs["gt"])
    out = {"card": card,
           "anchors": {k: {"score": s, "centers": np.round(c, 3).tolist()}
                       for k, (s, c) in anchors.items()},
           "served_rows": [int(r.shape[0]) for r in rows],
           "mAP@0.5": ev["mAP"],
           "per_class_ap": {str(k): v for k, v in
                            ev["per_class_ap"].items()}}
    log(f"tools: find_anchors k=2..4 scores "
        f"{[round(anchors[k][0], 1) for k in anchors]}; the device-feed "
        f"export served on {BATCH} test images, rows {out['served_rows']}, "
        f"mAP@0.5 {ev['mAP']:.4f} against the planted boxes")
    if not all(np.isfinite(c).all() and len(c) == k
               for k, (_, c) in anchors.items()):
        raise AssertionError(f"find_anchors: {anchors}")
    return out


def phase_device_feed(torch, inf, TQ, build, workdir, card, host):
    """Phase 10: the training feed's device half at full width; one JSON
    line."""
    t0 = time.perf_counter()
    out = {"preprocess": phase_preprocess(torch, workdir, card),
           "store": store_rates(workdir, card)}
    torch.cuda.empty_cache()
    export, out["trainer_device_augment"] = phase_feed_trainer(
        torch, build, workdir, card, shm=False)
    _, out["trainer_shm_feed"] = phase_feed_trainer(torch, build, workdir,
                                                    card, shm=True)
    out["trainer_host_feed"] = {
        k: host[k] for k in ("steps_per_s_with_feed", "feed_wait_share")}
    log(f"trainer steps/s with the feed (wait share): host "
        f"{host['steps_per_s_with_feed']:.3f} "
        f"({100 * host['feed_wait_share']:.1f}%), device augment "
        f"{out['trainer_device_augment']['steps_per_s_with_feed']:.3f} "
        f"({100 * out['trainer_device_augment']['feed_wait_share']:.1f}%), "
        f"+ shm ring {out['trainer_shm_feed']['steps_per_s_with_feed']:.3f} "
        f"({100 * out['trainer_shm_feed']['feed_wait_share']:.1f}%), "
        f"on {card}")
    out["export_served"] = phase_train_served(torch, inf, TQ, build, export,
                                              workdir, card)
    out["tools"] = phase_tools(torch, inf, export, workdir, card)
    log(f"device feed phase took {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 13: G1's logits, data-parallel training, ZeRO-1, sharded
# serving, remat -------------------------------------------------------------

def g1_batch(size, box, n):
    """The 512 px gate's 8 planted images (scripts/quality_gate_512.py:
    72-84, RandomState(42)) as the train step's batch, in numpy."""
    import numpy as np
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.data.imaging import zscore_normalize
    rng = np.random.RandomState(42)
    images, grids = [], []
    for _ in range(n):
        img = (rng.rand(size, size, 3) * 40).astype(np.float32)
        x = rng.randint(0, size - box)
        y = rng.randint(0, size - box)
        img[y:y + box, x:x + box] += 180 + rng.rand() * 40
        images.append(zscore_normalize(np.clip(img, 0, 255).astype(
            np.uint8)))
        grids.append(encode_boxes(np.array([[x, y, box, box, 0]],
                                           np.float32),
                                  (size, size, 3), G1["anchors"], 1))
    return [np.stack(images).astype(np.float32)] + [
        np.stack([g[i] for g in grids]).astype(np.float32) for i in range(3)]


def leaf_errors(got, want, spreads):
    """Per leaf: the distance of `got` from `want`, and the largest
    distance of the `spreads` (the same math in other summation orders)
    from `want`, each over the leaf's largest |want|."""
    out = {}
    for name, w in want.items():
        scale = float(w.abs().max()) or 1.0
        out[name] = (float((got[name] - w).abs().max()) / scale,
                     max(float((s[name] - w).abs().max()) / scale
                         for s in spreads))
    return out


def reorders(batch):
    """The batch reversed, and rolled by one image: the same math in two
    other summation orders."""
    import numpy as np
    return ([np.ascontiguousarray(a[::-1]) for a in batch],
            [np.ascontiguousarray(np.roll(a, 1, axis=0)) for a in batch])


def spread_check(errors, label):
    """Each leaf within the larger of GRAD_BOUND and SPREAD_FACTOR times
    the reference's own spread; the summary of the check."""
    over = {k: v for k, v in errors.items()
            if v[0] > max(GRAD_BOUND, SPREAD_FACTOR * v[1])}
    worst = max(errors, key=lambda k: errors[k][0])
    out = {"leaves": len(errors),
           "within_grad_bound": sum(v[0] <= GRAD_BOUND
                                    for v in errors.values()),
           "spread_over_grad_bound": sum(v[1] > GRAD_BOUND
                                         for v in errors.values()),
           "worst": [worst, *errors[worst]],
           "max_ratio_to_spread": max(v[0] / max(v[1], 1e-12)
                                      for v in errors.values()
                                      if v[0] > GRAD_BOUND) if any(
               v[0] > GRAD_BOUND for v in errors.values()) else 0.0,
           "over": sorted(over)[:8]}
    log(f"{label}: {out['within_grad_bound']}/{out['leaves']} leaves within "
        f"{GRAD_BOUND} of their largest |g|, the reference's own spread "
        f"over it on {out['spread_over_grad_bound']}; worst {out['worst']}; "
        f"largest ratio to the spread {out['max_ratio_to_spread']:.2f}")
    if over:
        raise AssertionError(f"{label}: {len(over)} leaves beyond "
                             f"max({GRAD_BOUND}, {SPREAD_FACTOR} x spread): "
                             f"{out}")
    return out


def grads_of(torch, T, cfg, tcfg, batch, device, n, seed=SEED):
    """The loss and gradients ({name: CPU tensor}) of one train-mode
    forward and backward from `init_train_params(cfg, seed)` on `batch`
    (numpy), the loss over `n` images."""
    state = T.create_train_state(cfg, tcfg, seed, device)
    b = [torch.from_numpy(a).to(device) for a in batch]
    loss, _ = T._loss(state.model, cfg, tcfg, n, b[0], b[1:])
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().float().cpu()
                                  for k, p in state.model.named_parameters()}


# the route mxu_conv takes against the f64 sums, of the largest |value|:
# above the routes measured on an H100 (4.50e-5 at b16, 2.22e-5 at b8),
# below what a conv that transforms its operands gives under TF32
# (Winograd, FFT: each transformed operand rounded to a 10-bit mantissa,
# up to 4.9e-4 of each product). The TF32-off conv alone is not held to
# it: one wgrad's 131072-term sums (b8, 128 px, 64 -> 128 channels) are
# 5.8e-5 off in f32, where TF32, 2.2e-5 off, is the route.
MXU_BOUND = 5e-5


def mxu_conv_shapes(torch, cfg, batch):
    """The (x shape, weight shape, stride) of every conv of `cfg`'s train
    forward at `batch` images (shapes only: a run on the meta device)."""
    from yolov3_tpu_torch.models import yolo
    model = yolo.YoloV3(cfg).to("meta").train()
    shapes = set()

    def hook(m, inputs):
        stride = getattr(m, "stride", 1)
        shapes.add((tuple(inputs[0].shape), tuple(m.conv.weight.shape),
                    stride))
    for m in model.modules():
        if isinstance(m, (yolo.ConvBlock, yolo.DetectionHead)):
            m.register_forward_pre_hook(hook)
    model(torch.empty(batch, *cfg.img_size, device="meta"))
    return sorted(shapes)


def load_probe():
    """scripts/qg512_probe.py as a module (its MXU conv)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "qg512_probe", os.path.join(HERE, "scripts", "qg512_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def phase_mxu_exact(torch, ModelConfig, batches):
    """The probe's `mxu_conv` (scripts/qg512_probe.py `--mxu 1`, G1's
    experiment) on the card: at every conv shape of the flagship model's
    train forward at each batch, on seeded bf16-valued operands, the
    forward and the VJP (dgrad and wgrad) with TF32 on and off against
    f64 (`route_errors`). A shape passes where the route mxu_conv takes
    there (TF32 where `tf32_is_exact`, else TF32 off) is within
    `MXU_BOUND` of the f64 sums, relative to the largest |value|, and
    finite. TF32 against TF32 off is reported, not bounded: at some
    shapes TF32 is the inexact one (pinned TF32 off), at one the f32
    conv is."""
    from yolov3_tpu_torch.models import yolo
    probe = load_probe()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def bf16_valued(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                * scale).to(torch.bfloat16)
    cfg = ModelConfig(**dict(FULL, use_pallas_pointwise=False))
    rows, t0 = [], time.perf_counter()
    for batch in batches:
        for xs, ws, stride in mxu_conv_shapes(torch, cfg, batch):
            x = bf16_valued(xs)
            w = bf16_valued(ws, (ws[1] * ws[2] * ws[3]) ** -0.5)
            dy = bf16_valued((xs[0], -(-xs[1] // stride),
                              -(-xs[2] // stride), ws[0]))
            row = {"x": xs, "w": ws, "stride": stride}
            for kind, fn in (
                    ("fwd", lambda dt: (yolo.conv2d_same(
                        x.to(dt), w.to(dt), None, stride),)),
                    ("vjp", lambda dt: yolo._conv_vjp(
                        x.to(dt), w.to(dt), dy.to(dt), stride))):
                outs, errs = probe.route_errors(fn)
                ok = probe.tf32_is_exact(errs)
                row[kind] = {
                    "tf32_err": errs[True], "f32_err": errs[False],
                    "tf32_vs_off": max(
                        float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(outs[True], outs[False])),
                    "route": "tf32" if ok else "tf32_off",
                    "route_err": errs[ok]}
                del outs
            rows.append(row)
            del x, w, dy
    torch.cuda.empty_cache()
    kinds = [(r, k) for r in rows for k in ("fwd", "vjp")]
    worst = max(kinds, key=lambda rk: rk[0][rk[1]]["route_err"])
    out = {"shapes": len(rows), "seconds": time.perf_counter() - t0,
           "bound": MXU_BOUND, "worst_route": dict(worst[0], kind=worst[1]),
           "worst_route_err": worst[0][worst[1]]["route_err"],
           "worst_f32_err": max(r[k]["f32_err"] for r, k in kinds),
           "worst_tf32_vs_off": max(r[k]["tf32_vs_off"] for r, k in kinds),
           "pinned_tf32_off": [dict(r, kind=k) for r, k in kinds
                               if r[k]["route"] == "tf32_off"],
           # `not <=` also fails a NaN
           "failed": [dict(r, kind=k) for r, k in kinds
                      if not r[k]["route_err"] <= MXU_BOUND]}
    log(f"mxu_conv at {len(rows)} conv shapes (batches {batches}): the "
        f"route's error against f64 at most {out['worst_route_err']:.3g} "
        f"({worst[0]['x']} {worst[0]['w']} s{worst[0]['stride']} "
        f"{worst[1]}, {worst[0][worst[1]]['route']}), bound "
        f"{MXU_BOUND:g}; TF32 off's at most {out['worst_f32_err']:.3g}; "
        f"TF32 vs TF32 "
        f"off at most {out['worst_tf32_vs_off']:.3g}; "
        f"{len(out['pinned_tf32_off'])} of {len(kinds)} pinned TF32 off")
    if out["failed"]:
        raise AssertionError(f"mxu_conv's route is not exact: "
                             f"{out['failed']}")
    return out


def phase_g1(torch, ModelConfig, card):
    """G1 on the card: the 512 px gate's first `G1["steps"]` steps (full
    depth, bf16, its lr schedule, from `init_train_params(cfg, 0)`), the
    loss and per scale the largest |objectness logit| and wh logit of
    the cells without an object, a step each, as one JSON line; then one
    full-depth f32 step (TF32 off) on the card against the same step on
    the CPU."""
    import numpy as np
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.parallel import train_step as T
    from yolov3_tpu_torch.quality_gate_512 import lr_schedule
    g = G1
    n = g["images"]
    batch = g1_batch(g["size"], g["box"], n)
    kw = dict(img_size=(g["size"], g["size"], 3), number_classes=1,
              anchors=g["anchors"], **g["model"])
    cfg = ModelConfig(**kw, compute_dtype="bfloat16")
    tcfg = TrainConfig(batch_size=n)
    state = T.create_train_state(cfg, tcfg, SEED, DEVICE)
    step = T.make_train_step(cfg, tcfg, n)
    fms = []
    state.model.register_forward_hook(
        lambda m, i, out: fms.__setitem__(slice(None), out))
    dev = [torch.from_numpy(a).to(DEVICE) for a in batch]
    empty = [grid[..., 4] == 0 for grid in dev[1:]]
    lr_at = lr_schedule(*g["lr"])
    rows = []
    t0 = time.perf_counter()
    for i in range(g["steps"]):
        state, metrics = step(state, dev, lr_at(i))
        maps = [f.detach().float().reshape(*f.shape[:3], cfg.number_anchors,
                                           -1) for f in fms]
        stats = torch.stack(
            [metrics["loss"].float()]
            + [f[..., 4].abs().max() for f in maps]
            + [f[..., 2:4][e].max() for f, e in zip(maps, empty)]).tolist()
        rows.append({"step": i, "lr": lr_at(i), "loss": stats[0],
                     "obj_logit": stats[1:4], "wh_logit_empty": stats[4:7]})
    steps_s = time.perf_counter() - t0
    del state, step, dev
    torch.cuda.empty_cache()
    out = {"card": card, "steps": rows, "steps_s": steps_s}
    print(json.dumps({"g1_steps": out}), flush=True)
    last = rows[-1]
    log(f"G1 {g['steps']} gate steps at 512 px, full depth, bf16: loss "
        f"{rows[0]['loss']:.3f} -> {last['loss']:.3f}, |objectness| "
        f"{last['obj_logit']}, wh (no object) {last['wh_logit_empty']} "
        f"({steps_s:.1f} s)")
    if not (all(math.isfinite(v) for r in rows for v in
                [r["loss"], *r["obj_logit"], *r["wh_logit_empty"]])
            and last["loss"] < rows[0]["loss"]):
        raise AssertionError(f"G1 steps: {rows}")

    cfg32 = ModelConfig(**kw, compute_dtype="float32")
    t0 = time.perf_counter()
    loss_card, g_card = grads_of(torch, T, cfg32, tcfg, batch, DEVICE, n)
    torch.cuda.empty_cache()
    loss_cpu, g_cpu = grads_of(torch, T, cfg32, tcfg, batch, "cpu", n)
    # the CPU's own spread: the same math in two other batch orders
    spreads = [grads_of(torch, T, cfg32, tcfg, b, "cpu", n)[1]
               for b in reorders(batch)]
    check = spread_check(leaf_errors(g_card, g_cpu, spreads),
                         "G1 f32 full-depth step, card vs CPU")
    out["f32_card_vs_cpu"] = dict(check, loss_card=loss_card,
                                  loss_cpu=loss_cpu,
                                  seconds=time.perf_counter() - t0)
    if not abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu):
        raise AssertionError(f"G1 f32 loss card {loss_card} vs CPU "
                             f"{loss_cpu}")
    return out


def flat_params(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def dp_rank(rank, world, batch, cfg_kw, steps, lr, device):
    """One rank of phase 13's data-parallel check on the one card (gloo):
    this rank's half of `batch` (the global batch, one half twice), one
    step, `steps` steps with the replicated Adam and with ZeRO-1; rank 0
    also runs one process's steps (a group of its own) on its half and
    on the whole global batch, and compares."""
    import torch
    import torch.distributed as dist
    from yolov3_tpu_torch.config import ModelConfig, TrainConfig
    from yolov3_tpu_torch.parallel import distributed as D
    from yolov3_tpu_torch.parallel import train_step as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one algorithm per shape, so two runs of one step agree bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.set_num_threads(2)
    solo = [dist.new_group([r]) for r in range(world)][rank]
    cfg = ModelConfig(**cfg_kw)
    n = batch[0].shape[0]
    full = [torch.from_numpy(a).to(device) for a in batch]
    local = D.shard_batch(full, rank, world)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}

    def run(tcfg, group, data, k):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state = T.create_train_state(cfg, tcfg, SEED, device, group=group)
        step = T.make_train_step(cfg, tcfg, n, group=group)
        times, metrics, grads = [], None, None
        for i in range(k):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, data, lr)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                metrics = {key: float(v) for key, v in m.items()}
                grads = {key: p.grad.detach().float().cpu().clone()
                         for key, p in state.model.named_parameters()}
        rec = {"ms_per_step": times, "metrics": metrics,
               "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                        if cuda else 0)}
        params = flat_params(state.model)
        del state, step
        if cuda:
            torch.cuda.empty_cache()
        return rec, grads, params

    plain, zero = TrainConfig(), TrainConfig(shard_optimizer=True)
    out["dp"], dp_grads, rep_params = run(plain, None, local, steps)
    out["zero"], _, zero_params = run(zero, None, local, steps)
    zero_err = max(float(((zero_params[k] - v).abs()
                          - 2e-6 * v.abs()).max() / 1e-7)
                   for k, v in rep_params.items())
    out["zero_vs_replicated_atol_units"] = zero_err
    out["zero_max_abs_diff"] = max(float((zero_params[k] - v).abs().max())
                                   for k, v in rep_params.items())
    if rank == 0:
        # one process on this half (the group of rank 0 alone): the
        # ranks' inputs are equal, so the summed gradients are twice its
        out["solo_half"], half_grads, _ = run(plain, solo, local, steps)
        # one process on the global batch, one half twice, and in two
        # other orders (its own spread)
        out["solo_global"], glob_grads, _ = run(plain, solo, full, steps)
        spreads = [run(plain, solo, [torch.from_numpy(a).to(device)
                                     for a in b], 1)[1]
                   for b in reorders(batch)]
        out["exact_sum_err"] = max(float((dp_grads[k] - 2 * v).abs().max())
                                   for k, v in half_grads.items())
        out["global_errors"] = leaf_errors(
            {k: v / 2 for k, v in dp_grads.items()}, glob_grads, spreads)
    dist.barrier()
    return out


def phase_data_parallel(torch, ModelConfig, card):
    """Data-parallel training at full width (512 px, 1024 filters, 8
    blocks, bf16) over DP_WORLD ranks on the one card, joined by gloo
    (NCCL takes one rank a device), against one process; ZeRO-1 against
    the replicated Adam."""
    import numpy as np
    from yolov3_tpu_torch.parallel import distributed as D
    half = g1_batch(G1["size"], G1["box"], DP_BATCH // DP_WORLD)
    batch = [np.concatenate([a] * DP_WORLD) for a in half]
    cfg_kw = dict(img_size=(G1["size"], G1["size"], 3), number_classes=1,
                  anchors=G1["anchors"], compute_dtype="bfloat16",
                  **G1["model"])
    t0 = time.perf_counter()
    ranks = D.spawn(dp_rank, DP_WORLD, batch, cfg_kw, DP_STEPS, 1e-4,
                    DEVICE, backend="gloo", timeout_s=600.0)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    dp, solo = r0["dp"]["metrics"], r0["solo_global"]["metrics"]
    out = {"card": card, "world": DP_WORLD, "backend": "gloo",
           "global_batch": DP_BATCH, "wall_s": wall,
           "dp_loss": dp["loss"], "dp_loss_sum": dp["loss_sum"],
           "solo_loss": solo["loss"], "solo_loss_sum": solo["loss_sum"],
           "exact_sum_err": r0["exact_sum_err"],
           "ms_per_step": {f"rank{r}": ranks[r]["dp"]["ms_per_step"]
                           for r in range(DP_WORLD)},
           "zero_ms_per_step": {f"rank{r}": ranks[r]["zero"]["ms_per_step"]
                                for r in range(DP_WORLD)},
           "solo_ms_per_step": {
               "half": r0["solo_half"]["ms_per_step"],
               "global": r0["solo_global"]["ms_per_step"]},
           "max_memory_allocated": {
               f"rank{r}": {"replicated": ranks[r]["dp"][
                   "max_memory_allocated"], "zero": ranks[r]["zero"][
                   "max_memory_allocated"]} for r in range(DP_WORLD)},
           "solo_global_max_memory_allocated": r0["solo_global"][
               "max_memory_allocated"],
           "zero_vs_replicated_atol_units": max(
               r["zero_vs_replicated_atol_units"] for r in ranks),
           "zero_max_abs_diff": max(r["zero_max_abs_diff"] for r in ranks)}
    log(f"data-parallel, {DP_WORLD} ranks on one card over gloo, global "
        f"batch {DP_BATCH}, 512 px, full width, bf16: loss {dp['loss']} / "
        f"one process {solo['loss']}, loss_sum {dp['loss_sum']} / "
        f"{solo['loss_sum']}; summed gradients - 2 x one rank's: "
        f"{out['exact_sum_err']}; ms/step {out['ms_per_step']} (one "
        f"process: {out['solo_ms_per_step']}); peak memory "
        f"{out['max_memory_allocated']}; ZeRO-1 vs replicated after "
        f"{DP_STEPS} steps: max |diff| {out['zero_max_abs_diff']}")
    out["gradients_vs_one_process"] = spread_check(
        r0["global_errors"], "DP summed gradients / 2 vs one process on "
        "the global batch")
    if not (abs(dp["loss"] - solo["loss"]) <= 1e-3 * abs(solo["loss"])
            and abs(dp["loss_sum"] - 2 * solo["loss_sum"])
            <= 1e-3 * abs(2 * solo["loss_sum"])
            and out["exact_sum_err"] == 0.0
            and out["zero_vs_replicated_atol_units"] <= 1.0):
        raise AssertionError(f"data-parallel step: {out}")
    return out


def phase_sharded_serving(torch, inf, TQ, build, path, card):
    """`--num-devices`' sharded detectors on [cuda:0, cuda:0] against one
    device, bf16 (the 1x1 kernel) and int8 (the default set), each
    sharded call's launches twice one replica's batch of 4."""
    import numpy as np
    devices = [DEVICE] * 2
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (BATCH, *FULL["img_size"]), dtype=np.float32)).to(DEVICE)
    out = {"card": card, "devices": devices}
    for label in ("bf16", "int8"):
        if label == "bf16":
            one, _ = inf.make_detector_fn(path, device=DEVICE)
            sharded, _ = inf.make_detector_fn(path, devices=devices)
        else:
            one, _ = TQ.make_quantized_detector_fn(path, images,
                                                   device=DEVICE)
            sharded, _ = TQ.make_quantized_detector_fn(path, images,
                                                       devices=devices)
        build.launch_counts.clear()
        one(images[:BATCH // 2])
        torch.cuda.synchronize()
        replica = dict(build.launch_counts)
        want = one(images)
        build.launch_counts.clear()
        got = sharded(images)
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        expected = {k: 2 * v for k, v in replica.items()}
        err = float((got.float() - want.float()).abs().max())
        fidelity = TQ.decode_iou_fidelity(want.float().cpu().numpy(),
                                          got.float().cpu().numpy(),
                                          top_k=20)
        out[label] = {"launches": launches, "per_replica": replica,
                      "max_abs_err": err, "fidelity": fidelity}
        log(f"sharded {label} detector on {devices}: launches {launches} "
            f"(one replica's batch of {BATCH // 2}: {replica}), max |diff| "
            f"{err} against one device, decode fidelity {fidelity:.6f}")
        if not (launches == expected and replica and fidelity >= 0.999
                and got.shape == want.shape):
            raise AssertionError(f"sharded {label}: {out[label]}")
    return out


def phase_remat(torch, ModelConfig, card):
    """One train-mode forward and backward at full width (512 px, bf16,
    b8) with and without `remat_blocks`, after one warm-up each: the loss
    and gradients equal, the peak memory over the state and the seconds
    of each."""
    from yolov3_tpu_torch.config import TrainConfig
    from yolov3_tpu_torch.parallel import train_step as T
    batch = g1_batch(G1["size"], G1["box"], G1["images"])
    kw = dict(img_size=(G1["size"], G1["size"], 3), number_classes=1,
              anchors=G1["anchors"], compute_dtype="bfloat16", **G1["model"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tcfg, n = TrainConfig(), G1["images"]
    dev = [torch.from_numpy(a).to(DEVICE) for a in batch]
    out, res = {"card": card}, {}
    try:
        for remat in (False, True):
            cfg = ModelConfig(**kw, remat_blocks=remat)
            state = T.create_train_state(cfg, tcfg, SEED, DEVICE)
            for timed in (False, True):
                state.model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, _ = T._loss(state.model, cfg, tcfg, n, dev[0], dev[1:])
                loss.backward()
                torch.cuda.synchronize()
            out["remat" if remat else "plain"] = {
                "peak_over_base": torch.cuda.max_memory_allocated() - base,
                "ms": (time.perf_counter() - t0) * 1e3}
            res[remat] = (float(loss.detach()), {
                k: p.grad.detach().float().cpu()
                for k, p in state.model.named_parameters()})
            del state, loss
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, g0), (l1, g1) = res[False], res[True]
    err = max(float((g1[k] - v).abs().max() / (v.abs().max() or 1.0))
              for k, v in g0.items())
    out.update(loss=l0, loss_remat=l1, max_grad_err_rel_leaf_max=err)
    log(f"remat_blocks: loss {l1} vs {l0}, gradients within {err:.3e} of "
        f"each leaf's largest |g|; peak over the state "
        f"{out['remat']['peak_over_base'] / 2**30:.2f} GiB vs "
        f"{out['plain']['peak_over_base'] / 2**30:.2f} GiB; forward and "
        f"backward {out['remat']['ms']:.1f} ms vs {out['plain']['ms']:.1f}")
    if not (l1 == l0 and err <= 1e-6
            and out["remat"]["peak_over_base"]
            < out["plain"]["peak_over_base"]):
        raise AssertionError(f"remat: {out}")
    return out


def phase_multi(torch, inf, TQ, build, ModelConfig, path, card):
    """Phase 13: the MXU conv's card route at every flagship conv shape
    at the 512 px gate's batch, G1's logits and full-depth step,
    data-parallel training and ZeRO-1, sharded serving, remat; one JSON
    line."""
    t0 = time.perf_counter()
    out = {"mxu_exact": phase_mxu_exact(torch, ModelConfig, [G1["images"]])}
    out["g1"] = phase_g1(torch, ModelConfig, card)
    torch.cuda.empty_cache()
    out["data_parallel"] = phase_data_parallel(torch, ModelConfig, card)
    out["sharded_serving"] = phase_sharded_serving(torch, inf, TQ, build,
                                                   path, card)
    torch.cuda.empty_cache()
    out["remat"] = phase_remat(torch, ModelConfig, card)
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 13 took {out['wall_s']:.1f} s")
    return out


def train_graph_only(torch, ModelConfig, card, out_path) -> int:
    """`--phase train_graph`: phase 9's step timing and learning check,
    then `phase_train_graph`, on a planted store; one JSON line each."""
    with tempfile.TemporaryDirectory() as workdir:
        path = os.path.join(workdir, "train.ydb")
        plant_store(path, TRAIN_BATCH, SEED)
        _, batch = store_examples(path, TRAIN_BATCH, FULL["anchors"])
    batch = [torch.from_numpy(a).to(DEVICE) for a in batch]
    step, learn = phase_train_step(torch, ModelConfig, batch, card)
    lines = {"train_step": step, "train_learns": learn,
             "train_graph": phase_train_graph(torch, ModelConfig, batch,
                                              card)}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(lines, fh, indent=1)
    for key, value in lines.items():
        print(json.dumps({key: value}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the detailed results to this JSON")
    parser.add_argument("--phase", choices=("all", "train_graph"),
                        default="all",
                        help="train_graph: phase 9's step timing and the "
                        "train-graph gate alone, on its planted store")
    args = parser.parse_args(argv)

    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not os.path.isdir(os.path.join(HERE, "yolov3_tpu_torch")):
        print("chip_smoke: the yolov3_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yolov3_tpu_torch import inference as inf
    from yolov3_tpu_torch.config import InferenceConfig, ModelConfig
    from yolov3_tpu_torch.models import quantized as TQ
    from yolov3_tpu_torch.ops.kernels import _build as build
    from yolov3_tpu_torch.utils import checkpoint as ckpt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    if args.phase == "train_graph":
        return train_graph_only(torch, ModelConfig, smi, args.out)
    t0 = time.perf_counter()
    build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    result = {"card": smi, "reference": phase_reference(torch, ckpt,
                                                         ModelConfig)}
    with tempfile.TemporaryDirectory() as workdir:
        path, calls, launches, serving = phase_serving(
            torch, ckpt, inf, build, ModelConfig, InferenceConfig, workdir,
            smi)
        result["serving"] = serving
        with torch.inference_mode():
            pw, pw_rows = phase_pointwise(torch, calls["pw"])
            nms_rows, greedy_rows = phase_nms(torch, calls["nms"])
        del calls
        result["int8_reference"] = phase_int8_reference(torch, ckpt, TQ,
                                                        ModelConfig)
        images = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (BATCH, *FULL["img_size"]), dtype=np.float32)).to(DEVICE)
        q_calls, q_launches, result["int8_serving"], exact_epi, serve = \
            phase_int8_serving(torch, inf, TQ, build, path, images, smi)
        set_calls, set_launches, serves = phase_int8_sets(torch, TQ, build,
                                                          path, images)
        result["int8_ab"] = phase_int8_ab(
            torch, dict({"s2d_region_block_q": serve}, **serves), images,
            smi)
        del serve, serves
        with torch.inference_mode():
            q_summary, result["int8_calls"] = phase_int8_kernels(torch,
                                                                 q_calls)
            r_summary = phase_region_kernels(
                torch, [c for c in q_calls if c[0] in REGION_KERNELS]
                + set_calls, exact_epi)
        result["region_calls"] = r_summary
        del q_calls, set_calls, images
        result["cli_rows"] = phase_cli(torch, inf, InferenceConfig, path,
                                       workdir)
        result["cli_int8_rows"] = phase_cli_int8(torch, inf, TQ, path,
                                                 workdir)
        result["tiled"] = phase_tiled(torch, TQ, inf, path, workdir, smi)
        torch.cuda.empty_cache()
        training = phase_training(torch, inf, TQ, build, ModelConfig,
                                  workdir, smi)
        result.update(training)
        torch.cuda.empty_cache()
        training["device_feed"] = phase_device_feed(
            torch, inf, TQ, build, workdir, smi, training["trainer"])
        result["device_feed"] = training["device_feed"]
        torch.cuda.empty_cache()
        training["qat"] = result["qat"] = phase_qat(
            torch, inf, TQ, build, ModelConfig, workdir, smi)
        torch.cuda.empty_cache()
        result["quality_gates"] = phase_gates(workdir, smi)
        torch.cuda.empty_cache()
        training["multi_device"] = result["multi_device"] = phase_multi(
            torch, inf, TQ, build, ModelConfig, path, smi)
    result["pointwise_calls"] = pw_rows
    result["nms_cases"] = nms_rows
    result["greedy_cases"] = greedy_rows

    nms = nms_rows[0]
    kernels = [
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolov3_tpu/ops/pallas/nms_kernel.py:191",
         "launches": launches["nms_suppress"],
         "max_abs_err": max(r["max_abs_err"] for r in nms_rows),
         "ms": nms["ms"], "event_ms": nms["event_ms"],
         "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
         "bound_by": nms["bound_by"], "library_ms": None,
         "previous_ms": nms["previous_ms"]},
        {"name": "pointwise_conv_block", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/pointwise_conv_block.cu",
         "replaces": "yolov3_tpu/ops/pallas/conv_block_kernel.py:68",
         "launches": launches["pointwise_conv_block"],
         "max_abs_err": pw["max_abs_err"], "ms": pw["ms"],
         "event_ms": pw["event_ms"], "plain_ms": pw["plain_ms"],
         "bound_ms": pw["bound_ms"],
         "bound_by": pw["bound_by"], "library_ms": pw["library_ms"],
         "previous_ms": pw["previous_ms"]},
    ]
    # launches: the region's from the default serving call, the tail's and
    # the exit's from the serving calls of their kernel sets
    path_launches = dict(q_launches, **set_launches)
    for name, (_, replaces) in INT8_KERNELS.items():
        q = q_summary.get(name) or r_summary[name]
        src = "s2d_region_block_q" if name == "s2d_tail_block_q" else name
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"yolov3_tpu_torch/csrc/{src}.cu",
             "replaces": replaces, "launches": path_launches[name],
             "max_abs_err": q["max_abs_err"], "ms": q["ms"],
             "event_ms": q["event_ms"], "plain_ms": q["plain_ms"],
             "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
             "library_ms": q["library_ms"]})
        if "previous_ms" in q:
            kernels[-1]["previous_ms"] = q["previous_ms"]
    # the region's modes, each from its set's serving call
    for name in REGION_MODES:
        q = r_summary[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "yolov3_tpu_torch/csrc/s2d_region_block_q.cu",
             "replaces": INT8_KERNELS["s2d_region_block_q"][1],
             "launches": path_launches[name],
             "max_abs_err": q["max_abs_err"], "ms": q["ms"],
             "event_ms": q["event_ms"], "plain_ms": q["plain_ms"],
             "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
             "library_ms": q["library_ms"],
             "codes_differing": q["codes_differing"]})
        if "previous_ms" in q:
            kernels[-1]["previous_ms"] = q["previous_ms"]
    greedy = greedy_rows[0]
    kernels.append(
        {"name": "greedy_suppress", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/greedy_suppress.cu",
         "replaces": "yolov3_tpu/ops/pallas/nms_kernel.py:295",
         "launches": greedy["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in greedy_rows),
         "ms": greedy["ms"], "event_ms": greedy["event_ms"],
         "plain_ms": greedy["plain_ms"], "bound_ms": greedy["bound_ms"],
         "bound_by": greedy["bound_by"], "library_ms": None,
         "previous_ms": greedy["previous_ms"]})
    for kern in kernels:
        for key, v in kern.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{kern['name']} {key} = {v}")
    result["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    for key, value in training.items():
        print(json.dumps({key: value}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
