#!/usr/bin/env python3
"""Time the port's kernels on the wgmma core (the int8 1x1, 3x3,
stride-2 3x3 and exit, and the bf16 1x1) at every ConvBlock shape of the
flagship model (512 px, filter_count 1024, block_count 8) at batch 8,
under each tile plan, on one NVIDIA GPU.

    python3 scripts/conv_q_sweep.py [--bf16-only | --exit-only]

For each shape and input type (s8 through TMA, at stride 2 too: the stem
region's exit conv; bf16 through the converting producer; bf16 operands
for the bf16 1x1):
the plan `conv_plan` picks, the
kernel's device time under it beside the WMMA core's (`*_wmma` entries),
both timed in turns (WMMA, kernel, kernel, WMMA), the achieved TOP/s (or
TFLOP/s), whether the two outputs are equal (within 2e-2 for bf16), and
then the device time of every tile of `_conv_q.TILES` at 3, 4 and 5 stages
with its `plan_cost`. This is the measurement the planner's
cost model (`ops/kernels/_conv_q.py`) is checked against. Device time:
20 calls captured in a CUDA graph, replays timed with CUDA events
(`chip_smoke.device_ms`). Random inputs from a numpy seed; weights and
epilogue rows of a random folded block.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402
from yolov3_tpu_torch.ops import quant  # noqa: E402
from yolov3_tpu_torch.ops.kernels import _conv_q, conv_block  # noqa: E402

# (H = W, Ci, Co, ksize) of the flagship's int8 ConvBlocks at b8 (models/
# yolo.py: FeatureBlocks 0-4, the YoloBlocks and the necks)
SHAPES = ((16, 512, 1024, 3), (32, 256, 512, 3), (64, 128, 256, 3),
          (128, 64, 128, 3), (256, 32, 64, 3), (16, 512, 512, 1),
          (16, 1024, 512, 1), (32, 256, 256, 1), (32, 512, 256, 1),
          (32, 1024, 256, 1), (64, 256, 128, 1), (64, 512, 128, 1),
          (128, 128, 64, 1), (256, 64, 32, 1))
# the shapes whose launches take a bf16 input on the serving path
BF16_SHAPES = ((16, 512, 1024, 3), (32, 256, 512, 3), (64, 128, 256, 3),
               (16, 1024, 512, 1), (32, 512, 256, 1), (64, 256, 128, 1))
# (input H = W, Ci, Co) of the flagship's stride-2 ConvBlocks at b8, bf16
# in: ConvBlock_3-5 on every route, ConvBlock_1 on the tail and exit ones
DOWN_SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 1024),
               (512, 32, 64))
# (input H = W, Ci, Co) of the stem region's exit conv at b8, s8 in
# (ConvBlock_2 on the exit route: `exit_conv_block_q`)
EXIT_SHAPES = ((256, 64, 128),)
# (H = W, Ci, Co) of the flagship's bf16 1x1 ConvBlocks at b8 (34 launches
# of 9 shapes)
PW_BF16_SHAPES = ((256, 64, 32), (128, 128, 64), (64, 256, 128),
                  (32, 512, 256), (16, 1024, 512), (16, 512, 512),
                  (32, 1024, 256), (32, 256, 256), (64, 512, 128))
BATCH = 8


def case(rng, h, ci, co, ksize, kind, stride=1):
    """(name, x, w_t, epi, launch kwargs) of a random block: s8 or bf16 x,
    an s8 output, the stride-1 3x3's s8 residual on an s8 input; an s8
    input at stride 2 is the exit conv's, whose epi carries 1/s_next in
    row 3."""
    w = torch.from_numpy((rng.standard_normal((co, ci, ksize, ksize))
                          / np.sqrt(ksize * ksize * ci)).astype(np.float32))
    b, g, o, m = (torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.standard_normal(co), rng.uniform(0.8, 1.2, co),
        0.1 * rng.standard_normal(co), 0.1 * rng.standard_normal(co)))
    mul, add = quant.bn_affine(g, o, m, torch.from_numpy(
        rng.uniform(0.5, 1.5, co).astype(np.float32)), 1e-3)
    w_t, epi = (t.cuda() for t in quant.fold_conv_block(w, b, mul, add,
                                                        0.05))
    shape = (BATCH, h, h, ci)
    if kind == "s8":
        x = torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).cuda()
    else:
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 2).cuda().to(torch.bfloat16)
    res = None
    if ksize == 3 and kind == "s8" and stride == 1:
        res = torch.from_numpy(rng.integers(
            -127, 128, (BATCH, h, h, co)).astype(np.int8)).cuda()
    name = ("pointwise_conv_block_q" if ksize == 1 else "conv3x3_block_q"
            if stride == 1 else "down_conv_block_q" if kind != "s8"
            else "exit_conv_block_q")
    if name == "exit_conv_block_q":
        epi = quant.exit_epi(epi.cpu(), 1 / 9.0).cuda()
    kw = dict(ksize=ksize, stride=stride, inv_in=0.5, inv_next=9.0,
              alpha=0.2, cast_bf16=True, residual_out=res, emit_s8=True)
    return name, x, w_t, epi, kw


def sweep(h, ci, co, ksize, kind, stride=1):
    name, x, w_t, epi, kw = case(np.random.default_rng(h + ci), h, ci, co,
                                 ksize, kind, stride)

    def run(plan=None, wmma=False):
        return _conv_q.launch(name, x, w_t, epi, plan=plan, wmma=wmma, **kw)

    float_in = kind != "s8"
    plan = _conv_q.conv_plan(BATCH, h, h, ci, co, ksize, float_in,
                             stride=stride)
    new, old = chip_smoke.turns_ms(lambda: run(wmma=True), run)
    ops = 2 * chip_smoke.conv_macs(BATCH, h, h, ci, co, ksize, stride)
    oh = -(-h // stride)
    alts = []
    for bm, bn in _conv_q.TILES:
        if bn > -(-co // 32) * 32:
            continue
        tw = bm if ksize == 1 else min(bm, 1 << (oh - 1).bit_length())
        for stages in (3, 4, 5):
            other = _conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, stages)
            staged = _conv_q.staged(other, float_in, stride)
            if _conv_q.smem_bytes(other, staged) > _conv_q.SMEM_BYTES:
                continue
            ms = chip_smoke.device_ms(lambda: run(plan=other))
            cost = _conv_q.plan_cost(other, BATCH, h, h, ci, co, ksize,
                                     float_in, stride=stride)
            alts.append(f"{bm}x{bn}s{stages} {ms * 1e3:.1f}/{cost // 1000}")
    print(f"{ksize}x{ksize}/{stride} {kind} {BATCH}x{h}x{h}x{ci}->{co}: "
          f"kernel {new * 1e3:.1f} us, WMMA {old * 1e3:.1f} us, "
          f"{ops / new / 1e9:.0f} TOP/s, equal {torch.equal(run(), run(wmma=True))}, "
          f"plan {tuple(plan)} | tiles (us / cost k): " + ", ".join(alts),
          flush=True)


def sweep_bf16(h, ci, co):
    """The bf16 1x1 (bf16 operands) at one shape: plan, kernel vs its WMMA
    twin, every tile."""
    rng = np.random.default_rng(h + ci)
    m = BATCH * h * h
    x = torch.from_numpy(rng.standard_normal((m, ci)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((co, ci)) / np.sqrt(ci))
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    b, mul, add = (torch.from_numpy(v.astype(np.float32)).cuda() for v in (
        0.1 * rng.standard_normal(co), rng.uniform(0.8, 1.2, co),
        0.1 * rng.standard_normal(co)))
    args = (x, w, b, mul, add, 0.2, torch.bfloat16)

    def run(plan=None):
        return conv_block.pointwise_conv_block(*args, plan=plan)

    plan = _conv_q.conv_plan(1, 1, m, ci, co, 1, esize=2)
    new, old = chip_smoke.turns_ms(
        lambda: conv_block.pointwise_conv_block_wmma(*args), run)
    close = torch.allclose(run().float(), conv_block.pointwise_conv_block_wmma(
        *args).float(), rtol=2e-2, atol=2e-2)
    alts = []
    for bm, bn in _conv_q.TILES:
        if bn > -(-co // 32) * 32:
            continue
        for stages in (3, 4, 5):
            other = _conv_q.Plan(bm, bn, plan.bk, 1, bm, stages)
            if _conv_q.smem_bytes(other) > _conv_q.SMEM_BYTES:
                continue
            ms = chip_smoke.device_ms(lambda: run(plan=other))
            cost = _conv_q.plan_cost(other, 1, 1, m, ci, co, 1, esize=2)
            alts.append(f"{bm}x{bn}s{stages} {ms * 1e3:.1f}/{cost // 1000}")
    print(f"1x1 bf16 operands {BATCH}x{h}x{h}x{ci}->{co}: kernel "
          f"{new * 1e3:.1f} us, WMMA {old * 1e3:.1f} us, "
          f"{2 * m * ci * co / new / 1e9:.0f} TFLOP/s, within 2e-2 {close}, "
          f"plan {tuple(plan)} | tiles (us / cost k): " + ", ".join(alts),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_q_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with torch.inference_mode():
        for shape in (() if "--exit-only" in sys.argv[1:]
                      else PW_BF16_SHAPES):
            sweep_bf16(*shape)
        if "--bf16-only" in sys.argv[1:]:
            return 0
        for h, ci, co in EXIT_SHAPES:
            sweep(h, ci, co, 3, "s8", stride=2)
        if "--exit-only" in sys.argv[1:]:
            return 0
        for h, ci, co in DOWN_SHAPES:
            sweep(h, ci, co, 3, "bf16", stride=2)
        for shape in SHAPES:
            sweep(*shape, "s8")
        for shape in BF16_SHAPES:
            sweep(*shape, "bf16")
    return 0


if __name__ == "__main__":
    sys.exit(main())
