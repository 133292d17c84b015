#!/usr/bin/env python3
"""Time the int8 stem-region kernel and its tail entry against their first
design (the `_mma` twins) at the flagship's shapes, on one NVIDIA GPU.

    python3 scripts/region_ab.py

The flagship's stem region at batch 8 (512 px: stem1's output 8 x 512 x
512 x 32 -> stem2 64 -> FeatureBlock_0 32 / 64 -> exit 128): the region on
a bf16 input (the serving path) and on an s8 input, with the fast and the
exact epilogue, and the tail on stem2's s8 output; the `rawimg` region on
a bf16 image (stem1 on tensor cores) against its twin with stem1 on CUDA
cores (`s2d_region_block_q_cores`), with the fast and the exact epilogue.
For each: the kernel's and the twin's device time timed in turns (twin,
kernel, kernel, twin; `chip_smoke.device_ms`) and whether their codes are
equal (for `rawimg`, the share of codes that differ and by how much: the
tensor cores sum stem1 in their own order, the twin in the plain
version's). Random weights of folded blocks and random inputs from a
numpy seed.
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
from yolov3_tpu_torch.ops.kernels import s2d_region_q, s2d_tail_q  # noqa: E402

BATCH, SIZE = 8, 512
C1, C, CM, CO = 32, 64, 32, 128  # the flagship's stem widths
SCALES = (0.04, 0.05, 0.06, 0.07)  # s2..s5


def block(rng, k, ci, co):
    """s8 weights [k*k, co, ci] and epi rows of a random folded block."""
    w = torch.from_numpy((rng.standard_normal((co, ci, k, k))
                          / np.sqrt(k * k * ci)).astype(np.float32))
    b, g, o, m = (torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.standard_normal(co), rng.uniform(0.8, 1.2, co),
        0.1 * rng.standard_normal(co), 0.1 * rng.standard_normal(co)))
    mul, add = quant.bn_affine(g, o, m, torch.from_numpy(
        rng.uniform(0.5, 1.5, co).astype(np.float32)), 1e-3)
    return quant.fold_conv_block(w, b, mul, add, 0.05)


def main() -> int:
    if not torch.cuda.is_available():
        print("region_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    stages = [block(rng, k, ci, co) for k, ci, co in (
        (3, C1, C), (1, C, CM), (3, CM, C), (3, C, CO))]
    ws = [w.cuda() for w, _ in stages]
    rows = [e for _, e in stages] + list(SCALES)
    epi = {fast: quant.region_epi(*rows, fast=fast).cuda()
           for fast in (False, True)}
    tail_epi = quant.tail_epi(*rows[1:]).cuda()
    x = torch.from_numpy(rng.standard_normal(
        (BATCH, SIZE, SIZE, C1)).astype(np.float32) * 2).cuda()
    inputs = {"bf16": x.to(torch.bfloat16),
              "s8": quant.quantize_act(x, 40.0)}
    q2 = torch.from_numpy(rng.integers(
        -127, 128, (BATCH, SIZE // 2, SIZE // 2, C)).astype(np.int8)).cuda()
    R, TL = s2d_region_q, s2d_tail_q
    cases = [(f"region {kind} fast={fast}",
              R.s2d_region_block_q, R.s2d_region_block_q_mma,
              (inputs[kind], *ws, epi[fast]),
              dict(alpha=0.2, cast_bf16=True, fast=fast,
                   inv_in=40.0 if kind == "bf16" else None))
             for kind, fast in (("bf16", True), ("s8", True),
                                ("bf16", False))]
    cases.append(("tail s8 exact", TL.s2d_tail_block_q,
                  TL.s2d_tail_block_q_mma, (q2, *ws[1:], tail_epi),
                  dict(alpha=0.2, cast_bf16=True)))
    # the rawimg region: a z-scored-like bf16 image, stem1's weights and
    # its rows (s1 = 0.04)
    image = torch.from_numpy(rng.standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)).cuda().to(torch.bfloat16)
    w_s1 = torch.from_numpy((rng.standard_normal((9, C1, 3)) / np.sqrt(27))
                            .astype(np.float32)).cuda().to(torch.bfloat16)
    stem1 = [torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.standard_normal(C1), rng.uniform(0.8, 1.2, C1),
        0.1 * rng.standard_normal(C1))]
    for fast in (True, False):
        img_epi = quant.with_stem1(epi[fast].cpu(), stem1, 0.04,
                                   fast=fast).cuda()
        cases.append((f"rawimg bf16 image fast={fast}",
                      R.s2d_region_block_q, R.s2d_region_block_q_cores,
                      (image, *ws, img_epi),
                      dict(alpha=0.2, cast_bf16=True, fast=fast, w_s1=w_s1)))
    with torch.inference_mode():
        for label, kern, twin, args, kw in cases:
            new, old = chip_smoke.turns_ms(lambda: twin(*args, **kw),
                                           lambda: kern(*args, **kw))
            d = (kern(*args, **kw).int() - twin(*args, **kw).int()).abs()
            print(f"{label}: kernel {new:.4f} ms, first design {old:.4f} ms, "
                  f"equal codes {not bool(d.any())} ({int(d.max())} at most, "
                  f"{100 * float((d > 0).float().mean()):.4f}% differ)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
