#!/usr/bin/env python3
"""Where the int8 stem-region kernel spends its time: clock64 stamps per
phase, on one NVIDIA GPU, at the flagship's shapes (batch 8, 512 px).

    python3 scripts/region_phase_clock.py

Builds an instrumented copy of `yolov3_tpu_torch/csrc/s2d_region_block_q.cu`
in a temporary directory (the kernels themselves carry no timers): thread
0 of each block adds the cycles of each phase (input copy, each stage with
the barrier after it) to a per-block counter, and each warp adds the
cycles it spends in its products (the A loads and the tensor-core work,
up to their completion) and in its epilogues, per stage. Then runs the
region on a bf16 input with the fast epilogue (the serving path) on the
kernel and on its first design (`s2d_region_block_q_mma`), and the tail
on the kernel, and prints each phase's cycles a tile and share, and a
warp's product and epilogue cycles a tile per stage. The stamps slow the
kernel down; the shares, not the times, are the result. The patches match
the source's text and fail loudly when it has changed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import region_ab  # noqa: E402
from yolov3_tpu_torch.ops import quant  # noqa: E402
from yolov3_tpu_torch.ops.kernels import _build, s2d_region_q  # noqa: E402

SRC = os.path.join(_build.CSRC_DIR, "s2d_region_block_q.cu")
STAGES = ("stem2", "pw", "fb0", "exit")
# a stage's slot from its shape at T = 8: the 1x1; FB0's stride-1 3x3;
# stem2 (19 x 19 pixels) or the exit (8 x 8)
SLOT = "(KS == 1 ? 1 : S == 1 ? 2 : gh * gw > 64 ? 0 : 3)"
BLOCK_ID = ("((static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * "
            "gridDim.x + blockIdx.x)")
PH = ("#define PH(i) if (threadIdx.x == 0) { const long long c_ = clock64(); "
      "g_stamps[" + BLOCK_ID + " * 32 + (i)] += c_ - t_ph; t_ph = c_; }\n")


def patch(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"region_phase_clock: the source changed near "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def warp_timers(src: str, head: str, loop_start: str, epi_start: str,
                loop_end: str) -> str:
    """Time a stage function's products and epilogues per warp."""
    src = patch(src, head, head + "\n  long long t_mma = 0, t_fin = 0;")
    src = patch(src, loop_start, "    const long long c0_ = clock64();\n"
                + loop_start)
    src = patch(src, epi_start, "    __syncwarp();\n"
                "    const long long c1_ = clock64();\n"
                "    t_mma += c1_ - c0_;\n" + epi_start)
    return patch(src, loop_end, loop_end[:-len("  }\n}\n")]
                 + "    __syncwarp();\n    t_fin += clock64() - c1_;\n  }\n"
                 "  if ((threadIdx.x & 31) == 0) {\n"
                 "    long long* s_ = g_stamps + " + BLOCK_ID + " * 32 + 16 "
                 "+ 2 * " + SLOT + ";\n"
                 "    atomicAdd(reinterpret_cast<unsigned long long*>(s_), "
                 "t_mma);\n"
                 "    atomicAdd(reinterpret_cast<unsigned long long*>(s_ + 1)"
                 ", t_fin);\n  }\n}\n")


def instrument(src: str) -> str:
    src = patch(src, "constexpr int kPad = 16;",
                "constexpr int kPad = 16;\n__device__ long long* g_stamps;")
    # the first design's stage (mma.sync) and the kernel's (wgmma)
    src = warp_timers(
        src, "  static_assert(NT == 2 || NT == 4, \"B is one ldmatrix of 2 "
        "or 4 matrices\");",
        "    int acc[MT][NT][4];\n",
        "#pragma unroll\n    for (int j = 0; j < NT; ++j) {\n"
        "      const int o = n0 + 8 * j + 2 * t;\n",
        "        if (r1 < M) fin(r1, r1 / gw, o, cols, acc[i][j][2], "
        "acc[i][j][3]);\n      }\n    }\n  }\n}\n")
    src = warp_timers(
        src, "  const uint32_t base = smem_u32(in.base);",
        "    uint32_t acc[NS / 2];\n",
        "    // accumulator layout: acc[4j + e] is row m0 + lane/4",
        "            static_cast<int>(acc[4 * j + 3]));\n    }\n  }\n}\n")
    # the first design's phases (one tile a block)
    src = patch(src, "  const int R0 = blockIdx.y * T, C0 = blockIdx.x * T;\n",
                "  const int R0 = blockIdx.y * T, C0 = blockIdx.x * T;\n"
                "  long long t_ph = clock64();\n" + PH)
    src = patch(src, "    cp_async_wait_all();\n    __syncthreads();\n"
                "    stage<3, 2, 2>", "    PH(0)\n    cp_async_wait_all();\n"
                "    __syncthreads();\n    PH(1)\n    stage<3, 2, 2>")
    src = patch(src, "    __syncthreads();  // the input tile and stem2's "
                "weights are dead\n", "    __syncthreads();  // the input "
                "tile and stem2's weights are dead\n    PH(2)\n")
    src = patch(src, "  asm volatile(\"cp.async.wait_group 0;\\n\" ::);\n"
                "  __syncthreads();\n  stage<3, 1, 2>",
                "  PH(3)\n  asm volatile(\"cp.async.wait_group 0;\\n\" ::);\n"
                "  __syncthreads();\n  PH(4)\n  stage<3, 1, 2>")
    src = patch(src, "  __syncthreads();\n  stage<3, 2, 1>(q4",
                "  __syncthreads();\n  PH(5)\n  stage<3, 2, 1>(q4")
    src = patch(src, "                         stage_q2(a0, a1, c, p);\n"
                "                 });\n}\n",
                "                         stage_q2(a0, a1, c, p);\n"
                "                 });\n  __syncthreads();\n  PH(6)\n}\n")
    # the kernel's phases, summed over a block's tiles
    loop = "  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
    src = patch(src, loop, "  long long t_ph = clock64();\n" + PH + loop)
    src = patch(src, "    cp_async_wait_all();\n    __syncthreads();\n"
                "    if (kRegion) {\n", "    cp_async_wait_all();\n"
                "    __syncthreads();\n    PH(0)\n    if (kRegion) {\n")
    src = patch(src, "      __syncthreads();  // q2 is complete; the input "
                "tile is free\n", "      __syncthreads();  // q2 is complete;"
                " the input tile is free\n      PH(1)\n")
    src = patch(src, "    __syncthreads();\n    stage90<3, 1>",
                "    __syncthreads();\n    PH(2)\n    stage90<3, 1>")
    src = patch(src, "    __syncthreads();  // q4 is complete; q2 is free\n",
                "    __syncthreads();  // q4 is complete; q2 is free\n"
                "    PH(3)\n")
    src = patch(src, "    __syncthreads();  // q4 is read before the next "
                "tile's stages\n", "    __syncthreads();  // q4 is read before"
                " the next tile's stages\n    PH(4)\n")
    return src + """
extern "C" int set_stamps(long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""


# phase names: the first design's (per block) and the kernel's (per tile)
FIRST = ("weights and input issued, float input quantized", "input waited",
         "stem2", "pw", "weights waited", "fb0", "exit")
KERNEL = ("input waited (and a float input's rest)", "stem2",
          "pw, and the next input's first loads", "fb0, and its next loads",
          "exit, and its last loads")


def report(label, stamps, blocks, tiles, names):
    s = stamps.view(-1, 32)[:blocks].double().cpu()
    per_tile = blocks / tiles
    total = float(s[:, :len(names)].sum(1).mean()) * per_tile
    print(f"{label}: {total:.0f} cycles a tile")
    for k, name in enumerate(names):
        v = float(s[:, k].mean()) * per_tile
        print(f"  {name:48s} {v:8.0f} cycles {100 * v / total:5.1f}%")
    for k, name in enumerate(STAGES):
        mma, fin = (float(s[:, 16 + 2 * k + i].mean()) * per_tile / 16
                    for i in (0, 1))
        print(f"  a warp's {name:5s} products {mma:7.0f}, epilogues "
              f"{fin:7.0f} cycles a tile")


def main() -> int:
    if not torch.cuda.is_available():
        print("region_phase_clock: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with open(SRC) as fh:
        src = instrument(fh.read())
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "region_clock.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(tmp, "region_clock.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    C1, C, CM, CO = region_ab.C1, region_ab.C, region_ab.CM, region_ab.CO
    stages = [region_ab.block(rng, k, ci, co) for k, ci, co in (
        (3, C1, C), (1, C, CM), (3, CM, C), (3, C, CO))]
    ws = [w.cuda() for w, _ in stages]
    rows = [e for _, e in stages] + list(region_ab.SCALES)
    epi = quant.region_epi(*rows, fast=True).cuda()
    tail_epi = quant.tail_epi(*rows[1:]).cuda()
    n, size = region_ab.BATCH, region_ab.SIZE
    x = torch.from_numpy(rng.standard_normal(
        (n, size, size, C1)).astype(np.float32) * 2).cuda().to(torch.bfloat16)
    q2 = torch.from_numpy(rng.integers(
        -127, 128, (n, size // 2, size // 2, C)).astype(np.int8)).cuda()
    tile = s2d_region_q.plan_tile(C1, C, CM, CO, True, epi.shape[1])
    if tile != 8:
        raise SystemExit(f"region_phase_clock: expects T = 8, got {tile}")
    tiles = n * (size // 4 // tile) ** 2
    stamps = torch.zeros(tiles * 32, dtype=torch.int64, device="cuda")
    if lib.set_stamps(stamps.data_ptr()):
        return 1
    # the wrappers' ctypes signatures, on the instrumented library
    s2d_region_q._build._loaded[s2d_region_q.NAME] = lib
    s2d_region_q._fns.clear()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(alpha=0.2, cast_bf16=True, fast=True, inv_in=40.0)
    with torch.inference_mode():
        for label, run, blocks, names in (
                ("first design, region bf16 fast",
                 lambda: s2d_region_q.s2d_region_block_q_mma(x, *ws, epi,
                                                             **kw),
                 tiles, FIRST),
                ("kernel, region bf16 fast",
                 lambda: s2d_region_q.s2d_region_block_q(x, *ws, epi, **kw),
                 min(tiles, sms), KERNEL),
                ("kernel, tail s8 exact",
                 lambda: s2d_region_q.launch(
                     "s2d_tail_block_q", q2, ws[1:], tail_epi, alpha=0.2,
                     cast_bf16=True), min(tiles, sms), KERNEL)):
            run()
            torch.cuda.synchronize()
            stamps.zero_()
            run()
            torch.cuda.synchronize()
            report(label, stamps, blocks, tiles, names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
