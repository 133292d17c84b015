#!/usr/bin/env python3
"""Where the int8 stem-region kernel spends its time: clock64 stamps per
phase, on one NVIDIA GPU, at the flagship's shapes (batch 8, 512 px).

    python3 scripts/region_phase_clock.py [--image-only]

Builds an instrumented copy of `yolov3_tpu_torch/csrc/s2d_region_block_q.cu`
in a temporary directory (the kernels themselves carry no timers): thread
0 of each block adds the cycles of each phase (input copy, each stage with
the barrier after it) to a per-block counter, and each warp adds the
cycles it spends in its products (the A loads and the tensor-core work,
up to their completion) and in its epilogues, per stage. Then runs the
region on a bf16 input with the fast epilogue on the kernel and on its
first design (`s2d_region_block_q_mma`), the tail on the kernel, and the
`rawimg` region on a bf16 image with the fast epilogue (the serving path
of that mode) with stem1 on tensor cores and on CUDA cores (the `_cores`
twin), and prints each phase's cycles a tile and share (for the image:
the patch's wait, or its load, and stem1 with its epilogue first), and a
warp's product and epilogue cycles a tile per stage (and stem1's on
tensor cores, with the shares of its sums in doubt and of those taken
again in the plain order). `--image-only` runs the two image cases alone. The stamps
slow the kernel down; the shares, not the times, are the result. The
patches match the source's text and fail loudly when it has changed.
"""

from __future__ import annotations

import argparse
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
TILE = 8  # the flagship's output tile
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
                loop_end: str, slot: str = SLOT) -> str:
    """Time a stage function's products and epilogues per warp, in the
    stamps of `slot` (0-3 the stages, 4 stem1)."""
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
                 "+ 2 * " + slot + ";\n"
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
        "    uint32_t acc[NS / 2];\n#pragma unroll\n    for (int i = 0;",
        "    // accumulator layout: acc[4j + e] is row m0 + lane/4 (+8 for e "
        ">= 2),\n    // channel n0 + 8j + 2 (lane % 4) + (e & 1)\n"
        "    const int r0",
        "            static_cast<int>(acc[4 * j + 3]));\n    }\n  }\n}\n")
    # stem1 on tensor cores: the sums in doubt and those taken again, per
    # block (stamps 30 and 31); its products (the A loads and both GEMMs),
    # and its epilogue (the sums in doubt, those taken again, the codes)
    src = patch(src, "  const uint32_t zero = static_cast<uint32_t>(p.tile) "
                ">> 31;\n", "  const uint32_t zero = static_cast<uint32_t>("
                "p.tile) >> 31;\n  unsigned n_doubt_ = 0, n_redo_ = 0;\n")
    src = patch(src, "      doubt &= doubt - 1;\n",
                "      doubt &= doubt - 1;\n      ++n_doubt_;\n")
    src = patch(src, "        const int slot = atomicAdd(redo, 1);\n",
                "        ++n_redo_;\n        const int slot = atomicAdd(redo, "
                "1);\n")
    src = patch(src, "    char2 out[NS / 8][2];\n",
                "    {\n      const unsigned d_ = __reduce_add_sync(~0u, "
                "n_doubt_);\n      const unsigned r_ = __reduce_add_sync(~0u, "
                "n_redo_);\n      if ((threadIdx.x & 31) == 0) {\n"
                "        long long* s_ = g_stamps + " + BLOCK_ID + " * 32;\n"
                "        atomicAdd(reinterpret_cast<unsigned long long*>(s_ + "
                "30), static_cast<unsigned long long>(d_));\n"
                "        atomicAdd(reinterpret_cast<unsigned long long*>(s_ + "
                "31), static_cast<unsigned long long>(r_));\n      }\n"
                "      n_doubt_ = n_redo_ = 0;\n    }\n"
                "    char2 out[NS / 8][2];\n")
    src = warp_timers(
        src, "  const int M = XW * XW, nsl = p.c1 / NS;",
        "    uint32_t a[3][4];\n",
        "    // The sums in doubt: a bit each. bf16_in_doubt works on a sum's "
        "bits\n",
        "              out[jn][h];\n  }\n}\n", slot="4")
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
                "    if constexpr (kTC) {\n", "    cp_async_wait_all();\n"
                "    __syncthreads();\n    PH(0)\n    if constexpr (kTC) {\n")
    # an image's patch: loaded and waited (CUDA cores), or waited and, at
    # the image's edges, fixed (tensor cores)
    src = patch(src, "      cp_async_wait_all();  // the weights and the epi "
                "table, first tile\n      __syncthreads();\n",
                "      cp_async_wait_all();  // the weights and the epi "
                "table, first tile\n      __syncthreads();\n      PH(5)\n")
    src = patch(src, "      stem1_tc(x, smem + L.img, q,",
                "      PH(5)\n      stem1_tc(x, smem + L.img, q,")
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
# the rawimg region's (phase 5 first): stem1 on tensor cores, or on CUDA
# cores from a patch loaded at the tile's start
IMAGE = {
    "tc": ("patch waited, fixed at the image's edges",
           "stem1 on tensor cores and its epilogue",
           "stem2, next patch issued",
           *KERNEL[2:]),
    "cores": ("patch loaded (f32) and waited", "stem1 on CUDA cores and its "
              "epilogue", *KERNEL[1:]),
}


def report(label, stamps, blocks, tiles, names, image=False):
    """Print each phase's cycles a tile and share, and a warp's product and
    epilogue cycles a tile per stage (stem1's as slot 4)."""
    s = stamps.view(-1, 32)[:blocks].double().cpu()
    per_tile = blocks / tiles
    order = [5, 0, 1, 2, 3, 4] if image else list(range(len(names)))
    total = float(s[:, order].sum(1).mean()) * per_tile
    print(f"{label}: {total:.0f} cycles a tile")
    for k, name in zip(order, names):
        v = float(s[:, k].mean()) * per_tile
        print(f"  {name:48s} {v:8.0f} cycles {100 * v / total:5.1f}%")
    for k, name in enumerate(STAGES + ("stem1",)):
        mma, fin = (float(s[:, 16 + 2 * k + i].mean()) * per_tile / 16
                    for i in (0, 1))
        if mma or fin:
            print(f"  a warp's {name:5s} products {mma:7.0f}, epilogues "
                  f"{fin:7.0f} cycles a tile")
    if image and s[:, 30].sum():
        # the x tiles' stem1 sums
        sums = tiles * (4 * TILE + 7) ** 2 * region_ab.C1
        print(f"  stem1 sums in doubt {100 * float(s[:, 30].sum()) / sums:.4f}"
              f"%, taken again in the plain order "
              f"{100 * float(s[:, 31].sum()) / sums:.4f}%")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--image-only", action="store_true",
                        help="only the rawimg region on a bf16 image")
    args = parser.parse_args(argv)
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
    # the rawimg region: a z-scored-like bf16 image, stem1's weights and
    # rows (its fast epilogue, s1 = 0.04)
    image = torch.from_numpy(rng.standard_normal(
        (n, size, size, 3)).astype(np.float32)).cuda().to(torch.bfloat16)
    w_s1 = torch.from_numpy((rng.standard_normal((9, C1, 3)) / np.sqrt(27))
                            .astype(np.float32)).cuda().to(torch.bfloat16)
    stem1 = [torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.standard_normal(C1), rng.uniform(0.8, 1.2, C1),
        0.1 * rng.standard_normal(C1))]
    img_epi = quant.with_stem1(quant.region_epi(*rows, fast=True).cpu(),
                               stem1, 0.04, fast=True).cuda()
    for ci, cores in ((0, False), (3, False), (3, True)):
        tile = s2d_region_q.plan_tile(C1, C, CM, CO, True, img_epi.shape[1],
                                      ci=ci, cores=cores)
        if tile != TILE:
            raise SystemExit(f"region_phase_clock: expects T = {TILE}, got "
                             f"{tile}")
    tile = TILE
    tiles = n * (size // 4 // tile) ** 2
    stamps = torch.zeros(tiles * 32, dtype=torch.int64, device="cuda")
    if lib.set_stamps(stamps.data_ptr()):
        return 1
    # the wrappers' ctypes signatures, on the instrumented library
    s2d_region_q._build._loaded[s2d_region_q.NAME] = lib
    s2d_region_q._fns.clear()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(alpha=0.2, cast_bf16=True, fast=True, inv_in=40.0)
    img_kw = dict(alpha=0.2, cast_bf16=True, fast=True, w_s1=w_s1)
    R = s2d_region_q
    cases = [
        ("first design, region bf16 fast",
         lambda: R.s2d_region_block_q_mma(x, *ws, epi, **kw), tiles, FIRST),
        ("kernel, region bf16 fast",
         lambda: R.s2d_region_block_q(x, *ws, epi, **kw), min(tiles, sms),
         KERNEL),
        ("kernel, tail s8 exact",
         lambda: R.launch("s2d_tail_block_q", q2, ws[1:], tail_epi,
                          alpha=0.2, cast_bf16=True), min(tiles, sms),
         KERNEL)]
    if args.image_only:
        cases = []
    cases += [
        ("kernel, rawimg bf16 image fast, stem1 on tensor cores",
         lambda: R.s2d_region_block_q(image, *ws, img_epi, **img_kw),
         min(tiles, sms), IMAGE["tc"]),
        ("twin, rawimg bf16 image fast, stem1 on CUDA cores",
         lambda: R.s2d_region_block_q_cores(image, *ws, img_epi, **img_kw),
         min(tiles, sms), IMAGE["cores"])]
    with torch.inference_mode():
        for label, run, blocks, names in cases:
            run()
            torch.cuda.synchronize()
            stamps.zero_()
            run()
            torch.cuda.synchronize()
            report(label, stamps, blocks, tiles, names,
                   image=names in IMAGE.values())
    return 0


if __name__ == "__main__":
    sys.exit(main())
