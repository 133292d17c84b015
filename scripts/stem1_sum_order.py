#!/usr/bin/env python3
"""How far the stem region kernel's stem1 sums on tensor cores lie from the
plain version's (the same products summed in order, in f32), on one NVIDIA
GPU, at the flagship's shapes (batch 8, 512 px, a bf16 image).

    python3 scripts/stem1_sum_order.py

Builds a copy of `yolov3_tpu_torch/csrc/s2d_region_block_q.cu` in a
temporary directory in which `stem1_wg` also takes every on-image sum
again in order (`stem1_sum`) and histograms |tensor cores - in order| / S,
S the sum of the products' magnitudes that the kernel's second GEMM gives;
it also counts the sums at a bf16 rounding midpoint, those in doubt under
the kernel's bound (`bf16_in_doubt` with `kDoubt`) and the trailing zero
bits of the sums (their precision). Random weights and a z-scored-like
image from a numpy seed. The patch matches the source's text and fails
loudly when it has changed.
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
# the histogram's slots: 1-47 the distance's power of two (slot 40 + e for
# [2^e, 2^(e+1)) of S), 0 equal sums, then the counts below
AT_MID, ZERO_LOW, SUMS, DOUBT, FAR, ZEROS = 48, 49, 50, 70, 71, 72
TRAILING = 51  # 51 + z: sums whose lowest set bit is z (16: none below bf16)

PROBE = '''    // every on-image sum again in order, its distance from the
    // tensor cores' in units of S (the sums' bits through an f32 add of
    // +0, as the kernel reads them)
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) {
      const int hh = (k >> 1) & 1;
      if (!on[hh]) continue;
      const int oo = n0 + 8 * (k >> 2) + 2 * t + (k & 1);
      const float sq = stem1_sum(patch, q, w, p.c1, pi[hh], pj[hh], oo);
      const float v = __fadd_rn(__uint_as_float(acc[k]), 0.0f);
      const float S = __uint_as_float(mag[k]);
      const uint32_t bits = __float_as_uint(v);
      const float d = fabsf(v - sq);
      int bin = 0;
      if (d > 0.0f) bin = min(47, max(1, 40 + ilogbf(d / fmaxf(S, 1e-30f))));
      atomicAdd(g_hist + bin, 1ull);
      const uint32_t tt = bits & 0xffff0000u;
      if (v == __uint_as_float(tt | 0x8000u)) atomicAdd(g_hist + 48, 1ull);
      if ((bits & 0xffffu) == 0) atomicAdd(g_hist + 49, 1ull);
      atomicAdd(g_hist + 50, 1ull);
      atomicAdd(g_hist + 51 + min(16, __ffs(bits | 0x10000u) - 1), 1ull);
      float lo_, hi_;
      bool far_;
      if (bf16_in_doubt(v, __fmul_rn(S, kDoubt), lo_, hi_, far_))
        atomicAdd(g_hist + 70, 1ull);
      if (far_) atomicAdd(g_hist + 71, 1ull);
      if (v == 0.0f) atomicAdd(g_hist + 72, 1ull);
    }
'''
ANCHOR = ("    // The sums in doubt: a bit each. bf16_in_doubt works on a "
          "sum's bits\n")


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"stem1_sum_order: the source changed near "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def main() -> int:
    if not torch.cuda.is_available():
        print("stem1_sum_order: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with open(SRC) as fh:
        src = fh.read()
    src = patch(src, "constexpr int kPad = 16;",
                "constexpr int kPad = 16;\n"
                "__device__ unsigned long long* g_hist;")
    src = patch(src, ANCHOR, PROBE + ANCHOR)
    src += ('\nextern "C" int set_hist(unsigned long long* p) {\n'
            '  return static_cast<int>(cudaMemcpyToSymbol(g_hist, &p, '
            'sizeof(p)));\n}\n')
    tmp = tempfile.mkdtemp()
    path, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
    with open(path, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.set_hist.argtypes = [ctypes.c_void_p]
    hist = torch.zeros(80, dtype=torch.int64, device="cuda")
    if lib.set_hist(hist.data_ptr()):
        return 1
    # the wrappers' ctypes signatures, on the probe's library
    s2d_region_q._build._loaded[s2d_region_q.NAME] = lib
    s2d_region_q._fns.clear()
    rng = np.random.default_rng(0)
    C1, C, CM, CO = region_ab.C1, region_ab.C, region_ab.CM, region_ab.CO
    stages = [region_ab.block(rng, k, ci, co) for k, ci, co in (
        (3, C1, C), (1, C, CM), (3, CM, C), (3, C, CO))]
    ws = [w.cuda() for w, _ in stages]
    rows = [e for _, e in stages] + list(region_ab.SCALES)
    n, size = region_ab.BATCH, region_ab.SIZE
    image = torch.from_numpy(rng.standard_normal(
        (n, size, size, 3)).astype(np.float32)).cuda().to(torch.bfloat16)
    w_s1 = torch.from_numpy((rng.standard_normal((9, C1, 3)) / np.sqrt(27))
                            .astype(np.float32)).cuda().to(torch.bfloat16)
    stem1 = [torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.standard_normal(C1), rng.uniform(0.8, 1.2, C1),
        0.1 * rng.standard_normal(C1))]
    epi = quant.with_stem1(quant.region_epi(*rows, fast=True), stem1, 0.04,
                           fast=True).cuda()
    with torch.inference_mode():
        s2d_region_q.s2d_region_block_q(image, *ws, epi, alpha=0.2,
                                        cast_bf16=True, fast=True,
                                        w_s1=w_s1)
    torch.cuda.synchronize()
    h = hist.cpu().tolist()
    n_sums = h[SUMS]
    print(f"{n_sums} on-image stem1 sums; equal to the in-order sum: "
          f"{h[0] / n_sums:.4f}")
    for b in range(1, 48):
        if h[b]:
            print(f"  |tensor cores - in order| / S in [2^{b - 40}, "
                  f"2^{b - 39}): {h[b] / n_sums:.3e}")
    print(f"at a bf16 midpoint: {h[AT_MID] / n_sums:.3e}; low 16 bits zero: "
          f"{h[ZERO_LOW] / n_sums:.3e}; in doubt under kDoubt: "
          f"{h[DOUBT] / n_sums:.4%} (far {h[FAR] / n_sums:.4%}); zero sums "
          f"{h[ZEROS] / n_sums:.3e}")
    print("trailing zero bits of the sums:",
          {z: round(h[TRAILING + z] / n_sums, 4) for z in range(17)
           if h[TRAILING + z]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
