#!/usr/bin/env python3
"""What the int8 exit conv's time on the wgmma core is made of, on one
NVIDIA GPU, at the flagship's exit launch (batch 8, s8 256^2 x 64 ->
128).

    python3 scripts/conv_q_probe.py [--clock]

Builds copies of `yolov3_tpu_torch/csrc/exit_conv_block_q.cu` in a
temporary directory, each with one change to the core's s8 stride-2 path
(`csrc/conv_gemm_q_sm90.cuh`, RES: every code of a tile made before any
is stored, staged in shared memory; parts switched off sit behind a
run-time condition that never holds, so the compiler keeps the rest),
and times each copy beside an unpatched copy, in turns (copy, variant,
variant, copy):
- `shared_path`: the exit on the core's common path (each four channels'
  codes stored from the registers as they are made), as the stride-1 s8
  3x3 runs;
- `cvt_pipe`: the epilogue's bf16 cast and quantize on the conversion
  pipe (cvt, rint, float-to-int), as the core's other paths make them,
  instead of on the integer and FMA pipes (the same codes);
- `no_epilogue`: no epilogue arithmetic (the accumulators are still made
  and the staged rows written out);
- `no_mma`: no tensor-core products (the ring still runs);
- `no_a`: no A copies (each stage's barrier completes with the weights'
  bytes alone);
- `loads_only`: no products and no epilogue arithmetic;
- `unstrided`, `loads_unstrided`: the same two with the A map's boxes
  read at element strides of 1 (TH x TW contiguous pixels a tap: the
  bytes a box lands are the same, the pixels are not).
Only `shared_path` and `cvt_pipe` keep the output; the others' are wrong by design, and the
unpatched copy's equals the kernel's. Device time: 20 calls captured in
a CUDA graph, replays timed with CUDA events (`chip_smoke.device_ms`).
The patches match the source's text and fail loudly when it has
changed.

With `--clock`, one more copy carries clock64 stamps in the consumer
warpgroups of the s8 stride-2 path instead, and the script prints a
warp's cycles a tile in each phase: waiting on the ring's full barriers,
the rest of the K loop (the products and their waits), loading the
tile's epilogue rows (with its two barriers), the epilogue arithmetic,
and staging and writing out the codes. The stamps slow the kernel down;
the shares, not the times, are the result.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402
from yolov3_tpu_torch.ops import quant  # noqa: E402
from yolov3_tpu_torch.ops.kernels import _build, _conv_q  # noqa: E402
from yolov3_tpu_torch.ops.kernels import exit_conv_q  # noqa: E402

NAME = exit_conv_q.NAME
CORE = "conv_gemm_q_sm90.cuh"
ENTRY = f"{NAME}.cu"
NEVER = "p.alpha > 1e30f"
RES_ON = "#define CONVQ90_S8_STRIDE2\n"
CAST_BITS = ("    if (p.cast_bf16) v = bf16_round_bits(v);\n"
             "    q[i] = quantize_bits(v, iv[i]);")
CAST_CVT = ("    if (p.cast_bf16) v = bf16_round(v);\n"
            "    q[i] = static_cast<uint8_t>(quantize(v, iv[i]));")
CODES = "codes[j] = codes4<BN>(p, e, v, 8 * j + 4 * (q >> 1));"
MMA = "          Mma<BN, OP>::run(acc, smem_desc(sa + kk, p.bk),"
A_TX = "          mbar_arrive_tx(full, stage_bytes);"
A_COPY = "          if (p.ksize == 1)\n            tma_2d(sa, &map_a, full"
# (file, old, new) of each variant
PATCHES = {
    "shared_path": [(ENTRY, RES_ON, "")],
    "cvt_pipe": [(CORE, CAST_BITS, CAST_CVT)],
    "no_epilogue": [(CORE, CODES, CODES.replace(
        "codes4<BN>(p, e, v, 8 * j + 4 * (q >> 1))",
        f"{NEVER} ? codes4<BN>(p, e, v, 8 * j + 4 * (q >> 1)) : v[0] ^ v[1]"
    ))],
    "no_mma": [(CORE, MMA, f"          if ({NEVER})\n" + MMA)],
    "no_a": [(CORE, A_TX, A_TX.replace("stage_bytes",
                                       f"{NEVER} ? stage_bytes : b_bytes")),
             (CORE, A_COPY, f"          if (!({NEVER})) {{}} else\n"
              + A_COPY)],
}
PATCHES["loads_only"] = PATCHES["no_mma"] + PATCHES["no_epilogue"]
STRIDE = "      const cuuint32_t s = static_cast<cuuint32_t>(p.stride);"
PATCHES["unstrided"] = [(CORE, STRIDE, "      const cuuint32_t s = 1;")]
PATCHES["loads_unstrided"] = PATCHES["loads_only"] + PATCHES["unstrided"]
PHASES = ("full-barrier waits", "rest of the K loop", "epilogue rows",
          "epilogue arithmetic", "staging and write-out")


def stamp(k: int) -> str:
    """Add the cycles since the last stamp to phase k."""
    return (f"{{ const long long n_ = clock64(); t_ph[{k}] += n_ - c_; "
            f"c_ = n_; }}\n")


CLOCK = [
    (CORE, "constexpr int kWG = 128;",
     "constexpr int kWG = 128;\n__device__ long long g_stamps[8];"),
    (CORE, "        reinterpret_cast<uint8_t*>(e_all + nwg * 4 * BN) + g * 64 * "
     "kStageRow;\n",
     "        reinterpret_cast<uint8_t*>(e_all + nwg * 4 * BN) + g * 64 * "
     "kStageRow;\n    long long t_ph[6] = {0, 0, 0, 0, 0, 0}, c_ = 0;\n"),
    (CORE, "      uint32_t acc[BN / 2];\n",
     "      c_ = clock64();\n      uint32_t acc[BN / 2];\n"),
    (CORE, "        mbar_wait(bars + 8 * s, (it / stages) & 1);\n",
     "        { const long long w_ = clock64();\n"
     "        mbar_wait(bars + 8 * s, (it / stages) & 1);\n"
     "        t_ph[0] += clock64() - w_; }\n"),
    (CORE, "      if (lane == 0) mbar_arrive(bars + 8 * (stages + (it - 1) % "
     "stages));\n",
     "      if (lane == 0) mbar_arrive(bars + 8 * (stages + (it - 1) % "
     "stages));\n" + stamp(1)),
    (CORE, "      named_barrier(1 + g);\n\n      if constexpr (RES) {\n",
     "      named_barrier(1 + g);\n" + stamp(2) + "\n"
     "      if constexpr (RES) {\n"),
    (CORE, "        uint8_t* const mine =\n",
     stamp(3) + "        uint8_t* const mine =\n"),
    (CORE, "        continue;\n",
     stamp(4) + "        t_ph[5] += 1;\n"
     "        if (t + static_cast<int>(gridDim.x) >= p.tiles && lane == 0)\n"
     "          for (int k_ = 0; k_ < 6; ++k_)\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(\n"
     "                          &g_stamps[k_]),\n"
     "                      static_cast<unsigned long long>(k_ == 1 ? "
     "t_ph[1] - t_ph[0] : t_ph[k_]));\n"
     "        continue;\n"),
    (ENTRY, "CONVQ90_ENTRY(exit_conv_block_q, EXIT_CONV_CHECK)",
     "CONVQ90_ENTRY(exit_conv_block_q, EXIT_CONV_CHECK)\n"
     "extern \"C\" int probe_stamps(long long* out, int reset) {\n"
     "  static const long long zero[8] = {};\n"
     "  return static_cast<int>(reset\n"
     "      ? cudaMemcpyToSymbol(convq90::g_stamps, zero, sizeof(zero))\n"
     "      : cudaMemcpyFromSymbol(out, convq90::g_stamps, sizeof(zero)));\n"
     "}"),
]


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"conv_q_probe: the source changed near "
                         f"{old[:60]!r}")
    return src.replace(old, new)


def build(tmp: str, variant: str):
    """The exit entry of a copy of the library with `variant`'s patches
    (none for "copy"; "clock": the stamps), bound as `_conv_q` binds it,
    and the library."""
    src_dir = os.path.join(tmp, variant)
    os.makedirs(src_dir)
    for f in os.listdir(_build.CSRC_DIR):
        if f.endswith(".cuh") or f == f"{NAME}.cu":
            shutil.copy(os.path.join(_build.CSRC_DIR, f), src_dir)
    for f, old, new in (CLOCK if variant == "clock"
                        else PATCHES.get(variant, [])):
        path = os.path.join(src_dir, f)
        with open(path) as fh:
            src = patch(fh.read(), old, new)
        with open(path, "w") as fh:
            fh.write(src)
    lib = os.path.join(tmp, f"{variant}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                        os.path.join(src_dir, ENTRY)], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"conv_q_probe: nvcc failed for {variant}:\n"
                         f"{r.stderr}")
    cdll = ctypes.CDLL(lib)
    fn = getattr(cdll, NAME)
    ref = _conv_q._kernel_fn(NAME, NAME, True)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn, cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_q_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    n, h, ci, co = 8, 256, 64, 128
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, h, ci)).astype(
        np.int8)).cuda()
    w_t = torch.from_numpy(rng.integers(-20, 21, (9, co, ci)).astype(
        np.int8)).cuda()
    epi = quant.exit_epi(torch.from_numpy(np.stack([
        rng.standard_normal(co) * 50, rng.random(co) * 0.01 + 0.001,
        rng.standard_normal(co) * 0.1]).astype(np.float32)), 0.07).cuda()
    kw = dict(alpha=0.2, cast_bf16=True)
    plan = _conv_q.conv_plan(n, h, h, ci, co, 3, stride=2)
    print(f"exit {n}x{h}x{h}x{ci}->{co}, plan {tuple(plan)}", flush=True)
    want = exit_conv_q.exit_conv_block_q(x, w_t, epi, **kw)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        clock = "--clock" in sys.argv[1:]
        variants = ["copy", *PATCHES] + (["clock"] if clock else [])
        with concurrent.futures.ThreadPoolExecutor() as pool:
            libs = dict(zip(variants, pool.map(lambda v: build(tmp, v),
                                               variants)))
        fns = {v: fn for v, (fn, _) in libs.items()}

        def run(variant):
            _conv_q._fns[NAME] = fns[variant]
            return exit_conv_q.exit_conv_block_q(x, w_t, epi, **kw)

        try:
            if not torch.equal(run("copy"), want):
                raise SystemExit("conv_q_probe: the copy differs from the "
                                 "kernel")
            for variant in PATCHES:
                new, old = chip_smoke.turns_ms(lambda: run("copy"),
                                               lambda: run(variant))
                same = torch.equal(run(variant), want)
                print(f"{variant:12s} {new * 1e3:7.1f} us beside the copy's "
                      f"{old * 1e3:7.1f} us (output equal: {same})",
                      flush=True)
            if clock:
                read = libs["clock"][1].probe_stamps
                read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                out = np.zeros(8, np.int64)
                if read(None, 1):
                    raise SystemExit("conv_q_probe: stamps not reset")
                reps = 10
                for _ in range(reps):
                    run("clock")
                torch.cuda.synchronize()
                if read(out.ctypes.data, 0):
                    raise SystemExit("conv_q_probe: stamps not read")
                # each warp stamps each of its tiles
                tiles = out[5]
                total = out[:5].sum()
                print(f"clock: {tiles // reps} warp-tiles a call, "
                      f"{total / tiles:.0f} cycles a warp-tile", flush=True)
                for k, name in enumerate(PHASES):
                    print(f"  {name:24s} {out[k] / tiles:8.0f} cycles "
                          f"({100 * out[k] / total:5.1f}%)", flush=True)
        finally:
            _conv_q._fns.pop(NAME, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
