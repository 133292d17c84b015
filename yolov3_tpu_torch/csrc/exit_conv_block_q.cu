// The stem region's exit ConvBlock, s8 in and s8 out, for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/exit_conv_kernel.py::exit_conv_block_q.
// The TPU kernel runs the space-to-depth lift of the exit conv, a
// [2, 2, 4Ci, Co] window conv; in the plain NHWC layout that conv is the
// 3x3 stride-2 conv with XLA's SAME padding ((0, 1) on an even input, (1,
// 1) on an odd one), an implicit GEMM over the s8 input. Input:
// FeatureBlock_0's output already quantized with ConvBlock_2's scale;
// output: FeatureBlock_1's s8 input. The epilogue is the JAX kernel's,
//
//     y = leaky(acc + b/dq) * (mul*dq) + add;  [cast_bf16] y = bf16(y)
//     out = clip(rint(y * inv_next))
//
// with epi f32 [4, co] = (b/dq, mul*dq, add, 1/s_next) as the JAX contract
// has it (`inv_next_row`).
//
// What bounds it: at the flagship (s8 8x256x256x64 -> 8x128x128x128)
// 8*128^2*128*9*64 = 9.7 G MACs (0.0098 ms of int8 products at 1979
// TOP/s) against 33.6 MB in and 16.8 MB out (0.015 ms at 3.35 TB/s):
// bytes. It runs the wgmma core (conv_gemm_q_sm90.cuh) with its s8 input
// through TMA: the A map traverses H and W with element strides of 2, so
// each tap's box lands the TH x TW output rectangle's input pixels dense
// in the ring, zero-filled where the SAME padding lies outside the image,
// with no converting producer and no im2col. A block's pixels are a
// TH x TW rectangle of the output image (ops/kernels/_conv_q.py::
// conv_plan; TW <= 128, half TMA's 256-element box). This library builds
// the core's s8 stride-2 path (CONVQ90_S8_STRIDE2): an epilogue that
// makes all of a tile's codes without the conversion pipe before it
// stores any, then writes them out in whole rows through shared memory;
// on the flagship launch it ran ~0.060 ms against the common path's
// ~0.076 (scripts/conv_q_probe.py, PERF.md). Most of the rest is the K
// loop with its copies (~0.049 ms with no epilogue arithmetic), not
// their stride: boxes read at stride 1 take as long.
//
// exit_conv_block_q_wmma is the same contract on the first design's WMMA
// core (conv_block_q.cuh), kept for A/B timing only; no serving path
// calls it.
#include "conv_block_q.cuh"
// the core's s8 stride-2 path: a tile's codes staged, then whole rows out
#define CONVQ90_S8_STRIDE2
#include "conv_gemm_q_sm90.cuh"

#define EXIT_CONV_CHECK                                                     \
  (x_kind == convq::kS8 && ksize == 3 && stride == 2 && res_in == nullptr && \
   res_out == nullptr && oh == (h + 1) / 2 && ow == (wd + 1) / 2 &&         \
   pad_t == h % 2 && pad_l == wd % 2 && out_s8 != nullptr &&               \
   out_f == nullptr && inv_next_row == 1)

CONVQ90_ENTRY(exit_conv_block_q, EXIT_CONV_CHECK)
CONVQ_ENTRY(exit_conv_block_q_wmma, EXIT_CONV_CHECK)
