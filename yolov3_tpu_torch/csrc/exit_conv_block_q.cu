// The stem region's exit ConvBlock, s8 in and s8 out, for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/exit_conv_kernel.py::exit_conv_block_q.
// The TPU kernel runs the space-to-depth lift of the exit conv, a
// [2, 2, 4Ci, Co] window conv; in the plain NHWC layout that conv is the
// 3x3 stride-2 conv with SAME padding ((0, 1) on an even input), which the
// implicit GEMM of conv_block_q.cuh computes exactly. Input: FeatureBlock_0's
// output already quantized with ConvBlock_2's scale; output: FeatureBlock_1's
// s8 input. The epilogue is the JAX kernel's,
//
//     y = leaky(acc + b/dq) * (mul*dq) + add;  [cast_bf16] y = bf16(y)
//     out = clip(rint(y * inv_next))
//
// with epi f32 [4, co] = (b/dq, mul*dq, add, 1/s_next) as the JAX contract
// has it. What bounds it: at the flagship (s8 8x256x256x64 -> 8x128x128x128)
// 4.8 G MACs (0.0049 ms at 1979 TOP/s) against 33.6 MB in and 16.8 MB out
// (0.015 ms): bytes.
#include "conv_block_q.cuh"

extern "C" int exit_conv_block_q(const int8_t* x, const int8_t* w,
                                 const float* epi, int8_t* out, int n, int h,
                                 int wd, int ci, int co, float alpha,
                                 int cast_bf16, cudaStream_t stream) {
  if (x == nullptr || out == nullptr || n < 0 || h < 1 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int oh = (h + 1) / 2, ow = (wd + 1) / 2;
  // XLA SAME for k = 3, s = 2: the odd pixel of the padding goes last
  const int pad_t = ((oh - 1) * 2 + 3 - h) / 2;
  const int pad_l = ((ow - 1) * 2 + 3 - wd) / 2;
  convq::Params p{};
  p.x = x;
  p.w = w;
  p.epi = epi;
  p.out_s8 = out;
  p.n = n;
  p.h = h;
  p.w_ = wd;
  p.ci = ci;
  p.co = co;
  p.oh = oh;
  p.ow = ow;
  p.ksize = 3;
  p.stride = 2;
  p.pad_t = pad_t;
  p.pad_l = pad_l;
  p.alpha = alpha;
  p.cast_bf16 = cast_bf16;
  p.inv_next_row = 1;
  return convq::launch(p, convq::kS8, stream);
}
