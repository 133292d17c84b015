// int8 1x1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/pointwise_kernel.py::
// pointwise_conv_block_q: over the flattened pixels of an NHWC tensor, the
// optional in-kernel quantize of a bf16 (or f32) input, with the optional
// requantized residual added first (t = bf16(bf16(rq * s_res) + x)), one
// int8 x int8 -> int32 matrix product, the folded epilogue, and the next
// conv's quantize; optionally the bf16 (or f32) block output beside or
// instead of the s8 one. The shared core, its arithmetic and its
// pipeline are in conv_gemm_q_sm90.cuh.
//
// What bounds it: on the serving path (M = 2,048 .. 131,072 pixels at b8,
// Ci 128..1024, Co 64..512) the work is 2*M*Ci*Co int8 operations over
// about M*(Ci + Co) bytes, 20..340 operations a byte against the card's
// ~590 (1979 TOP/s over 3.35 TB/s): every shape is bound by its bytes,
// 1..14 us a launch. The design streams the s8 rows [M, Ci] and the
// weights through a TMA ring (a 2D and a 3D tensor map) so device memory
// is read ahead of the products instead of once per K step, keeps the
// quantize of a bf16 input (a converting producer warpgroup writing the
// same swizzled tiles) and of the output inside the kernel, so each
// activation crosses device memory once, and picks BM 64 where 128-pixel
// tiles would leave SMs idle (the 16^2 1x1s: 2,048 pixels).
//
// pointwise_conv_block_q_wmma is the same contract on the older WMMA core
// (conv_block_q.cuh), kept for A/B timing only; no serving path calls it.
#include "conv_block_q.cuh"
#include "conv_gemm_q_sm90.cuh"

#define POINTWISE_CHECK                                                     \
  (ksize == 1 && stride == 1 && pad_t == 0 && pad_l == 0 && oh == h &&      \
   ow == wd && res_out == nullptr &&                                        \
   (res_in == nullptr || x_kind == convq::kBF16) &&                         \
   (out_s8 != nullptr || out_f != nullptr))

CONVQ90_ENTRY(pointwise_conv_block_q, POINTWISE_CHECK)
CONVQ_ENTRY(pointwise_conv_block_q_wmma, POINTWISE_CHECK)
