// int8 3x3 stride-2 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/down_conv_kernel.py::down_conv_block_q:
// the quantize of the bf16 block-boundary tensor inside the kernel, nine
// tap matrix products over the stride-2 grid summed in int32, the folded
// epilogue, and the next block's quantize, emitting the s8 tensor the
// following FeatureBlock consumes. XLA's SAME padding for k = 3, s = 2
// puts the one zero row and column of an even input at the bottom/right
// (pad_t = pad_l = 0) and one on each side of an odd one (pad_t = pad_l =
// 1); the wrapper passes XLA's pads for any size. Where no next block is
// calibrated the kernel emits the block's float output instead, as the
// reference's plain conv block does.
//
// What bounds it: at b8 (C 64..512 -> 128..1024, 256^2 down to 32^2 in)
// each launch is 19.3 G operations (2*M*9*C*Co, M output pixels, ~10 us
// at 1979 TOP/s) over about 4*M*C*2 + M*Co bytes, 230..1270 operations a
// byte against the card's ~590: the 256^2 and 128^2 inputs bound it by
// their bf16 bytes, the 64^2 and 32^2 ones by the tensor cores. It runs
// the wgmma core (conv_gemm_q_sm90.cuh) through its converting producer,
// which loads each tap's pixels at the stride, quantizes them and writes
// the swizzled A tile into the ring; each input pixel is read by ~2.25
// taps. A block's pixels are a TH x TW rectangle of the output image.
//
// down_conv_block_q_wmma is the same contract on the older WMMA core
// (conv_block_q.cuh), kept for A/B timing only; no serving path calls it.
#include "conv_block_q.cuh"
#include "conv_gemm_q_sm90.cuh"

#define DOWN_CONV_CHECK                                                     \
  (ksize == 3 && stride == 2 && x_kind != convq::kS8 && res_in == nullptr && \
   res_out == nullptr && oh == (h + 1) / 2 && ow == (wd + 1) / 2 &&         \
   pad_t == h % 2 && pad_l == wd % 2 &&                                     \
   (out_s8 != nullptr || out_f != nullptr))

CONVQ90_ENTRY(down_conv_block_q, DOWN_CONV_CHECK)
CONVQ_ENTRY(down_conv_block_q_wmma, DOWN_CONV_CHECK)
