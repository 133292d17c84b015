// int8 3x3 stride-1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/conv3x3_kernel.py::conv3x3_block_q: nine
// tap matrix products with SAME (1, 1) zero padding summed in int32, the
// folded epilogue, the feature block's residual (an s8 tensor dequantized
// in the kernel and added to the epilogue output, with the bf16 round
// trips of the JAX kernel when `cast_bf16`), and the next conv's
// quantize; emits s8 and/or the bf16 (or f32) sum. It is an implicit GEMM
// (conv_gemm_q_sm90.cuh): each tap's pixels are read in place, the
// padding taps load zeros, and no im2col reaches device memory.
//
// What bounds it: at b8 on the serving path (C 64..512 -> 128..1024, from
// 128^2 down to 16^2) the work is 2*M*9*C*Co operations over about
// M*(C + 2*Co) bytes, 190..3000 operations a byte against the card's
// ~590: the deep 16^2-64^2 stages are bound by the tensor cores (each
// launch ~10 us at 1979 TOP/s), the 128^2 stage by its bytes. The design
// feeds wgmma from a TMA ring: a block's pixels are a TH x TW rectangle
// of one image, so each tap is one 4D box of the NHWC input whose
// out-of-image part TMA fills with zeros (the padding), and the nine taps
// x Ci/BK steps stream through the ring while the products run. Each
// SM streams (BM + BN) x BK bytes a K step from L2, at about the same
// rate however many SMs are busy, so the plan (ops/kernels/_conv_q.py::
// conv_plan) takes the largest tiles that still keep the card busy:
// 128x256 at 32^2 and 64^2, 128x128 at 16^2 (b8) and 128^2.
//
// conv3x3_block_q_wmma is the same contract on the older WMMA core
// (conv_block_q.cuh), kept for A/B timing only; no serving path calls it.
#include "conv_block_q.cuh"
#include "conv_gemm_q_sm90.cuh"

#define CONV3X3_CHECK                                                       \
  (ksize == 3 && stride == 1 && pad_t == 1 && pad_l == 1 && oh == h &&      \
   ow == wd && res_in == nullptr && (out_s8 != nullptr || out_f != nullptr))

CONVQ90_ENTRY(conv3x3_block_q, CONV3X3_CHECK)
CONVQ_ENTRY(conv3x3_block_q_wmma, CONV3X3_CHECK)
