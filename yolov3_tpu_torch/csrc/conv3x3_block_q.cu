// int8 3x3 stride-1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/conv3x3_kernel.py::conv3x3_block_q: nine
// tap matrix products with SAME (1, 1) zero padding summed in int32, the
// folded epilogue, the feature block's residual (an s8 tensor dequantized
// in the kernel and added to the epilogue output, with the bf16 round
// trips of the JAX kernel when `cast_bf16`), and the next conv's
// quantize; emits s8 and/or the bf16 (or f32) sum. It is an implicit GEMM
// (conv_block_q.cuh): each tap's pixels are read in place, the padding
// taps load zeros, and no im2col reaches device memory.
//
// What bounds it: at b8 on the serving path (C 32..512 -> 64..1024, from
// 256^2 down to 16^2) the work is 2*M*9*C*Co operations over about
// M*(C + 2*Co) bytes, 190..3000 operations a byte: the wide deep stages are
// bound by the tensor cores, the shallow ones by bytes.
#include "conv_block_q.cuh"

CONVQ_ENTRY(conv3x3_block_q,
            ksize == 3 && stride == 1 && pad_t == 1 && pad_l == 1 &&
                oh == h && ow == wd && res_in == nullptr &&
                (out_s8 != nullptr || out_f != nullptr))
