// int8 3x3 stride-2 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/down_conv_kernel.py::down_conv_block_q:
// the quantize of the bf16 block-boundary tensor inside the kernel, nine
// tap matrix products over the stride-2 grid summed in int32, the folded
// epilogue, and the next block's quantize, emitting the s8 tensor the
// following FeatureBlock consumes. XLA's SAME padding for k = 3, s = 2
// puts the one zero row and column of an even input at the bottom/right
// (pad_t = pad_l = 0); the wrapper passes XLA's pads for any size. Where
// no next block is calibrated the kernel emits the block's float output
// instead, as the reference's plain conv block does.
//
// What bounds it: at b8 (C 32..512 -> 64..1024, 512^2 down to 32^2 in)
// the work is 2*M*9*C*Co operations over about 4*M*C*2 + M*Co bytes,
// 140..2300 operations a byte: the first downsample is bound by its bf16
// input bytes, the deep ones by the tensor cores.
#include "conv_block_q.cuh"

CONVQ_ENTRY(down_conv_block_q,
            ksize == 3 && stride == 2 && x_kind != convq::kS8 &&
                res_in == nullptr && res_out == nullptr &&
                oh == (h + 1) / 2 && ow == (wd + 1) / 2 &&
                (out_s8 != nullptr || out_f != nullptr))
