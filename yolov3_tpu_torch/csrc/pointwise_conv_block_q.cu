// int8 1x1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/pointwise_kernel.py::
// pointwise_conv_block_q: over the flattened pixels of an NHWC tensor, the
// optional in-kernel quantize of a bf16 (or f32) input, with the optional
// requantized residual added first (t = bf16(bf16(rq * s_res) + x)), one
// int8 x int8 -> int32 matrix product, the folded epilogue, and the next
// conv's quantize; optionally the bf16 (or f32) block output beside or
// instead of the s8 one. The shared implicit-GEMM core, its arithmetic
// and its tiling are in conv_block_q.cuh.
//
// What bounds it: on the serving path (M = 2,048 .. 524,288 pixels at b8,
// Ci 64..1024, Co 32..512) the work is 2*M*Ci*Co int8 operations over
// about M*(Ci + Co) bytes, 20..340 operations a byte against the card's
// ~590 (1979 TOP/s over 3.35 TB/s): every shape is bound by its bytes.
// The design keeps the quantize of the input and of the output inside the
// kernel, so each activation crosses device memory once, as s8 where the
// chain allows.
#include "conv_block_q.cuh"

CONVQ_ENTRY(pointwise_conv_block_q,
            ksize == 1 && stride == 1 && pad_t == 0 && pad_l == 0 &&
                oh == h && ow == wd && res_out == nullptr &&
                (res_in == nullptr || x_kind == convq::kBF16) &&
                (out_s8 != nullptr || out_f != nullptr))
