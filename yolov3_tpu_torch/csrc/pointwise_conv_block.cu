// Fused inference 1x1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/conv_block_kernel.py::
// fused_pointwise_conv_block. Over the flattened rows of an NHWC
// activation:
//
//     y = leaky(x @ W^T + bias, alpha) * mul + add,   cast to the output type
//
// or, in the entry pointwise_conv_block_mish (YOLOv4's CSP 1x1s, BatchNorm
// folded into W and bias, mul = 1 and add = 0), mish(x @ W^T + bias) in
// place of leaky: the core's conv_gemm_q_kernel<BN, 1, 2, false> (OP =
// kOpBF16Mish), so that its launches carry a name of their own in a device
// trace; softplus's threshold is 20, as in F.softplus and darknet.
//
// with x [M, Ci] and W [Co, Ci] in bf16, products summed in f32, and the
// epilogue in f32 (mul = gamma / sqrt(var + eps), add = beta - mean * mul,
// folded by the Python wrapper).
//
// What bounds it: at the serving shapes (b8: M 2,048..524,288, Ci
// 64..1024, Co 32..512) the work is 2*M*Ci*Co operations over (M*Ci +
// Ci*Co)*2 + M*Co*out bytes, 20..330 operations a byte against the card's
// ~295 in bf16: the bytes bound every launch but the deepest. The entry
// `pointwise_conv_block` runs the wgmma + TMA core that the int8 1x1 and
// 3x3 kernels share (conv_gemm_q_sm90.cuh, with bf16 operands): x and W
// stream through a TMA ring (2D and 3D maps over bytes) while wgmma
// m64nBNk16 multiplies from shared memory, persistent blocks overlap the
// next tile's copies with this tile's epilogue, which runs from the
// accumulator registers and stores four channels (8 or 16 bytes) at a
// time. The tile plan comes from ops/kernels/_conv_q.py::conv_plan (the
// same L2 cost model as the int8 launches, with 2-byte elements); BN = 32
// serves the Co = 32 launches, which a 64-channel tile would half waste.
//
// W is K-major ([Co, Ci], the conv's OIHW weight without its 1x1 taps):
// the layout of the s8 weights, so the bf16 and s8 descriptors and TMA
// maps are the same; the model derives it once at load (models/yolo.py).
// A transposed-B descriptor on the [Ci, Co] layout would have needed a
// second B path through the core (wgmma's transpose bit and another
// swizzle of the B tile) for no gain.
//
// pointwise_conv_block_wmma is the same contract on the first, simple
// kernel (WMMA bf16 16x16x16 on 64x64 tiles, A and B staged 32 deep
// through static shared memory without a copy pipeline, the epilogue
// through a shared f32 tile); kept for A/B timing only, no serving path
// calls it.
//
// Shapes: M is ragged (the edge rows load as zeros and are not stored, no
// padding copy); Ci and Co need only be multiples of 8 (16-byte rows),
// not of the tile size or powers of two (768 and 384 occur).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_gemm_q_sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int APAD = 8;  // bf16 elements of row padding (bank spread)
constexpr int CPAD = 4;  // f32 elements of row padding
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pointwise_conv_block_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ mul,
                            const float* __restrict__ add,
                            void* __restrict__ out, int m, int ci, int co,
                            float alpha, int out_bf16) {
  __shared__ __align__(128) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BN][BK + APAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < ci; k0 += BK) {
    // A tile [BM, BK] and B tile [BK, BN], 8 bf16 (16 bytes) a load
    for (int e = threadIdx.x; e < BM * BK / 8; e += kThreads) {
      const int r = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
      const int gr = row0 + r, gc = k0 + c8;
      uint4 val = zero;
      if (gr < m && gc < ci)
        val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gr) * ci + gc);
      *reinterpret_cast<uint4*>(&As[r][c8]) = val;
    }
    for (int e = threadIdx.x; e < BN * BK / 8; e += kThreads) {
      const int r = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
      const int gr = col0 + r, gc = k0 + c8;
      uint4 val = zero;
      if (gr < co && gc < ci)
        val = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(gr) * ci + gc);
      *reinterpret_cast<uint4*>(&Bs[r][c8]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[wn + 16 * j][kk], BK + APAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < co) {
      float y = Cs[r][c] + bias[gc];
      y = y >= 0.0f ? y : alpha * y;
      y = y * mul[gc] + add[gc];
      const size_t o = static_cast<size_t>(gr) * co + gc;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
      else
        static_cast<float*>(out)[o] = y;
    }
  }
}

}  // namespace

namespace {

// the sm90 entries' launch, with operands and epilogue OP (kOpBF16:
// LeakyReLU, kOpBF16Mish: Mish)
template <int OP>
int launch_sm90(const void* x, const void* w, const float* bias,
                const float* mul, const float* add, void* out, int m, int ci,
                int co, float alpha, int out_bf16, int bm, int bn, int bk,
                int stages, cudaStream_t stream) {
  convq90::Params p{};
  p.x = x;
  p.w = w;
  p.epi_b = bias;
  p.epi_m = mul;
  p.epi_a = add;
  p.out_f = out;
  p.out_f_bf16 = out_bf16;
  p.n = 1;
  p.h = 1;
  p.w_ = m;
  p.ci = ci;
  p.co = co;
  p.ksize = 1;
  p.oh = 1;
  p.ow = m;
  p.stride = 1;
  p.alpha = alpha;
  p.bm = bm;
  p.bk = bk;
  p.th = 1;
  p.tw = bm;
  p.stages = stages;
  return convq90::launch<OP>(p, convq90::kBF16, bn, stream);
}

}  // namespace

// x [m, ci] bf16, w [co, ci] bf16, bias/mul/add [co] f32 -> out [m, co]
// (bf16 when out_bf16, else f32), all contiguous and 16-byte aligned; ci
// and co multiples of 8. The sm90 entries also take the tile plan (bm, bn,
// bk, stages); pointwise_conv_block_mish is the same contract with
// mish(acc + bias) in place of leaky (alpha unused). Each returns a
// cudaError_t code (0 on success).
extern "C" int pointwise_conv_block(const void* x, const void* w,
                                    const float* bias, const float* mul,
                                    const float* add, void* out, int m,
                                    int ci, int co, float alpha, int out_bf16,
                                    int bm, int bn, int bk, int stages,
                                    cudaStream_t stream) {
  return launch_sm90<convq90::kOpBF16>(x, w, bias, mul, add, out, m, ci,
                                       co, alpha, out_bf16, bm, bn, bk,
                                       stages, stream);
}

extern "C" int pointwise_conv_block_mish(const void* x, const void* w,
                                         const float* bias, const float* mul,
                                         const float* add, void* out, int m,
                                         int ci, int co, float alpha,
                                         int out_bf16, int bm, int bn, int bk,
                                         int stages, cudaStream_t stream) {
  return launch_sm90<convq90::kOpBF16Mish>(x, w, bias, mul, add, out, m,
                                           ci, co, alpha, out_bf16, bm, bn,
                                           bk, stages, stream);
}

extern "C" int pointwise_conv_block_wmma(const void* x, const void* w,
                                         const float* bias, const float* mul,
                                         const float* add, void* out, int m,
                                         int ci, int co, float alpha,
                                         int out_bf16, cudaStream_t stream) {
  if (m == 0 || co == 0) return 0;
  if (ci % 8 || co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, (co + BN - 1) / BN);
  pointwise_conv_block_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias, mul, add, out, m, ci, co,
      alpha, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
