// Fused inference 1x1 ConvBlock for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/conv_block_kernel.py::
// fused_pointwise_conv_block. Over the flattened rows of an NHWC
// activation:
//
//     y = leaky(x @ W + bias, alpha) * mul + add,   cast to the output type
//
// with x [M, Ci] and W [Ci, Co] in bf16, products summed in f32, and the
// epilogue in f32 (mul = gamma / sqrt(var + eps), add = beta - mean * mul,
// folded by the Python wrapper).
//
// What bounds it: at the serving shapes (Ci 64..1024, Co 32..512, M up to
// 8*128*128) the work is 2*M*Ci*Co operations over (M*Ci + Ci*Co)*2 +
// M*Co*out bytes, i.e. between ~30 and ~400 operations a byte: the small-Ci
// blocks sit near the bf16 ridge of the card, the large ones above it.
// This first version is simple and right rather than fast: 64x64 output
// tiles, four warps each computing 32x32 with WMMA bf16 16x16x16
// fragments and f32 accumulators, A and B staged through shared memory
// 32 deep without a copy pipeline, and the epilogue applied while the
// accumulators go from shared memory to device memory. wgmma, TMA and a
// multi-stage pipeline are later work.
//
// Shapes: M is ragged (the edge rows load as zeros and are not stored, no
// padding copy); Ci and Co need only be multiples of 8 (16-byte vector
// loads), not of the tile size or powers of two (768 and 384 occur).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + APAD];
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
    for (int e = threadIdx.x; e < BK * BN / 8; e += kThreads) {
      const int r = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
      const int gr = k0 + r, gc = col0 + c8;
      uint4 val = zero;
      if (gr < ci && gc < co)
        val = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(gr) * co + gc);
      *reinterpret_cast<uint4*>(&Bs[r][c8]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], BN + APAD);
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

// x [m, ci] bf16, w [ci, co] bf16, bias/mul/add [co] f32 -> out [m, co]
// (bf16 when out_bf16, else f32), all contiguous and 16-byte aligned.
// Returns a cudaError_t code (0 on success).
extern "C" int pointwise_conv_block(const void* x, const void* w,
                                    const float* bias, const float* mul,
                                    const float* add, void* out, int m,
                                    int ci, int co, float alpha, int out_bf16,
                                    cudaStream_t stream) {
  if (m == 0 || co == 0) return 0;
  const dim3 grid((m + BM - 1) / BM, (co + BN - 1) / BN);
  pointwise_conv_block_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias, mul, add, out, m, ci, co,
      alpha, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
