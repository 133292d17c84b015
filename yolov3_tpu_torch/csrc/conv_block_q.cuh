// WMMA core of the port's first int8 ConvBlock kernels for Hopper
// (sm_90a). The 1x1, 3x3, stride-2 (float in) and exit (stride 2, s8 in)
// kernels all run conv_gemm_q_sm90.cuh now and keep this core only as
// their `*_wmma` A/B entries, which no serving path calls. Each .cu file
// includes this header and exposes C entry points that check their own
// contract before they launch.
//
// One implicit GEMM over NHWC tensors, exact in int32:
//
//     acc[p, o] = sum_{u,v} sum_c q(x[n, oh*s - pt + u, ow*s - pl + v, c])
//                                * W[u, v][o, c]
//
// where p = (n, oh, ow) is an output pixel, the taps that fall outside the
// image read zeros (the XLA SAME padding the caller gives as pt, pl), and
// q() is the identity on an s8 input or the quantize clip(rint(x * inv_in))
// of a bf16 or f32 input, done while the tile goes to shared memory. No
// im2col is ever written to device memory. Then, in float32 and in the op
// order of the JAX epilogue (models/quantized.py::_epilogue with the
// dequant scale dq commuted through LeakyReLU), each op separately rounded:
//
//     y = leaky(float(acc) + b/dq, alpha) * (mul*dq) + add
//     [cast_bf16]  y = bf16(y)
//     [res_out]    y = bf16(bf16(float(rq) * s_res) + y)   (casts as above)
//     out_f  = y as bf16 or f32           (optional)
//     out_s8 = clip(rint(y * inv_next))   (optional, the next conv's input)
//
// `res_in` (the 1x1 kernel's residual variant, bf16 x only) is added to
// the input before its quantize: t = bf16(bf16(float(rq) * s_res) + x).
// rintf rounds half to even, as jnp.round and torch.round do (roundf would
// round half away from zero and flip every .5 code); the library is built
// with -fmad=false, so no multiply-add is contracted.
//
// Tiling: 64 output pixels x 64 output channels per block of four warps,
// each warp 32x32 with WMMA s8 16x16x16 fragments and int32 accumulators;
// K is walked tap by tap, 32 input channels at a time, with no copy
// pipeline. Channels must be multiples of 16 (one 16-byte vector of s8 a
// load); pixels and output channels are ragged (edge rows load as zeros
// and are not stored).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace convq {

using namespace nvcuda;

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per K step
constexpr int KF = 16;    // K of one WMMA fragment
constexpr int kThreads = 128;

enum InKind { kS8 = 0, kBF16 = 1, kF32 = 2 };

struct Params {
  const void* x;          // [n, h, w, ci] s8, bf16 or f32
  const int8_t* w;        // [taps, co, ci] s8
  const float* epi;       // [3, co] f32: b/dq, mul*dq, add (+ 1/s_next)
  const int8_t* res_in;   // [n, h, w, ci] s8 or null
  const int8_t* res_out;  // [n, oh, ow, co] s8 or null
  int8_t* out_s8;         // [n, oh, ow, co] or null
  void* out_f;            // [n, oh, ow, co] bf16 or f32, or null
  int out_f_bf16;
  int n, h, w_, ci, co, oh, ow, ksize, stride, pad_t, pad_l;
  float inv_in, inv_next, res_scale, alpha;
  int cast_bf16;
  int inv_next_row;       // 1: out_s8's 1/s is epi row 3 ([4, co] epi)
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

union Vec16 {
  uint4 u;
  int8_t s8[16];
};

// 16 consecutive channels of x starting at element `off`, as s8 codes
template <int KIND>
__device__ __forceinline__ uint4 load_a16(const Params& p, size_t off) {
  if constexpr (KIND == kS8) {
    return *reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(p.x) + off);
  } else {
    float f[16];
    if constexpr (KIND == kBF16) {
      // a bf16 is the top half of the f32 with the same value
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(p.x) + off);
      const uint4 lo = src[0], hi = src[1];
      const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        f[2 * i] = __uint_as_float(words[i] << 16);
        f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
      if (p.res_in != nullptr) {
        Vec16 rv;
        rv.u = *reinterpret_cast<const uint4*>(p.res_in + off);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float r = bf16_round(
              __fmul_rn(static_cast<float>(rv.s8[i]), p.res_scale));
          f[i] = bf16_round(__fadd_rn(r, f[i]));
        }
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(
          static_cast<const float*>(p.x) + off);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = src[j];
        f[4 * j] = v.x;
        f[4 * j + 1] = v.y;
        f[4 * j + 2] = v.z;
        f[4 * j + 3] = v.w;
      }
    }
    Vec16 out;
#pragma unroll
    for (int i = 0; i < 16; ++i) out.s8[i] = quantize(f[i], p.inv_in);
    return out.u;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
conv_block_q_kernel(const Params p) {
  // K-major halves of the A and B tiles: a fragment's rows are 16 bytes
  // apart, so every fragment pointer is 256-bit aligned
  __shared__ __align__(128) int8_t As[BK / KF][BM][KF];
  __shared__ __align__(128) int8_t Bs[BK / KF][BN][KF];
  __shared__ __align__(128) int Cs[BM][BN + 4];

  const int m_total = p.n * p.oh * p.ow;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  // each thread loads one 16-channel vector of A (pixel row `lr`) and one
  // of B (output channel `lr`) per K step, K half `lq`
  const int lr = tid >> 1;
  const int lq = tid & 1;
  const int pix = row0 + lr;
  const bool prow = pix < m_total;
  int pn = 0, poh = 0, pow_ = 0;
  if (prow) {
    const int plane = p.oh * p.ow;
    pn = pix / plane;
    const int rem = pix - pn * plane;
    poh = rem / p.ow;
    pow_ = rem - poh * p.ow;
  }
  const int bcol = col0 + lr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int taps = p.ksize * p.ksize;
  for (int t = 0; t < taps; ++t) {
    const int u = t / p.ksize;
    const int v = t - u * p.ksize;
    const int ih = poh * p.stride - p.pad_t + u;
    const int iw = pow_ * p.stride - p.pad_l + v;
    const bool inb = prow && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_;
    const size_t xbase =
        inb ? (static_cast<size_t>(pn * p.h + ih) * p.w_ + iw) * p.ci : 0;
    const int8_t* wrow =
        p.w + (static_cast<size_t>(t) * p.co + bcol) * p.ci;
    for (int k0 = 0; k0 < p.ci; k0 += BK) {
      const int kc = k0 + lq * KF;
      uint4 a = zero;
      if (inb && kc < p.ci) a = load_a16<KIND>(p, xbase + kc);
      *reinterpret_cast<uint4*>(&As[lq][lr][0]) = a;
      uint4 b = zero;
      if (bcol < p.co && kc < p.ci)
        b = *reinterpret_cast<const uint4*>(wrow + kc);
      *reinterpret_cast<uint4*>(&Bs[lq][lr][0]) = b;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BK / KF; ++q) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], reinterpret_cast<const signed char*>(&As[q][wm + 16 * i][0]),
              KF);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], reinterpret_cast<const signed char*>(&Bs[q][wn + 16 * j][0]),
              KF);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              BN + 4, wmma::mem_row_major);
  __syncthreads();

  const float* eb = p.epi;
  const float* em = p.epi + p.co;
  const float* ea = p.epi + 2 * p.co;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN;
    const int c = e - r * BN;
    const int gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= m_total || gc >= p.co) continue;
    const size_t o = static_cast<size_t>(gr) * p.co + gc;
    float y = __fadd_rn(__int2float_rn(Cs[r][c]), eb[gc]);
    y = y >= 0.0f ? y : __fmul_rn(p.alpha, y);
    y = __fadd_rn(__fmul_rn(y, em[gc]), ea[gc]);
    if (p.cast_bf16) y = bf16_round(y);
    if (p.res_out != nullptr) {
      float res = __fmul_rn(static_cast<float>(p.res_out[o]), p.res_scale);
      if (p.cast_bf16) res = bf16_round(res);
      y = __fadd_rn(res, y);
      if (p.cast_bf16) y = bf16_round(y);
    }
    if (p.out_f != nullptr) {
      if (p.out_f_bf16)
        static_cast<__nv_bfloat16*>(p.out_f)[o] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(p.out_f)[o] = y;
    }
    if (p.out_s8 != nullptr)
      p.out_s8[o] =
          quantize(y, p.inv_next_row ? p.epi[3 * p.co + gc] : p.inv_next);
  }
}

// Launch on `stream`; returns a cudaError_t code (0 on success).
inline int launch(const Params& p, int x_kind, cudaStream_t stream) {
  const long long m = static_cast<long long>(p.n) * p.oh * p.ow;
  if (m == 0 || p.co == 0) return 0;
  if (p.ci % KF || p.co % KF || m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((p.co + BN - 1) / BN));
  switch (x_kind) {
    case kS8:
      conv_block_q_kernel<kS8><<<grid, kThreads, 0, stream>>>(p);
      break;
    case kBF16:
      conv_block_q_kernel<kBF16><<<grid, kThreads, 0, stream>>>(p);
      break;
    case kF32:
      conv_block_q_kernel<kF32><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace convq

// The C entry point every int8 ConvBlock's WMMA twin exposes (the wgmma
// entry's arguments without the tile plan); `check` is the kernel's own
// contract (a cudaErrorInvalidValue when it is broken).
#define CONVQ_ENTRY(NAME, CHECK)                                            \
  extern "C" int NAME(                                                      \
      const void* x, int x_kind, const int8_t* w, const float* epi,         \
      const int8_t* res_in, const int8_t* res_out, int8_t* out_s8,          \
      void* out_f, int out_f_bf16, int n, int h, int wd, int ci, int co,    \
      int oh, int ow, int ksize, int stride, int pad_t, int pad_l,          \
      float inv_in, float inv_next, float res_scale, float alpha,           \
      int cast_bf16, int inv_next_row, cudaStream_t stream) {               \
    if (!(CHECK)) return static_cast<int>(cudaErrorInvalidValue);           \
    const convq::Params p{x,     w,      epi,      res_in,   res_out,       \
                          out_s8, out_f, out_f_bf16, n,      h,             \
                          wd,     ci,    co,       oh,       ow,            \
                          ksize,  stride, pad_t,   pad_l,    inv_in,        \
                          inv_next, res_scale, alpha, cast_bf16,            \
                          inv_next_row};                                    \
    return convq::launch(p, x_kind, stream);                                \
  }
