// The int8 stem region as one kernel for Hopper (sm_90a), with the tail as
// a second entry point.
//
// Replaces yolov3_tpu/ops/pallas/s2d_region_kernel.py::s2d_region_block_q
// (entry `s2d_region_block_q`) and s2d_tail_kernel.py::s2d_tail_block_q
// (entry `s2d_tail_block_q`). The TPU kernels work on the space-to-depth
// view of the stem; here the same function runs in the plain NHWC layout,
// where each lifted convolution is the plain one (SAME padding: (0, 1) for
// both stride-2 convs on even sizes, (1, 1) for the 3x3):
//
//   x   [n, 2h2, 2w2, c1]       stem1's output: s8 at ConvBlock_1's scale
//                               s1, or bf16 / f32 quantized to it while
//                               the tile is loaded, clip(rint(x * 1/s1))
//   q2  = stage(conv3x3 s2 (x, w_s2), rows 13-16)    stem2,   scale s2
//   q3  = stage(conv1x1 (q2, w_pw),   rows 0-3)      FB0 1x1, scale s3
//         (zero off the image: FB0's 3x3 pads with zeros, not pw(0))
//   q4  = fb0(conv3x3 (q3, w_fb0), residual q2, rows 4-8)      scale s4
//         (zero on the exit's bottom/right pad row and column)
//   out = stage(conv3x3 s2 (q4, w_ex), rows 9-12)    s8 [n, h2/2, w2/2, co]
//
// The tail entry starts at q2 = its input (stem2's s8 output). The
// epilogues are the JAX kernels', op for op and each op separately
// rounded (-fmad=false):
//   exact: y = leaky(acc + b) * m + a; [cast] bf16(y); q = clip(rint(y*inv))
//          fb0: bf16(bf16(q2 * s2) + bf16(z)), then quantized with 1/s4
//   fast:  y = max(y, alpha*y) with 1/s folded into m and a; q = clip(rint(
//          y*m + a)); fb0 adds q2 * (s2/s4) before the rounding
//   affine2 (s2d_region_kernel.py:583-591): stem2, pw: q = clip(rint(max(
//          acc*m1 + c1, acc*m2 + c2))); fb0 adds q2 * r before the
//          rounding; the exit runs the fast epilogue. A channel whose m1 is
//          negative comes out negated, and its consumers' weights take it
//          negated (ops/quant.py::region_epi_affine2)
// rintf rounds half to even, as jnp.round does.
//
// rawimg (s2d_region_kernel.py:330-363, :604-615): x is the z-scored image
// [n, 2h2, 2w2, ci] (bf16 or f32) and each tile first computes its x tile,
// stem1 (3x3, SAME, weights [9, c1, ci]) and its epilogue (bias, LeakyReLU,
// BatchNorm; exact or fast by `fast`) and the quantize to s1. Off-image
// stem1 pixels are code 0: they are stem2's SAME padding, not stem1 on the
// image's zero padding. A bf16 image runs stem1 on the tensor cores, as the
// TPU kernel runs it on its MXU (stem1_tc: wgmma m64nNSk16 bf16 -> f32, the
// products exact, the sum in the hardware's order, and the few sums whose
// code that order could change taken again in the plain version's; the
// image patch copied with cp.async while the previous tile's stages run).
// An f32 image, and a bf16 one through `s2d_region_block_q_cores` (the
// mode's first design, kept for A/B timing only), run it on CUDA cores
// from an f32 patch loaded at the start of each tile, summed tap by tap in
// the plain version's order (stem1_tile). Both are code for code the plain
// version's.
//
// What bounds it: at the flagship (b8, stem1 out 8x512x512x32) 30.1 G MACs
// (60.1 G int8 operations, 0.030 ms at 1979 TOP/s) against 134 MB in
// (bf16) and 17 MB out (0.045 ms at 3.35 TB/s): neither, by much; the four
// unfused launches it replaces move 0.42 GB between stages. With rawimg
// it reads the 12.6 MB bf16 image instead of stem1's 134 MB output, and
// adds stem1's 1.8 G MACs (3.6 G operations: 0.004 ms on the bf16 tensor
// cores, 0.054 ms on CUDA cores at 67 TFLOP/s for an f32 image),
// recomputed on the halo of each tile.
//
// Where the time went (clock64 stamps per phase of the first design, on
// the H100 at the flagship, fast epilogue, bf16 input; PERF.md): ~47 us a
// tile, of which the products ~28%, the stages' epilogues ~30%, the input
// tile's load and quantize ~16%, and warps idle at the stage barriers
// (too few work items to share out evenly) most of the rest; the weight
// copies hid behind the 1x1.
//
// Design (entries `s2d_region_block_q`, `s2d_tail_block_q`): persistent
// blocks of sixteen warps, min(tiles, SMs) of them, each walking output
// tiles of T x T pixels (image, row, column order). A block copies all
// four stages' weights into shared memory once (111 KB at the flagship,
// instead of once per tile), in the layout wgmma reads B in: each tap's
// and 32-byte K step's [N][32] tile in the 32B swizzle. Per tile it
// recomputes the halo of every stage from its input tile (4T+7 square
// for the region; q2/q3 on (2T+3)^2, q4 on (2T+1)^2), so no stage
// boundary reaches device memory and no tile depends on another. Each
// stage is an implicit GEMM on wgmma m64nNSk32 s8 (NS = 32 or 16
// channels, whichever shares the stage out more evenly): the four
// warpgroups take items of 64 pixel rows x NS channels, and each warp
// loads its 16 rows' A fragment with ldmatrix into registers, the rows
// being any pixels of the tile (a tap's shifted or strided window needs
// no copy); B comes from the resident weights through a descriptor. The
// activation tiles hold each pixel's channels unpadded, swizzled by
// 16-byte chunk so ldmatrix's rows spread over the banks, which leaves
// room for the input tile to keep a buffer of its own: the next tile's
// input is copied while this tile's 1x1, 3x3 and exit run (cp.async for
// s8; a float input's chunks are loaded by each thread before a stage
// and quantized into the buffer after it, so their latency passes during
// the stage). The epilogues are the first design's op for op, from the
// accumulator registers, with the final rounding on the FMA pipe (the
// same codes) and each row's tile coordinates derived once an item. T = 8
// at the flagship: 219 KB of shared memory, one block an SM (rawimg on a
// bf16 image: 213 KB, its x tile sharing q3's and q4's buffer, the image
// patch in a buffer of its own, filled for the next tile while this one's
// stages run, then a queue of the stem1 sums taken again in order (4 KB);
// on CUDA cores: 215 KB, the x tile and the f32 patch sharing
// q3's and q4's buffer, the patch loaded at the start of each tile).
//
// stem1 on tensor cores (stem1_tc): the patch holds the image's bytes row
// by row, each row copied as the 16-byte chunks that cover it and placed at
// its first byte's offset within its chunk, so a pixel's channels and its
// right-hand neighbours' follow one another. For tap row u, pixel (i, j)'s
// A row is then 16 consecutive bf16 from pixel j of patch row i + u: three
// columns of ci channels, and beyond them elements that the packed
// weights' zero rows cancel; K = 3 x 16, three wgmma k16 steps. The A
// fragments are loaded as bf16 pairs (a row is 2-byte aligned) into
// registers; B, stem1's weights packed [3][c1][16] in the 32B swizzle,
// stays resident. A tile whose patch runs off the image has the off-image
// bytes zeroed after the copy lands (fix_patch): stem1's SAME padding.
// The tensor cores' sums alone differ from the plain version's order in
// their bf16 rounding often enough that, at the flagship, the region's
// codes moved by up to 2; so each sum also gets the sum of its products'
// magnitudes S from a second GEMM, and those within 2^-21 S of a bf16
// rounding midpoint whose code the rounding changes are taken again in
// order (stem1_wg). At the flagship (bf16 image, fast epilogue; clock64,
// PERF.md) 0.39% of the sums are in doubt and 0.09% taken again; a tile
// takes 75.3 k cycles against 86.7 k on CUDA cores: stem1 45% of it (most
// of that its epilogue and the check), against 45% and the patch's load
// 9.4%; the patch's wait is 2.0%. Without the check a tile took 56.3 k
// cycles, stem1 27% of it. Two items in flight a warpgroup (the next
// one's products during this one's epilogue) need more than the 128
// registers a thread has at 512 threads: they spilled, and ptxas then
// serialized the wgmma.
//
// `s2d_region_block_q_mma` / `s2d_tail_block_q_mma` are the first
// design, kept for A/B timing only: no serving path calls them. One block
// of sixteen warps per (image, T x T tile); mma.sync m16n8k16 s8 -> s32
// with ldmatrix fragments, each pixel's channels and each weight row
// padded by 16 bytes; cp.async copies of the epi table, the weights and
// an s8 input tile; FB0's 3x3 and the exit's weights arrive while the 1x1
// runs (into the buffer the input tile leaves). 196 KB at T = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 16;  // bytes after each pixel's channels in smem
constexpr int kSmemMax = 232448;

// x's kinds: stem1's output (s8, or bf16 / f32 quantized on load), or
// the z-scored image (bf16 / f32) that the kernel runs stem1 on
enum InKind { kS8 = 0, kBF16 = 1, kF32 = 2, kImgBF16 = 3, kImgF32 = 4 };
// the image channels the rawimg kernel takes
constexpr int kMaxImageChannels = 4;

struct Params {
  const void* x;        // region: [n, 2h2, 2w2, c1]; tail: [n, h2, w2, c]
  const int8_t* w_s2;   // [9, c, c1]
  const int8_t* w_pw;   // [1, cm, c]
  const int8_t* w_fb0;  // [9, c, cm]
  const int8_t* w_ex;   // [9, co, c]
  const float* epi;     // [17 or 13, e]
  int8_t* out;          // [n, h3, w3, co]
  int h2, w2, h3, w3, c1, c, cm, co, e, tile;
  float alpha;
  int cast_bf16, fast;
  int x_kind;           // InKind of x (the tail takes s8)
  float inv_in;         // 1/s1, the quantize of a float x
};

// The rawimg kernel's parameters: stem1's weights and the image's
// channels besides. A kernel parameter of its own, so that the other
// kernels' parameters (and code) stay as they were.
struct ImageParams : Params {
  const void* w_s1;  // stem1's weights [9, c1, ci], of x's type
  int ci;            // the image's channels
};

// the parameters of a region kernel on x's kind
template <int KIND>
using KernelParams =
    std::conditional_t<KIND == kImgBF16 || KIND == kImgF32, ImageParams,
                       Params>;

__device__ __forceinline__ int image_channels(const Params&) { return 0; }
__device__ __forceinline__ int image_channels(const ImageParams& p) {
  return p.ci;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t clip_rint(float y) {
  const float q = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// clip(rint(y), +-127) as rintf then the clamp, or (kBits) on the FMA
// pipe alone: clamped first, then rounded half to even by adding 1.5 *
// 2^23, the code in the low byte. The same code either way (the bounds
// are integers; NaN clamps to -127 in both).
template <bool kBits>
__device__ __forceinline__ int8_t clip_round(float y) {
  if constexpr (kBits) {
    const float c = fminf(fmaxf(y, -127.0f), 127.0f);
    return static_cast<int8_t>(
        static_cast<uint8_t>(__float_as_uint(__fadd_rn(c, 12582912.0f))));
  } else {
    return clip_rint(y);
  }
}

// max(acc * m1 + c1, acc * m2 + c2), each product and add rounded on its
// own: the affine2 epilogue's two affines of the sum
__device__ __forceinline__ float affine2_max(int acc, float m1, float c1,
                                             float m2, float c2) {
  const float y = __int2float_rn(acc);
  return fmaxf(__fadd_rn(__fmul_rn(y, m1), c1),
               __fadd_rn(__fmul_rn(y, m2), c2));
}

// a conv stage's epilogue and requantize (stem2, pw, exit); FAST: the
// affine2 (2, rows b, m, a, inv holding m1, c1, m2, c2), fast (1) or
// exact (0) epilogue, or p.fast's (-1)
template <int FAST = -1, bool kBits = false>
__device__ __forceinline__ int8_t stage_q(int acc, float b, float m, float a,
                                          float inv, const Params& p) {
  if constexpr (FAST == 2) return clip_round<kBits>(affine2_max(acc, b, m, a,
                                                                inv));
  float y = __fadd_rn(__int2float_rn(acc), b);
  if (FAST < 0 ? p.fast : FAST) {
    y = fmaxf(y, __fmul_rn(p.alpha, y));
    return clip_round<kBits>(__fadd_rn(__fmul_rn(y, m), a));
  }
  y = y >= 0.0f ? y : __fmul_rn(p.alpha, y);
  y = __fadd_rn(__fmul_rn(y, m), a);
  if (p.cast_bf16) y = bf16_round(y);
  return clip_round<kBits>(__fmul_rn(y, inv));
}

// FB0's 3x3 epilogue with the block's residual (q2's code `res`); with
// affine2 the rows b, m, a, r, inv hold m1, c1, m2, c2, r
template <int FAST = -1, bool kBits = false>
__device__ __forceinline__ int8_t fb0_q(int acc, float b, float m, float a,
                                        float r, float inv, float res,
                                        const Params& p) {
  if constexpr (FAST == 2)
    return clip_round<kBits>(
        __fadd_rn(affine2_max(acc, b, m, a, r), __fmul_rn(res, inv)));
  float z = __fadd_rn(__int2float_rn(acc), b);
  if (FAST < 0 ? p.fast : FAST) {
    z = fmaxf(z, __fmul_rn(p.alpha, z));
    return clip_round<kBits>(
        __fadd_rn(__fadd_rn(__fmul_rn(z, m), a), __fmul_rn(res, r)));
  }
  z = z >= 0.0f ? z : __fmul_rn(p.alpha, z);
  z = __fadd_rn(__fmul_rn(z, m), a);
  if (p.cast_bf16) z = bf16_round(z);
  float rs = __fmul_rn(res, r);
  if (p.cast_bf16) rs = bf16_round(rs);
  float y = __fadd_rn(rs, z);
  if (p.cast_bf16) y = bf16_round(y);
  return clip_round<kBits>(__fmul_rn(y, inv));
}

__device__ __forceinline__ void mma16816(int* d, uint32_t a0, uint32_t a1,
                                         uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lane l gives the 16-byte row address of matrix l / 8; each
// thread receives, of every matrix, row lane / 4, bytes 4 (lane % 4) + 0..3
// -- exactly an mma.sync m16n8k16 s8 fragment register.
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The epilogue constants of two adjacent channels: rows b, m, a, the
// residual dequant r (FB0's 3x3 only) and inv, of the epi table.
struct Cols {
  float2 b, m, a, r, inv;
};

__device__ __forceinline__ Cols cols_at(const float* E, int e, int row0,
                                        int o, bool residual) {
  const auto at = [&](int row) {
    return *reinterpret_cast<const float2*>(E + row * e + o);
  };
  Cols c;
  c.b = at(row0);
  c.m = at(row0 + 1);
  c.a = at(row0 + 2);
  c.r = residual ? at(row0 + 3) : make_float2(0.0f, 0.0f);
  c.inv = at(row0 + (residual ? 4 : 3));
  return c;
}

// a stage's two channels: epilogue and requantize
template <int FAST = -1, bool kBits = false>
__device__ __forceinline__ char2 stage_q2(int a0, int a1, const Cols& c,
                                          const Params& p) {
  return make_char2(
      stage_q<FAST, kBits>(a0, c.b.x, c.m.x, c.a.x, c.inv.x, p),
      stage_q<FAST, kBits>(a1, c.b.y, c.m.y, c.a.y, c.inv.y, p));
}

// One stage as an implicit GEMM over shared-memory tiles:
//   acc[m, o] = sum_{u, v < KS} sum_k in[(i*S + u)*inw + j*S + v][k]
//                                     * w[u*KS + v][o][k]
// for grid pixel m = i*gw + j (gh x gw pixels), o < N; K channels in. The
// input pixels are `ips` bytes apart, the weights' rows (o) `wps` bytes
// (both K + kPad). `fin(m, m / gw, o, load_cols(o), acc_o, acc_o+1)` takes
// every pair of sums, with the epilogue constants of channels o, o+1. A
// warp holds 16*MT pixels x 8*NT channels (N % (8*NT) == 0): per 16-deep K
// step one ldmatrix for A (rows = pixels, any addresses), one for B, and
// MT*NT mma.sync m16n8k16; C (g, 2t..2t+1) and (g+8, 2t..2t+1).
template <int KS, int S, int MT, int NT, class LoadCols, class Fin>
__device__ __forceinline__ void conv_stage(const int8_t* in, int ips, int inw,
                                           int gh, int gw, const int8_t* w,
                                           int wps, int K, int N,
                                           LoadCols load_cols, Fin fin) {
  static_assert(NT == 2 || NT == 4, "B is one ldmatrix of 2 or 4 matrices");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = gh * gw;
  const int mitems = (M + 16 * MT - 1) / (16 * MT);
  const int nitems = N / (8 * NT);
  for (int item = warp; item < mitems * nitems; item += kWarps) {
    const int mi = item / nitems;
    const int n0 = (item - mi * nitems) * 8 * NT;
    const int m0 = mi * 16 * MT;
    // this lane's A row (a pixel) and B row (an output channel)
    const int r = min(m0 + (lane & (16 * MT - 1)), M - 1);
    const int ri = r / gw;
    const uint32_t a_base =
        smem_u32(in + ((ri * S) * inw + (r - ri * gw) * S) * ips);
    const uint32_t b_base = smem_u32(w + (n0 + (lane & (8 * NT - 1))) * wps);
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
#pragma unroll
    for (int u = 0; u < KS; ++u) {
#pragma unroll
      for (int v = 0; v < KS; ++v) {
        const uint32_t a_tap = a_base + (u * inw + v) * ips;
        const uint32_t b_tap = b_base + (u * KS + v) * N * wps;
        for (int k0 = 0; k0 < K; k0 += 16) {
          uint32_t a[MT][2], b[NT];
          if constexpr (MT == 2)
            ldsm_x4(a[0][0], a[0][1], a[MT - 1][0], a[MT - 1][1],
                    a_tap + k0);
          else
            ldsm_x2(a[0][0], a[0][1], a_tap + k0);
          if constexpr (NT == 4)
            ldsm_x4(b[0], b[1], b[2], b[NT - 1], b_tap + k0);
          else
            ldsm_x2(b[0], b[NT - 1], b_tap + k0);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma16816(acc[i][j], a[i][0], a[i][1], b[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = n0 + 8 * j + 2 * t;
      const Cols cols = load_cols(o);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = m0 + 16 * i + g, r1 = r0 + 8;
        if (r0 < M) fin(r0, r0 / gw, o, cols, acc[i][j][0], acc[i][j][1]);
        if (r1 < M) fin(r1, r1 / gw, o, cols, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// The stage with the widest channel blocks N allows (32, else 16).
template <int KS, int S, int MT, class LoadCols, class Fin>
__device__ __forceinline__ void stage(const int8_t* in, int ips, int inw,
                                      int gh, int gw, const int8_t* w,
                                      int K, int N, LoadCols load_cols,
                                      Fin fin) {
  if (N % 32 == 0)
    conv_stage<KS, S, MT, 4>(in, ips, inw, gh, gw, w, K + kPad, K, N,
                             load_cols, fin);
  else
    conv_stage<KS, S, MT, 2>(in, ips, inw, gh, gw, w, K + kPad, K, N,
                             load_cols, fin);
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copy a (side x side)-pixel tile of an s8 NHWC image, origin (r0, c0),
// into shared memory at `ps` bytes a pixel; zeros off the image.
__device__ __forceinline__ void load_tile(int8_t* dst, int ps, int side,
                                          const int8_t* __restrict__ src,
                                          int h, int w, int ch, int r0,
                                          int c0) {
  const int vecs = ch >> 4;
  for (int idx = threadIdx.x; idx < side * side * vecs; idx += kThreads) {
    const int pix = idx / vecs, vec = idx - pix * vecs;
    const int i = pix / side, j = pix - i * side;
    const int gr = r0 + i, gc = c0 + j;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
    cp_async16(dst + pix * ps + vec * 16,
               in ? src + (static_cast<size_t>(gr) * w + gc) * ch + vec * 16
                  : src,
               in ? 16 : 0);
  }
}

// 16 channels of a bf16 or f32 x from element `off`, quantized to s8:
// clip(rint(x * inv)), each product rounded on its own (-fmad=false).
template <int KIND>
__device__ __forceinline__ uint4 quantize16(const void* __restrict__ src,
                                            size_t off, float inv) {
  float f[16];
  if constexpr (KIND == kBF16) {
    // a bf16 is the top half of the f32 with the same value
    const uint4* s = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(src) + off);
    const uint4 lo = __ldg(s), hi = __ldg(s + 1);
    const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w,
                               hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else {
    const float4* s =
        reinterpret_cast<const float4*>(static_cast<const float*>(src) + off);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = __ldg(s + j);
      f[4 * j] = v.x;
      f[4 * j + 1] = v.y;
      f[4 * j + 2] = v.z;
      f[4 * j + 3] = v.w;
    }
  }
  union {
    uint4 u;
    int8_t s8[16];
  } out;
#pragma unroll
  for (int i = 0; i < 16; ++i) out.s8[i] = clip_rint(__fmul_rn(f[i], inv));
  return out.u;
}

// load_tile for a bf16 or f32 image: each 16 channels read, quantized with
// `inv` and stored as s8 codes; zeros off the image.
template <int KIND>
__device__ __forceinline__ void load_tile_q(int8_t* dst, int ps, int side,
                                            const void* __restrict__ src,
                                            int h, int w, int ch, int r0,
                                            int c0, float inv) {
  const int vecs = ch >> 4;
  for (int idx = threadIdx.x; idx < side * side * vecs; idx += kThreads) {
    const int pix = idx / vecs, vec = idx - pix * vecs;
    const int i = pix / side, j = pix - i * side;
    const int gr = r0 + i, gc = c0 + j;
    uint4 q = make_uint4(0, 0, 0, 0);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      q = quantize16<KIND>(
          src, (static_cast<size_t>(gr) * w + gc) * ch + vec * 16, inv);
    *reinterpret_cast<uint4*>(dst + pix * ps + vec * 16) = q;
  }
}

// Copy `rows` rows of k bytes (a stage's [taps * N, K] weights) into
// shared memory at k + kPad bytes a row.
__device__ __forceinline__ void load_rows(int8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int rows, int k) {
  const int vecs = k >> 4;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int row = idx / vecs, vec = idx - row * vecs;
    cp_async16(dst + row * (k + kPad) + vec * 16,
               src + static_cast<size_t>(row) * k + vec * 16, 16);
  }
}

// Shared memory of one block, in order: a buffer that first holds the
// input tile and stem2's weights (region only), then FB0's 3x3 and the
// exit's weights; the 1x1's weights; q2, q3, q4; the epi table.
struct Layout {
  size_t x, ws2, wfb, wex, wpw, q2, q3, q4, epi, total;
};

__host__ __device__ inline Layout layout(bool region, int tile, int c1, int c,
                                         int cm, int co, int rows, int e) {
  const size_t xw = 4 * tile + 7, qw = 2 * tile + 3, q4w = 2 * tile + 1;
  Layout l;
  l.x = 0;
  l.ws2 = region ? xw * xw * (c1 + kPad) : 0;
  const size_t first = region ? l.ws2 + 9 * static_cast<size_t>(c) *
                                            (c1 + kPad)
                              : 0;
  l.wfb = 0;
  l.wex = 9 * static_cast<size_t>(c) * (cm + kPad);
  const size_t second = l.wex + 9 * static_cast<size_t>(co) * (c + kPad);
  l.wpw = first > second ? first : second;
  l.q2 = l.wpw + static_cast<size_t>(cm) * (c + kPad);
  l.q3 = l.q2 + qw * qw * (c + kPad);
  l.q4 = l.q3 + qw * qw * (cm + kPad);
  l.epi = l.q4 + q4w * q4w * (c + kPad);
  l.total = l.epi + static_cast<size_t>(rows) * e * 4;
  return l;
}

template <bool kRegion>
__global__ void __launch_bounds__(kThreads, 1) region_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int T = p.tile;
  const int XW = 4 * T + 7, QW = 2 * T + 3, Q4W = 2 * T + 1;
  const int xs = p.c1 + kPad, s2s = p.c + kPad, s3s = p.cm + kPad;
  const int s4s = p.c + kPad;
  const int rows = kRegion ? 17 : 13;
  const int e = p.e;
  const Layout L = layout(kRegion, T, p.c1, p.c, p.cm, p.co, rows, e);
  int8_t* q2 = smem + L.q2;
  int8_t* q3 = smem + L.q3;
  int8_t* q4 = smem + L.q4;
  float* E = reinterpret_cast<float*>(smem + L.epi);
  const int img = blockIdx.z;
  const int R0 = blockIdx.y * T, C0 = blockIdx.x * T;

  // epi table, the 1x1's weights, and the first stage's operands
  for (int i = threadIdx.x; i < rows * e / 4; i += kThreads)
    cp_async16(E + 4 * i, p.epi + 4 * i, 16);
  load_rows(smem + L.wpw, p.w_pw, p.cm, p.c);
  if (kRegion) {
    // stem1 rows/cols 4R0-2 .. 4R0+4T+4 feed q2 rows 2R0-1 .. 2R0+2T+1
    const int h1 = 2 * p.h2, w1 = 2 * p.w2;
    const size_t x0 = static_cast<size_t>(img) * h1 * w1 * p.c1;
    load_rows(smem + L.ws2, p.w_s2, 9 * p.c, p.c1);
    if (p.x_kind == kS8)
      load_tile(smem + L.x, xs, XW, static_cast<const int8_t*>(p.x) + x0, h1,
                w1, p.c1, 4 * R0 - 2, 4 * C0 - 2);
    else if (p.x_kind == kBF16)
      load_tile_q<kBF16>(smem + L.x, xs, XW,
                         static_cast<const __nv_bfloat16*>(p.x) + x0, h1, w1,
                         p.c1, 4 * R0 - 2, 4 * C0 - 2, p.inv_in);
    else
      load_tile_q<kF32>(smem + L.x, xs, XW,
                        static_cast<const float*>(p.x) + x0, h1, w1, p.c1,
                        4 * R0 - 2, 4 * C0 - 2, p.inv_in);
    cp_async_wait_all();
    __syncthreads();
    stage<3, 2, 2>(smem + L.x, xs, XW, QW, QW, smem + L.ws2, p.c1, p.c,
                   [&](int o) { return cols_at(E, e, 13, o, false); },
                   [&](int r, int, int o, const Cols& c, int a0, int a1) {
                     *reinterpret_cast<char2*>(q2 + r * s2s + o) =
                         stage_q2(a0, a1, c, p);
                   });
    __syncthreads();  // the input tile and stem2's weights are dead
  } else {
    load_tile(q2, s2s, QW,
              static_cast<const int8_t*>(p.x) +
                  static_cast<size_t>(img) * p.h2 * p.w2 * p.c,
              p.h2, p.w2, p.c, 2 * R0 - 1, 2 * C0 - 1);
    cp_async_wait_all();
    __syncthreads();
  }
  // FB0's 3x3 and the exit's weights arrive while the 1x1 runs
  load_rows(smem + L.wfb, p.w_fb0, 9 * p.c, p.cm);
  load_rows(smem + L.wex, p.w_ex, 9 * p.co, p.c);
  asm volatile("cp.async.commit_group;\n" ::);
  stage<1, 1, 2>(q2, s2s, QW, QW, QW, smem + L.wpw, p.c, p.cm,
                 [&](int o) { return cols_at(E, e, 0, o, false); },
                 [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                   const int gr = 2 * R0 - 1 + i;
                   const int gc = 2 * C0 - 1 + r - i * QW;
                   const bool in =
                       gr >= 0 && gr < p.h2 && gc >= 0 && gc < p.w2;
                   *reinterpret_cast<char2*>(q3 + r * s3s + o) =
                       in ? stage_q2(a0, a1, c, p) : make_char2(0, 0);
                 });
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  stage<3, 1, 2>(q3, s3s, QW, Q4W, Q4W, smem + L.wfb, p.cm, p.c,
                 [&](int o) { return cols_at(E, e, 4, o, true); },
                 [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                   const int j = r - i * Q4W;
                   char2 q = make_char2(0, 0);
                   if (2 * R0 + i < p.h2 && 2 * C0 + j < p.w2) {
                     const char2 res = *reinterpret_cast<const char2*>(
                         q2 + ((i + 1) * QW + j + 1) * s2s + o);
                     q.x = fb0_q(a0, c.b.x, c.m.x, c.a.x, c.r.x, c.inv.x,
                                 static_cast<float>(res.x), p);
                     q.y = fb0_q(a1, c.b.y, c.m.y, c.a.y, c.r.y, c.inv.y,
                                 static_cast<float>(res.y), p);
                   }
                   *reinterpret_cast<char2*>(q4 + r * s4s + o) = q;
                 });
  __syncthreads();
  stage<3, 2, 1>(q4, s4s, Q4W, T, T, smem + L.wex, p.c, p.co,
                 [&](int o) { return cols_at(E, e, 9, o, false); },
                 [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                   const int gr = R0 + i, gc = C0 + r - i * T;
                   if (gr < p.h3 && gc < p.w3)
                     *reinterpret_cast<char2*>(
                         p.out + ((static_cast<size_t>(img) * p.h3 + gr) *
                                      p.w3 + gc) * p.co + o) =
                         stage_q2(a0, a1, c, p);
                 });
}

template <bool kRegion>
int launch_mma(const Params& p, int n, cudaStream_t stream) {
  const size_t smem = layout(kRegion, p.tile, p.c1, p.c, p.cm, p.co,
                             kRegion ? 17 : 13, p.e).total;
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || p.h3 == 0 || p.w3 == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      region_kernel<kRegion>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.w3 + p.tile - 1) / p.tile, (p.h3 + p.tile - 1) / p.tile,
                  n);
  region_kernel<kRegion><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}


// --- the Hopper kernel: persistent blocks, resident weights, wgmma ---------

constexpr int kAlign = 1024;

// bytes of a stage's weights in shared memory: [taps][ksteps][n][32], K
// in 32-byte steps (zeros past k)
__host__ __device__ inline size_t wbytes(int taps, int n, int k) {
  return static_cast<size_t>(taps) * ((k + 31) / 32) * n * 32;
}

// Shared memory of a persistent block, in order: the four stages' weights
// (resident for all its tiles), q2, the input tile (region only), q3, q4,
// the epi table. The activation tiles hold each pixel's channels without
// padding, swizzled (act_off); the input tile has a buffer of its own, so
// the next tile's input is copied in while this tile's later stages run.
// The rawimg kernel (ci > 0) computes its input tile: stem1's weights
// follow the others, and the x tile shares one buffer with q3 and q4,
// which are written only after stem2 has read x. On tensor cores (tc) the
// weights are packed bf16 ([3][c1][32 bytes], then their magnitudes) and
// the image patch, (4T+9) rows of patch_pitch bytes, has a buffer of its
// own after that one, then the queue of the sums stem1 takes again; on
// CUDA cores they are f32 ([9 * ci][c1]) and the f32 patch ((4T+9)^2
// pixels) follows the x tile in the shared buffer.
struct Layout90 {
  size_t ws2, wpw, wfb, wex, w1, q2, x, img, redo, q3, q4, epi, total;
};

// the stem1 sums a tile's queue holds (stem1_wg), in place of taking each
// where it is found
constexpr int kRedo = 1024;

// the elements of a bf16 patch row that stem1_tc reads (side pixels of ci
// channels; the last A row runs 16 elements from pixel side - 3)
__host__ __device__ inline int patch_reads(int side, int ci) {
  const int last = (side - 3) * ci + 16;
  return side * ci > last ? side * ci : last;
}

// bytes of a bf16 patch row: its first byte's offset in its 16-byte chunk
// (< 16) and the elements read, in whole chunks
__host__ __device__ inline int patch_pitch(int side, int ci) {
  return (15 + 2 * patch_reads(side, ci) + 15) / 16 * 16;
}

__host__ __device__ inline Layout90 layout90(bool region, int tile, int c1,
                                             int c, int cm, int co, int rows,
                                             int e, int ci = 0,
                                             bool tc = false) {
  const size_t xw = 4 * tile + 7, qw = 2 * tile + 3, q4w = 2 * tile + 1;
  Layout90 l;
  l.ws2 = 0;
  l.redo = 0;
  l.wpw = l.ws2 + (region ? wbytes(9, c, c1) : 0);
  l.wfb = l.wpw + wbytes(1, cm, c);
  l.wex = l.wfb + wbytes(9, c, cm);
  l.w1 = l.wex + wbytes(9, co, c);
  l.q2 = l.w1 + (tc ? 2 * wbytes(3, c1, 32)
                    : static_cast<size_t>(9) * ci * c1 * 4);
  l.x = l.q2 + qw * qw * c;
  if (ci == 0) {
    l.img = l.x;
    l.q3 = l.x + (region ? xw * xw * c1 : 0);
    l.q4 = l.q3 + qw * qw * cm;
    l.epi = l.q4 + q4w * q4w * c;
  } else if (tc) {
    l.q3 = l.x;
    l.q4 = l.q3 + qw * qw * cm;
    const size_t a = xw * xw * c1;
    const size_t b = qw * qw * cm + q4w * q4w * c;
    l.img = l.x + ((a > b ? a : b) + 15) / 16 * 16;
    // the queue: its count, then its entries
    l.redo = l.img + (xw + 2) * patch_pitch(static_cast<int>(xw) + 2, ci);
    l.epi = l.redo + 16 + 4 * kRedo;
  } else {
    l.img = l.x + xw * xw * c1;
    l.q3 = l.x;
    l.q4 = l.q3 + qw * qw * cm;
    const size_t a = xw * xw * c1 + (xw + 2) * (xw + 2) * ci * 4;
    const size_t b = qw * qw * cm + q4w * q4w * c;
    l.epi = l.x + ((a > b ? a : b) + 15) / 16 * 16;
  }
  l.total = l.epi + static_cast<size_t>(rows) * e * 4 + kAlign;
  return l;
}

// An activation tile in shared memory: pixels of `rb` bytes (their
// channels) one after another, each 16-byte chunk's index XOR the low bits
// of its 128-byte line (as TMA's swizzle does), so the eight rows of an
// ldmatrix that reads neighbouring pixels fall in distinct banks; only
// where rb is a power of two (other widths are not swizzled).
struct Act {
  int8_t* base;
  int rb;
  uint32_t mask;
};

__device__ __forceinline__ Act act(int8_t* base, int rb) {
  const uint32_t lines = rb >= 128 ? 8 : rb / 16;
  return Act{base, rb, rb >= 16 && (rb & (rb - 1)) == 0 ? lines - 1 : 0u};
}

// where a swizzled tile puts byte offset `o`: its 16-byte chunk index
// XOR `mask` of the bits of its 128-byte line
__device__ __forceinline__ uint32_t swizzle(uint32_t o, uint32_t mask) {
  return o ^ (((o >> 7) & mask) << 4);
}

// the offset in the tile of byte `b` (< rb + 16) of pixel `pix`
__device__ __forceinline__ uint32_t act_off(const Act& a, int pix, int b) {
  return swizzle(static_cast<uint32_t>(pix * a.rb + b), a.mask);
}

// wgmma descriptor of an n x 32-byte K-major tile in the 32B swizzle
// (layout 3), 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) |
         (static_cast<uint64_t>(3) << 62);
}

// d[NS/2] += A (64 pixels x 32 bytes, in registers: each warp's 16 rows
// as mma.m16n8k32's A fragment) * B (NS channels x 32 bytes, K-major in
// shared memory)^T, s8 x s8 -> s32
template <int NS>
struct WgmmaA;

template <>
struct WgmmaA<32> {
  __device__ __forceinline__ static void run(uint32_t (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaA<16> {
  __device__ __forceinline__ static void run(uint32_t (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Copy a stage's weights [taps][n][k] s8 into shared memory as
// [taps][ksteps][n][32 bytes] in the 32B swizzle, zeros past k.
__device__ __forceinline__ void load_w90(int8_t* dst,
                                         const int8_t* __restrict__ src,
                                         int taps, int n, int k) {
  const int ks = (k + 31) / 32;
  const int chunks = taps * ks * n * 2;
  for (int idx = threadIdx.x; idx < chunks; idx += kThreads) {
    const int half = idx & 1;
    int rest = idx >> 1;
    const int row = rest % n;
    rest /= n;
    const int kk = rest % ks;
    const int t = rest / ks;
    const uint32_t o = ((t * ks + kk) * n + row) * 32 + half * 16;
    const int kb = kk * 32 + half * 16;
    const bool ok = kb < k;
    // the 32B swizzle of 32-byte rows, as wgmma reads a K-major B in it
    cp_async16(dst + swizzle(o, 1),
               ok ? src + (static_cast<size_t>(t) * n + row) * k + kb : src,
               ok ? 16 : 0);
  }
}

// clip(rint(v * inv), +-127) as the low byte of a float's bits, on the FMA
// pipe alone: clamped first (the same code: the bounds are integers; NaN
// clamps to -127 as fmaxf does there), then rounded half to even by adding
// 1.5 * 2^23
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}

// the low bytes of a, b, c, d as one word (a lowest)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The input tile, in chunks of 16 channels (pixel-major): chunk `idx` of a
// (side x side)-pixel tile at origin (r0, c0) of an NHWC image (h, w, ch).
struct TileIn {
  const void* src;  // the image
  int h, w, ch, side, r0, c0, vecs, total;
};

__device__ __forceinline__ TileIn tile_in(const void* src, int h, int w,
                                          int ch, int side, int r0, int c0) {
  const int vecs = ch >> 4;
  return TileIn{src, h, w, ch, side, r0, c0, vecs, side * side * vecs};
}

// chunk idx's element offset in the image, and its pixel and 16-byte
// column in the tile; false off the image (the chunk reads as zeros)
__device__ __forceinline__ bool chunk_at(const TileIn& t, int idx, size_t& off,
                                         int& pix, int& vec) {
  pix = idx / t.vecs;
  vec = idx - pix * t.vecs;
  const int i = pix / t.side, j = pix - i * t.side;
  const int gr = t.r0 + i, gc = t.c0 + j;
  off = (static_cast<size_t>(gr) * t.w + gc) * t.ch + vec * 16;
  return idx < t.total && gr >= 0 && gr < t.h && gc >= 0 && gc < t.w;
}

// Copy an s8 input tile into an activation tile with cp.async (zeros off
// the image); the caller waits.
__device__ __forceinline__ void copy_tile_s8(const Act& dst, const TileIn& t) {
  for (int idx = threadIdx.x; idx < t.total; idx += kThreads) {
    size_t off;
    int pix, vec;
    const bool in = chunk_at(t, idx, off, pix, vec);
    const int8_t* s = static_cast<const int8_t*>(t.src);
    cp_async16(dst.base + act_off(dst, pix, vec * 16), in ? s + off : s,
               in ? 16 : 0);
  }
}

// A float (bf16 or f32) input tile quantized on arrival: each thread
// carries kFlight chunks at a time, chunks threadIdx.x + (g + kFlight *
// group) * kThreads, from `issue` (the loads) to `land` (the quantize, on
// the FMA pipe: quantize_bits gives clip(rint(x * inv))'s codes, and the
// store). A thread issues a group before a stage and lands it after, so
// the loads' latency passes while the stage runs.
template <int KIND>
struct FloatIn {
  static constexpr int kWords = KIND == kBF16 ? 2 : 4;  // uint4 a chunk
  static constexpr int kFlight = 2;
  uint4 raw[kFlight][kWords];
  bool ok[kFlight];

  __device__ __forceinline__ int first(int group) const {
    return threadIdx.x + group * kFlight * kThreads;
  }

  __device__ __forceinline__ void issue(const TileIn& t, int group) {
#pragma unroll
    for (int g = 0; g < kFlight; ++g) {
      size_t off;
      int pix, vec;
      ok[g] = chunk_at(t, first(group) + g * kThreads, off, pix, vec);
      if (ok[g]) {
        const uint4* s =
            KIND == kBF16
                ? reinterpret_cast<const uint4*>(
                      static_cast<const __nv_bfloat16*>(t.src) + off)
                : reinterpret_cast<const uint4*>(
                      static_cast<const float*>(t.src) + off);
#pragma unroll
        for (int k = 0; k < kWords; ++k) raw[g][k] = __ldg(s + k);
      }
    }
  }

  __device__ __forceinline__ void land(const Act& dst, const TileIn& t,
                                       int group, float inv) const {
#pragma unroll
    for (int g = 0; g < kFlight; ++g) {
      const int idx = first(group) + g * kThreads;
      if (idx >= t.total) break;
      size_t off;
      int pix, vec;
      chunk_at(t, idx, off, pix, vec);
      uint4 out = make_uint4(0, 0, 0, 0);
      if (ok[g]) {
        float f[16];
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const uint32_t wv[4] = {raw[g][k].x, raw[g][k].y, raw[g][k].z,
                                  raw[g][k].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (KIND == kBF16) {
              // a bf16 is the top half of the f32 with the same value
              f[8 * k + 2 * e] = __uint_as_float(wv[e] << 16);
              f[8 * k + 2 * e + 1] = __uint_as_float(wv[e] & 0xffff0000u);
            } else {
              f[4 * k + e] = __uint_as_float(wv[e]);
            }
          }
        }
        uint32_t q[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) q[e] = quantize_bits(f[e], inv);
        out = make_uint4(pack4(q[0], q[1], q[2], q[3]),
                         pack4(q[4], q[5], q[6], q[7]),
                         pack4(q[8], q[9], q[10], q[11]),
                         pack4(q[12], q[13], q[14], q[15]));
      }
      *reinterpret_cast<uint4*>(dst.base + act_off(dst, pix, vec * 16)) = out;
    }
  }

  // the groups from `group` on, issued and landed at once
  __device__ __forceinline__ void rest(const Act& dst, const TileIn& t,
                                       int group, float inv) {
    for (; first(group) < t.total; ++group) {
      issue(t, group);
      land(dst, t, group, inv);
    }
  }
};

// The rawimg kernel's image patch: side x side pixels of the image
// (p.ci channels of KIND) at origin (r0, c0), as f32 in shared memory,
// zeros off the image (stem1's SAME padding). Each thread starts all of
// its loads before it stores any, so their latencies overlap.
constexpr int kImageLoads = 16;  // (4T + 9)^2 * ci <= 16 * kThreads
template <int KIND>
__device__ __forceinline__ void load_image(float* dst, const ImageParams& p,
                                           int img, int r0, int c0,
                                           int side) {
  const int h1 = 2 * p.h2, w1 = 2 * p.w2, ci = p.ci;
  const int total = side * side * ci;
  const size_t base = static_cast<size_t>(img) * h1 * w1 * ci;
  float v[kImageLoads];
#pragma unroll
  for (int k = 0; k < kImageLoads; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int pix = idx / ci, i = pix / side, j = pix - i * side;
    const int gr = r0 + i, gc = c0 + j;
    v[k] = 0.0f;
    if (idx < total && gr >= 0 && gr < h1 && gc >= 0 && gc < w1) {
      const size_t off = base + (static_cast<size_t>(gr) * w1 + gc) * ci +
                         (idx - pix * ci);
      if constexpr (KIND == kImgBF16)
        // a bf16 is the top half of the f32 with the same value
        v[k] = __uint_as_float(static_cast<uint32_t>(__ldg(
                   static_cast<const unsigned short*>(p.x) + off)) << 16);
      else
        v[k] = __ldg(static_cast<const float*>(p.x) + off);
    }
  }
#pragma unroll
  for (int k = 0; k < kImageLoads; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    if (idx < total) dst[idx] = v[k];
  }
}

// stem1's weights [9, c1, ci] of KIND as f32 in shared memory, [9 * ci]
// rows (tap-major, then the image channel) of c1
template <int KIND>
__device__ __forceinline__ void load_stem1_weights(float* dst,
                                                   const ImageParams& p) {
  for (int idx = threadIdx.x; idx < 9 * p.ci * p.c1; idx += kThreads) {
    const int o = idx % p.c1, row = idx / p.c1;
    const int tap = row / p.ci, cc = row - tap * p.ci;
    const size_t src = (static_cast<size_t>(tap) * p.c1 + o) * p.ci + cc;
    if constexpr (KIND == kImgBF16)
      dst[idx] = __uint_as_float(static_cast<uint32_t>(
                     static_cast<const unsigned short*>(p.w_s1)[src]) << 16);
    else
      dst[idx] = static_cast<const float*>(p.w_s1)[src];
  }
}

// stem1's epilogue on its f32 sum: bias, LeakyReLU, BatchNorm and the
// quantize to ConvBlock_1's scale, a stage's exact or fast epilogue (rows
// 17-20: b, mul, add, 1/s1, the 1/s folded into mul and add under fast).
// FAST and CAST: fast and cast_bf16, or p's (-1).
template <int FAST = -1, int CAST = -1>
__device__ __forceinline__ int8_t stem1_q(float acc, float b, float m,
                                          float a, float inv,
                                          const Params& p) {
  const bool fast = FAST < 0 ? p.fast : FAST;
  const bool cast = CAST < 0 ? p.cast_bf16 : CAST;
  if (cast) acc = bf16_round(acc);
  float y = __fadd_rn(acc, b);
  if (fast) {
    y = fmaxf(y, __fmul_rn(p.alpha, y));
    return clip_round<true>(__fadd_rn(__fmul_rn(y, m), a));
  }
  y = y >= 0.0f ? y : __fmul_rn(p.alpha, y);
  y = __fadd_rn(__fmul_rn(y, m), a);
  if (cast) y = bf16_round(y);
  return clip_round<true>(__fmul_rn(y, inv));
}

// The rawimg kernel's input tile: stem1 (3x3, SAME) at stem1 pixels
// 4R0-2 .. 4R0+4T+4 (rows and columns) from the image patch `img` at
// origin 4R0-3, quantized into the activation tile x; code 0 off the
// image (stem2's SAME padding). An item is a pixel and 16 channels, the
// channels outermost so that a warp reads one weight row (broadcast). The
// sum runs over the taps (u, v, channel) in that order, in f32: for a
// bf16 image one FMA a tap, since the product of two bf16 values is
// exact in f32 (the plain version's separately rounded product and add);
// for an f32 image a product and an add.
template <int KIND>
__device__ __forceinline__ void stem1_tile(const Act& x, const float* img,
                                           const float* w1, const float* E,
                                           int e, const ImageParams& p,
                                           int R0,
                                           int C0, int XW) {
  const int side = XW + 2, ci = p.ci, pixels = XW * XW;
  const int h1 = 2 * p.h2, w1d = 2 * p.w2;
  for (int idx = threadIdx.x; idx < pixels * (p.c1 >> 4); idx += kThreads) {
    const int vec = idx / pixels, pix = idx - vec * pixels;
    const int i = pix / XW, j = pix - i * XW;
    const int gr = 4 * R0 - 2 + i, gc = 4 * C0 - 2 + j;
    union {
      uint4 u;
      int8_t s8[16];
    } out;
    out.u = make_uint4(0, 0, 0, 0);
    if (gr >= 0 && gr < h1 && gc >= 0 && gc < w1d) {
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
      const float* ip = img + (i * side + j) * ci;
      const float* wp = w1 + vec * 16;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          for (int cc = 0; cc < ci; ++cc) {
            const float xv = ip[(u * side + v) * ci + cc];
            const float4* w4 = reinterpret_cast<const float4*>(
                wp + ((u * 3 + v) * ci + cc) * p.c1);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 wv = w4[q];
              const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                if constexpr (KIND == kImgBF16)
                  acc[4 * q + r] = __fmaf_rn(xv, ws[r], acc[4 * q + r]);
                else
                  acc[4 * q + r] =
                      __fadd_rn(acc[4 * q + r], __fmul_rn(xv, ws[r]));
              }
            }
          }
        }
      }
      const int o = vec * 16;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        out.s8[k] = stem1_q(acc[k], E[17 * e + o + k], E[18 * e + o + k],
                            E[19 * e + o + k], E[20 * e + o + k], p);
    }
    *reinterpret_cast<uint4*>(x.base + act_off(x, pix, vec * 16)) = out.u;
  }
}

// --- stem1 on tensor cores (a bf16 image) ----------------------------------

// A tile's bf16 image patch: side x side pixels of ci channels from image
// row r0, column c0; `edge` when some of them lie off the image.
struct ImagePatch {
  const uint8_t* src;  // the image [h, w, ci] bf16, 16-byte aligned
  int h, w, ci, side, pitch, r0, c0;
  bool edge;
};

__device__ __forceinline__ ImagePatch image_patch(const Params& p, int ci,
                                                  int img, int r0, int c0,
                                                  int side) {
  const int h = 2 * p.h2, w = 2 * p.w2;
  ImagePatch q;
  q.src = static_cast<const uint8_t*>(p.x) +
          static_cast<size_t>(img) * h * w * ci * 2;
  q.h = h;
  q.w = w;
  q.ci = ci;
  q.side = side;
  q.pitch = patch_pitch(side, ci);
  q.r0 = r0;
  q.c0 = c0;
  q.edge = r0 < 0 || c0 < 0 || r0 + side > h || c0 + side > w;
  return q;
}

// the byte of patch row i where its pixel 0 starts: the row's place, then
// that pixel's offset in its 16-byte chunk of the image (the low bits of a
// two's-complement byte offset, so also off the image)
__device__ __forceinline__ int patch_row(const ImagePatch& q, int i) {
  return i * q.pitch +
         static_cast<int>((static_cast<unsigned>((q.r0 + i) * q.w + q.c0) *
                           static_cast<unsigned>(q.ci) * 2u) & 15u);
}

// Copy the patch with cp.async (the caller waits): each image row as the
// 16-byte chunks that cover it. A patch inside the image copies the
// elements stem1_tc reads (the row's tail runs on into the image's next
// pixels, which the zero weights cancel: rows below exist, since the
// patch's last row is at most h - 3); one that runs off it copies its
// on-image pixels, and fix_patch zeroes the rest.
__device__ __forceinline__ void copy_patch(int8_t* dst, const ImagePatch& q) {
  const int chunks = q.pitch / 16;
  const int ci2 = 2 * q.ci;
  for (int idx = threadIdx.x; idx < q.side * chunks; idx += kThreads) {
    const int i = idx / chunks, k = idx - i * chunks;
    const int gr = q.r0 + i;
    if (gr < 0 || gr >= q.h) continue;
    const long long s = (static_cast<long long>(gr) * q.w + q.c0) * ci2;
    long long lo = s, hi = s + 2LL * patch_reads(q.side, q.ci);
    if (q.edge) {
      lo = s + static_cast<long long>(ci2) * max(0, -q.c0);
      hi = s + static_cast<long long>(ci2) * min(q.side, q.w - q.c0);
    }
    const long long g = (lo & ~15LL) + 16LL * k;
    if (g < hi)
      cp_async16(dst + i * q.pitch + (g - (s & ~15LL)), q.src + g, 16);
  }
}

// A patch that runs off the image: every byte of a row outside its
// on-image pixels to zero (the chunks brought neighbouring bytes; the
// rest still holds an earlier tile's).
__device__ __forceinline__ void fix_patch(int8_t* dst, const ImagePatch& q) {
  const int units = q.pitch / 2;
  const int ci2 = 2 * q.ci;
  for (int idx = threadIdx.x; idx < q.side * units; idx += kThreads) {
    const int i = idx / units, b = 2 * (idx - i * units);
    const int gr = q.r0 + i;
    const int first = patch_row(q, i) - i * q.pitch;
    const int lo = first + ci2 * max(0, -q.c0);
    const int hi = first + ci2 * min(q.side, q.w - q.c0);
    if (gr < 0 || gr >= q.h || b < lo || b >= hi)
      *reinterpret_cast<uint16_t*>(dst + i * q.pitch + b) = 0;
  }
}

// stem1's bf16 weights [9, c1, ci] as B of its three tap rows: [3][c1][16
// bf16] in the 32B swizzle, row o of tap row u holding w[3u + v][o][cc] at
// k = v * ci + cc, zeros from k = 3 ci on (where the A row runs on into the
// next pixels); then their magnitudes in the same layout (the B of the sums
// of |products|). Written by the generic proxy, read by wgmma's.
__device__ __forceinline__ void pack_stem1(int8_t* dst, const ImageParams& p) {
  const uint16_t* w = static_cast<const uint16_t*>(p.w_s1);
  const int abs = 3 * p.c1 * 32;
  for (int idx = threadIdx.x; idx < 3 * p.c1 * 16; idx += kThreads) {
    const int k = idx & 15, row = idx >> 4;  // row = u * c1 + o
    const int u = row / p.c1, o = row - u * p.c1;
    const int v = k / p.ci, cc = k - v * p.ci;
    const uint16_t b =
        v < 3 ? w[((3 * u + v) * p.c1 + o) * p.ci + cc] : uint16_t{0};
    const uint32_t at = swizzle(row * 32 + 2 * k, 1);
    *reinterpret_cast<uint16_t*>(dst + at) = b;
    *reinterpret_cast<uint16_t*>(dst + abs + at) = b & 0x7fffu;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[NS/2] += A (64 pixels x 16 bf16, in registers: each warp's 16 rows as
// mma.m16n8k16's A fragment) * B (NS channels x 16 bf16, K-major in shared
// memory)^T, bf16 x bf16 -> f32 (the sums' bits in d)
template <int NS>
struct WgmmaBF16;

template <>
struct WgmmaBF16<32> {
  __device__ __forceinline__ static void run(uint32_t (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBF16<16> {
  __device__ __forceinline__ static void run(uint32_t (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "0;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// the bf16 pair at elements k, k + 1 of a patch row (2-byte aligned)
__device__ __forceinline__ uint32_t bf16_pair(const uint16_t* row, int k) {
  return static_cast<uint32_t>(row[k]) |
         (static_cast<uint32_t>(row[k + 1]) << 16);
}

// stem1's sum at pixel (i, j) of the x tile and channel o as the plain
// version takes it: over the taps (u, v, channel) in that order, each
// product (of two bf16: exact in f32) and add rounded on its own, from the
// patch and the packed weights `w` (pack_stem1)
__device__ __forceinline__ float stem1_sum(const int8_t* patch,
                                           const ImagePatch& q,
                                           const int8_t* w, int c1, int i,
                                           int j, int o) {
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const uint16_t* row = reinterpret_cast<const uint16_t*>(
                              patch + patch_row(q, i + u)) + q.ci * j;
    // the weights' row: 32 bytes, whose 16-byte halves the swizzle swaps
    // where bit 7 of its offset is set
    const int base = (u * c1 + o) * 32;
    const int flip = (base >> 3) & 16;
#pragma unroll
    for (int k = 0; k < 3 * kMaxImageChannels; ++k)
      if (k < 3 * q.ci)
        s = __fmaf_rn(
            __uint_as_float(static_cast<uint32_t>(row[k]) << 16),
            __uint_as_float(static_cast<uint32_t>(
                                *reinterpret_cast<const uint16_t*>(
                                    w + base + ((2 * k) ^ flip)))
                            << 16),
            s);
  }
  return s;
}

// Whether the plain version's sum, at most `delta` from the tensor cores'
// sum v, could round to another bf16: v lies within delta of the midpoint
// between lo and hi, the bf16 values around it, or (`far`) delta reaches a
// quarter of their distance, so that the plain sum could round past them
// (below a power of two the next step down is half as wide). Otherwise
// the plain sum rounds to lo or hi.
__device__ __forceinline__ bool bf16_in_doubt(float v, float delta,
                                              float& lo, float& hi,
                                              bool& far) {
  const uint32_t t = __float_as_uint(v) & 0xffff0000u;  // toward zero
  const float mid = __uint_as_float(t | 0x8000u);
  lo = __uint_as_float(t);
  hi = __uint_as_float(t + 0x10000u);
  far = fabsf(mid - lo) <= 2.0f * delta;
  return far || fabsf(v - mid) <= delta;
}

// The rawimg kernel's input tile on tensor cores: stem1 at stem1 pixels
// 4R0-2 .. 4R0+4T+4 (rows and columns) as an XW^2 x c1 GEMM over K = 3 tap
// rows x 16 from the patch at origin 4R0-3, its epilogue (stem1_q) from
// the accumulator registers, quantized into the activation tile x; code 0
// off the image. Warpgroup g takes items g, g + 4, ...: 64 pixels x NS
// channels; a thread's A rows are its pixels m0 + lane/4 and that + 8
// (rows past M repeat M - 1 and their sums are dropped). FAST and CAST
// are p.fast and p.cast_bf16, so the epilogue has no branch: a thread's 16
// codes are independent chains that the compiler interleaves.
//
// The codes are the plain version's. The tensor cores sum in their own
// order, so a second GEMM of the products' magnitudes gives each sum's
// S = sum |products|, and the plain version's sum (in order, in f32) is
// within kDoubt * S of the tensor cores' (on the H100, at the flagship,
// 78% of the sums are equal and none lies 2^-21 S apart; the in-order
// sum's own worst case is 26 * 2^-24 S; scripts/stem1_sum_order.py).
// Where that can change the sum's
// bf16 rounding (bf16_in_doubt) and the code with it, the sum is taken
// again in the plain version's order (stem1_sum): queued in `redo` (its
// count, then the entries pixel << 8 | channel), for the block to take
// after stem1_wg (redo_stem1), or here when the queue is full. Without
// the cast every sum is taken so.
constexpr float kDoubt = 4.76837158203125e-07f;  // 2^-21
template <int NS, bool FAST, bool CAST>
__device__ __forceinline__ void stem1_wg(const Act& x, const int8_t* patch,
                                         const ImagePatch& q, const int8_t* w,
                                         int* redo, const float* E, int e,
                                         const ImageParams& p, int R0, int C0,
                                         int XW) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int M = XW * XW, nsl = p.c1 / NS;
  const int items = (M + 63) / 64 * nsl;
  const int h1 = 2 * p.h2, w1 = 2 * p.w2;
  const uint32_t wb = smem_u32(w), wb_abs = wb + 3 * p.c1 * 32;
  // r / XW as a multiply-high: exact for r, XW < 2^16
  const uint32_t xw_div = 0xffffffffu / XW + 1;
  // The sums start from a zero the compiler cannot see (tile > 0). From a
  // literal zero, ptxas turns the first wgmma into one that ignores its
  // input, and has been seen to go on treating the sums as that zero in
  // the integer operations after the wait (an f32 -> bf16 rounding done
  // in the sums' bits then read 0 for every sum).
  const uint32_t zero = static_cast<uint32_t>(p.tile) >> 31;
  for (int item = wg; item < items; item += kWarps / 4) {
    const int mi = item / nsl;
    const int n0 = (item - mi * nsl) * NS;
    const int m0 = mi * 64 + 16 * warp;
    // this thread's pixels m0 + lane/4 and that + 8: their A rows, their
    // place in the tile, and where their codes go (none past M; off the
    // image, code 0)
    uint32_t a[3][4];
    int pi[2], pj[2], at[2];
    bool on[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + (lane >> 2) + 8 * h;
      const int rc = min(r, M - 1);
      const int i = static_cast<int>(__umulhi(rc, xw_div)), j = rc - i * XW;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(
                                  patch + patch_row(q, i + u)) + p.ci * j;
        a[u][h] = bf16_pair(row, 2 * t);
        a[u][h + 2] = bf16_pair(row, 2 * t + 8);
      }
      const int gr = 4 * R0 - 2 + i, gc = 4 * C0 - 2 + j;
      pi[h] = i;
      pj[h] = j;
      at[h] = r < M ? r * x.rb : -1;
      on[h] = r < M && gr >= 0 && gr < h1 && gc >= 0 && gc < w1;
    }
    // accumulator layout: acc[4j + e] is row m0 + lane/4 (+8 for e >= 2),
    // channel n0 + 8j + 2 (lane % 4) + (e & 1)
    // the sums and the sums of the products' magnitudes, A and the
    // accumulators written before wgmma.fence (the A pairs are plain
    // arithmetic, which the compiler could otherwise move past its asm)
    uint32_t acc[NS / 2], mag[NS / 2], a_abs[3][4];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) a_abs[u][k] = a[u][k] & 0x7fff7fffu;
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) acc[k] = mag[k] = zero;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      fence_regs(a[u]);
      fence_regs(a_abs[u]);
    }
    fence_regs(acc);
    fence_regs(mag);
    __syncwarp();  // wgmma's .aligned: the warp converged after the epilogue
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < 3; ++u)
      WgmmaBF16<NS>::run(acc, a[u], desc32(wb + (u * p.c1 + n0) * 32));
#pragma unroll
    for (int u = 0; u < 3; ++u)
      WgmmaBF16<NS>::run(mag, a_abs[u],
                         desc32(wb_abs + (u * p.c1 + n0) * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(mag);
    // The sums in doubt: a bit each. bf16_in_doubt works on a sum's bits
    // through an f32 add of +0 (the same sum; -0 becomes +0, which rounds
    // alike): with integer operations straight on the accumulator
    // registers after the wait, ptxas has been seen to read one of the
    // sixteen as its value before the products (a sixteenth of the sums
    // then in doubt).
    uint32_t doubt = 0;
#pragma unroll
    for (int k = 0; k < NS / 2; ++k) {
      float lo, hi;
      bool far;
      const bool d =
          !CAST || bf16_in_doubt(__fadd_rn(__uint_as_float(acc[k]), 0.0f),
                                 __fmul_rn(__uint_as_float(mag[k]), kDoubt),
                                 lo, hi, far);
      doubt |= static_cast<uint32_t>(d && on[(k >> 1) & 1]) << k;
    }
    // each taken again in order unless its code is the same from lo and hi
    while (doubt) {
      const int k = __ffs(doubt) - 1;
      doubt &= doubt - 1;
      const int h = (k >> 1) & 1, o = n0 + 8 * (k >> 2) + 2 * t + (k & 1);
      const Cols c = cols_at(E, e, 17, o & ~1, false);
      float v = 0.0f, sv = 0.0f;
#pragma unroll
      for (int s = 0; s < NS / 2; ++s)
        if (s == k) {
          v = __uint_as_float(acc[s]);
          sv = __uint_as_float(mag[s]);
        }
      float lo = v, hi = v;
      bool far = true;
      if (CAST)
        bf16_in_doubt(__fadd_rn(v, 0.0f), __fmul_rn(sv, kDoubt), lo, hi, far);
      const bool odd = k & 1;
      const float b = odd ? c.b.y : c.b.x, m = odd ? c.m.y : c.m.x;
      const float aa = odd ? c.a.y : c.a.x, inv = odd ? c.inv.y : c.inv.x;
      if (!CAST || far ||
          stem1_q<FAST, CAST>(lo, b, m, aa, inv, p) !=
              stem1_q<FAST, CAST>(hi, b, m, aa, inv, p)) {
        const int i = h ? pi[1] : pi[0], j = h ? pj[1] : pj[0];
        const int slot = atomicAdd(redo, 1);
        if (slot < kRedo) {
          redo[4 + slot] = (i * XW + j) << 8 | o;
        } else {
          const float sum = stem1_sum(patch, q, w, p.c1, i, j, o);
#pragma unroll
          for (int s = 0; s < NS / 2; ++s)
            if (s == k) acc[s] = __float_as_uint(sum);
        }
      }
    }
    char2 out[NS / 8][2];
#pragma unroll
    for (int jn = 0; jn < NS / 8; ++jn) {
      const Cols c = cols_at(E, e, 17, n0 + 8 * jn + 2 * t, false);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const char2 v = make_char2(
            stem1_q<FAST, CAST>(__uint_as_float(acc[4 * jn + 2 * h]),
                                c.b.x, c.m.x, c.a.x, c.inv.x, p),
            stem1_q<FAST, CAST>(__uint_as_float(acc[4 * jn + 2 * h + 1]),
                                c.b.y, c.m.y, c.a.y, c.inv.y, p));
        out[jn][h] = on[h] ? v : make_char2(0, 0);
      }
    }
#pragma unroll
    for (int jn = 0; jn < NS / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (at[h] >= 0)
          *reinterpret_cast<char2*>(
              x.base + swizzle(at[h] + n0 + 8 * jn + 2 * t, x.mask)) =
              out[jn][h];
  }
}

// stem1_wg with 32-channel slices where c1 allows, else 16, and p's
// epilogue flags
template <int NS>
__device__ __forceinline__ void stem1_ns(const Act& x, const int8_t* patch,
                                         const ImagePatch& q, const int8_t* w,
                                         int* redo, const float* E, int e,
                                         const ImageParams& p, int R0, int C0,
                                         int XW) {
  if (p.fast) {
    if (p.cast_bf16)
      stem1_wg<NS, true, true>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
    else
      stem1_wg<NS, true, false>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
  } else {
    if (p.cast_bf16)
      stem1_wg<NS, false, true>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
    else
      stem1_wg<NS, false, false>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
  }
}

__device__ __forceinline__ void stem1_tc(const Act& x, const int8_t* patch,
                                         const ImagePatch& q, const int8_t* w,
                                         int* redo, const float* E, int e,
                                         const ImageParams& p, int R0, int C0,
                                         int XW) {
  if (p.c1 % 32 == 0)
    stem1_ns<32>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
  else
    stem1_ns<16>(x, patch, q, w, redo, E, e, p, R0, C0, XW);
}

// The sums stem1_tc queued: each taken in the plain version's order by a
// thread of the block, its code into x (stem1_q on p's flags: the same
// operations as stem1_wg's)
__device__ __forceinline__ void redo_stem1(const Act& x, const int8_t* patch,
                                           const ImagePatch& q,
                                           const int8_t* w, const int* redo,
                                           const float* E, int e,
                                           const ImageParams& p, int XW) {
  const int n = min(redo[0], kRedo);
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = redo[4 + idx] >> 8, o = redo[4 + idx] & 255;
    const int i = r / XW, j = r - i * XW;
    x.base[act_off(x, r, o)] = stem1_q(
        stem1_sum(patch, q, w, p.c1, i, j, o), E[17 * e + o],
        E[18 * e + o], E[19 * e + o], E[20 * e + o], p);
  }
}

// One stage on wgmma, over activation tiles in shared memory (any pixel
// rows: a tap's shifted or strided window needs no copy) with the weights
// at `wb` as load_w90 lays them out. Warpgroup g takes items g, g + 4,
// ...: 64 pixel rows x NS channels. Each of its warps loads, with one
// ldmatrix.x4 a tap and 32-byte K step, its 16 rows' A fragment into
// registers; the rows past M repeat row M - 1 and their sums are dropped.
// `fin(r, r / gw, o, load_cols(o), acc_o, acc_o+1)` takes every pair of
// sums, with the epilogue constants of channels o, o+1.
template <int KS, int S, int NS, class LoadCols, class Fin>
__device__ __forceinline__ void wg_stage(const Act& in, int inw, int gh,
                                         int gw, uint32_t wb, int K, int N,
                                         LoadCols load_cols, Fin fin) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int M = gh * gw;
  const int nsl = N / NS;
  const int items = (M + 63) / 64 * nsl;
  const int ksteps = (K + 31) / 32;
  const uint32_t base = smem_u32(in.base);
  for (int item = wg; item < items; item += kWarps / 4) {
    const int mi = item / nsl;
    const int n0 = (item - mi * nsl) * NS;
    const int m0 = mi * 64 + 16 * warp;
    const int r = min(m0 + (lane & 15), M - 1);
    const int ri = r / gw;
    const int pix0 = (ri * S) * inw + (r - ri * gw) * S;
    uint32_t acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int b = ks * 32 + (lane >> 4) * 16;
      uint32_t a[KS * KS][4];
#pragma unroll
      for (int u = 0; u < KS; ++u)
#pragma unroll
        for (int v = 0; v < KS; ++v)
          ldsm_x4(a[u * KS + v][0], a[u * KS + v][1], a[u * KS + v][2],
                  a[u * KS + v][3],
                  base + act_off(in, pix0 + u * inw + v, b));
      fence_regs(acc);
      __syncwarp();  // wgmma's .aligned: the warp converged after `fin`
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int t = 0; t < KS * KS; ++t)
        WgmmaA<NS>::run(acc, a[t],
                        desc32(wb + ((t * ksteps + ks) * N + n0) * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
    }
    // accumulator layout: acc[4j + e] is row m0 + lane/4 (+8 for e >= 2),
    // channel n0 + 8j + 2 (lane % 4) + (e & 1)
    const int r0 = m0 + (lane >> 2), r1 = r0 + 8;
    const int i0 = r0 / gw, i1 = r1 / gw;
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int o = n0 + 8 * j + 2 * (lane & 3);
      const Cols cols = load_cols(o);
      if (r0 < M)
        fin(r0, i0, o, cols, static_cast<int>(acc[4 * j]),
            static_cast<int>(acc[4 * j + 1]));
      if (r1 < M)
        fin(r1, i1, o, cols, static_cast<int>(acc[4 * j + 2]),
            static_cast<int>(acc[4 * j + 3]));
    }
  }
}

// wg_stage with the channel slices (32 or 16) that share the stage out
// most evenly over the four warpgroups (the fewest channels a warpgroup
// handles; 32 on a tie)
template <int KS, int S, class LoadCols, class Fin>
__device__ __forceinline__ void stage90(const Act& in, int inw, int gh,
                                        int gw, uint32_t wb, int K, int N,
                                        LoadCols load_cols, Fin fin) {
  const int mb = (gh * gw + 63) / 64;
  const int by32 = (mb * (N / 32) + 3) / 4 * 32;
  const int by16 = (mb * (N / 16) + 3) / 4 * 16;
  if (N % 32 == 0 && by32 <= by16)
    wg_stage<KS, S, 32>(in, inw, gh, gw, wb, K, N, load_cols, fin);
  else
    wg_stage<KS, S, 16>(in, inw, gh, gw, wb, K, N, load_cols, fin);
}

// The region (kRegion) or the tail, one persistent block walking tiles
// blockIdx.x, + gridDim.x, ...; KIND is x's (the tail's is s8; an image
// kind runs stem1 on each tile's image patch first: on tensor cores with
// kTC, a bf16 image only, else on CUDA cores), kFast the epilogue's
// variant (0 exact, 1 fast, 2 affine2, whose exit runs the fast one).
template <bool kRegion, int KIND, int kFast, bool kTC = false>
__global__ void __launch_bounds__(kThreads, 1)
region_kernel90(const KernelParams<KIND> p, int tiles_h, int tiles_w,
                int tiles) {
  constexpr bool kImg = kRegion && (KIND == kImgBF16 || KIND == kImgF32);
  static_assert(!kTC || (kRegion && KIND == kImgBF16),
                "stem1 runs on tensor cores for a bf16 image only");
  constexpr bool kCores = kImg && !kTC;
  constexpr int kExit = kFast == 2 ? 1 : kFast;
  extern __shared__ uint8_t smem_raw90[];
  const uint32_t raw = smem_u32(smem_raw90);
  int8_t* const smem = reinterpret_cast<int8_t*>(
      smem_raw90 + (((raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1)) -
                    raw));
  const int T = p.tile;
  const int XW = 4 * T + 7, QW = 2 * T + 3, Q4W = 2 * T + 1;
  const int rows = kImg ? 21 : kRegion ? 17 : 13;
  const int e = p.e;
  const Layout90 L = layout90(kRegion, T, p.c1, p.c, p.cm, p.co, rows, e,
                              image_channels(p), kTC);
  const Act x = act(smem + L.x, p.c1), q2 = act(smem + L.q2, p.c);
  const Act q3 = act(smem + L.q3, p.cm), q4 = act(smem + L.q4, p.c);
  float* E = reinterpret_cast<float*>(smem + L.epi);
  const uint32_t ws2 = smem_u32(smem + L.ws2), wpw = smem_u32(smem + L.wpw);
  const uint32_t wfb = smem_u32(smem + L.wfb), wex = smem_u32(smem + L.wex);

  // the weights and the epi table, once for all of the block's tiles
  if (kRegion) load_w90(smem + L.ws2, p.w_s2, 9, p.c, p.c1);
  load_w90(smem + L.wpw, p.w_pw, 1, p.cm, p.c);
  load_w90(smem + L.wfb, p.w_fb0, 9, p.c, p.cm);
  load_w90(smem + L.wex, p.w_ex, 9, p.co, p.c);
  for (int i = threadIdx.x; i < rows * e / 4; i += kThreads)
    cp_async16(E + 4 * i, p.epi + 4 * i, 16);
  float* const patch = reinterpret_cast<float*>(smem + L.img);
  const float* const w1 = reinterpret_cast<const float*>(smem + L.w1);
  if constexpr (kCores)
    load_stem1_weights<KIND>(reinterpret_cast<float*>(smem + L.w1), p);
  // tile t's bf16 image patch (stem1 rows/cols 4R0-2 .. 4R0+4T+4 read
  // image rows/cols 4R0-3 .. 4R0+4T+5)
  const auto patch_at = [&](int t) {
    const int img = t / (tiles_h * tiles_w);
    const int rem = t - img * tiles_h * tiles_w;
    return image_patch(p, image_channels(p), img,
                       4 * (rem / tiles_w) * T - 3,
                       4 * (rem % tiles_w) * T - 3, XW + 2);
  };
  int* const redo = reinterpret_cast<int*>(smem + L.redo);
  if constexpr (kTC) {
    pack_stem1(smem + L.w1, p);
    copy_patch(smem + L.img, patch_at(blockIdx.x));
    if (threadIdx.x == 0) redo[0] = 0;
  }

  // tile t's input: the region's x tile (stem1 rows/cols 4R0-2 ..
  // 4R0+4T+4 feed q2 rows 2R0-1 .. 2R0+2T+1), or the tail's q2 tile
  const auto input = [&](int t) {
    const int img = t / (tiles_h * tiles_w);
    const int rem = t - img * tiles_h * tiles_w;
    const int R0 = (rem / tiles_w) * T, C0 = (rem % tiles_w) * T;
    if (kRegion) {
      const int h1 = 2 * p.h2, w1 = 2 * p.w2;
      const size_t x0 = static_cast<size_t>(img) * h1 * w1 * p.c1;
      const void* src =
          KIND == kS8
              ? static_cast<const void*>(static_cast<const int8_t*>(p.x) + x0)
          : KIND == kBF16
              ? static_cast<const void*>(
                    static_cast<const __nv_bfloat16*>(p.x) + x0)
              : static_cast<const void*>(static_cast<const float*>(p.x) + x0);
      return tile_in(src, h1, w1, p.c1, XW, 4 * R0 - 2, 4 * C0 - 2);
    }
    return tile_in(static_cast<const int8_t*>(p.x) +
                       static_cast<size_t>(img) * p.h2 * p.w2 * p.c,
                   p.h2, p.w2, p.c, QW, 2 * R0 - 1, 2 * C0 - 1);
  };
  constexpr bool kFloat = kRegion && (KIND == kBF16 || KIND == kF32);
  FloatIn<kFloat ? KIND : kBF16> next;
  // a float input's first three groups of chunks are prefetched during the
  // previous tile's pw, fb0 and exit; the rest, and the first tile, here
  int landed = 0;
  if (KIND == kS8 || !kRegion)
    copy_tile_s8(kRegion ? x : q2, input(blockIdx.x));

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int img = t / (tiles_h * tiles_w);
    const int rem = t - img * tiles_h * tiles_w;
    const int R0 = (rem / tiles_w) * T, C0 = (rem % tiles_w) * T;
    const int tn = t + gridDim.x;  // the block's next tile
    if constexpr (kCores) {
      // stem1 rows/cols 4R0-2 .. 4R0+4T+4 read image rows/cols 4R0-3 ..
      // 4R0+4T+5
      load_image<KIND>(patch, p, img, 4 * R0 - 3, 4 * C0 - 3, XW + 2);
      cp_async_wait_all();  // the weights and the epi table, first tile
      __syncthreads();
      stem1_tile<KIND>(x, patch, w1, E, e, p, R0, C0, XW);
    }
    if constexpr (kTC) {
      const ImagePatch q = patch_at(t);
      cp_async_wait_all();  // the patch (and first the weights, the table)
      __syncthreads();
      if (q.edge) {
        fix_patch(smem + L.img, q);
        __syncthreads();
      }
      stem1_tc(x, smem + L.img, q, smem + L.w1, redo, E, e, p, R0, C0, XW);
      __syncthreads();
      redo_stem1(x, smem + L.img, q, smem + L.w1, redo, E, e, p, XW);
    }
    if (kFloat) next.rest(x, input(t), landed, p.inv_in);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (kTC) {
      if (threadIdx.x == 0) redo[0] = 0;  // the queue is taken
      // the next tile's patch arrives while this tile's stages run
      if (tn < tiles) copy_patch(smem + L.img, patch_at(tn));
    }
    if (kRegion) {
      stage90<3, 2>(x, XW, QW, QW, ws2, p.c1, p.c,
                    [&](int o) { return cols_at(E, e, 13, o, false); },
                    [&](int r, int, int o, const Cols& c, int a0, int a1) {
                      *reinterpret_cast<char2*>(q2.base + act_off(q2, r, o)) =
                          stage_q2<kFast, true>(a0, a1, c, p);
                    });
      __syncthreads();  // q2 is complete; the input tile is free
      if (tn < tiles) {
        if (kFloat)
          next.issue(input(tn), 0);
        else if (!kImg)
          copy_tile_s8(x, input(tn));
      }
    }
    stage90<1, 1>(q2, QW, QW, QW, wpw, p.c, p.cm,
                  [&](int o) { return cols_at(E, e, 0, o, false); },
                  [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                    const int gr = 2 * R0 - 1 + i;
                    const int gc = 2 * C0 - 1 + r - i * QW;
                    const bool in =
                        gr >= 0 && gr < p.h2 && gc >= 0 && gc < p.w2;
                    *reinterpret_cast<char2*>(q3.base + act_off(q3, r, o)) =
                        in ? stage_q2<kFast, true>(a0, a1, c, p)
                           : make_char2(0, 0);
                  });
    if (kFloat && tn < tiles) {
      next.land(x, input(tn), 0, p.inv_in);
      next.issue(input(tn), 1);
    }
    __syncthreads();
    stage90<3, 1>(q3, QW, Q4W, Q4W, wfb, p.cm, p.c,
                  [&](int o) { return cols_at(E, e, 4, o, true); },
                  [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                    const int j = r - i * Q4W;
                    char2 q = make_char2(0, 0);
                    if (2 * R0 + i < p.h2 && 2 * C0 + j < p.w2) {
                      const char2 res = *reinterpret_cast<const char2*>(
                          q2.base + act_off(q2, (i + 1) * QW + j + 1, o));
                      q.x = fb0_q<kFast, true>(a0, c.b.x, c.m.x, c.a.x,
                                               c.r.x, c.inv.x,
                                               static_cast<float>(res.x), p);
                      q.y = fb0_q<kFast, true>(a1, c.b.y, c.m.y, c.a.y,
                                               c.r.y, c.inv.y,
                                               static_cast<float>(res.y), p);
                    }
                    *reinterpret_cast<char2*>(q4.base + act_off(q4, r, o)) =
                        q;
                  });
    if (kFloat && tn < tiles) {
      next.land(x, input(tn), 1, p.inv_in);
      next.issue(input(tn), 2);
    }
    __syncthreads();  // q4 is complete; q2 is free
    if (!kRegion && tn < tiles) copy_tile_s8(q2, input(tn));
    stage90<3, 2>(q4, Q4W, T, T, wex, p.c, p.co,
                  [&](int o) { return cols_at(E, e, 9, o, false); },
                  [&](int r, int i, int o, const Cols& c, int a0, int a1) {
                    const int gr = R0 + i, gc = C0 + r - i * T;
                    if (gr < p.h3 && gc < p.w3)
                      *reinterpret_cast<char2*>(
                          p.out + ((static_cast<size_t>(img) * p.h3 + gr) *
                                       p.w3 + gc) * p.co + o) =
                          stage_q2<kExit, true>(a0, a1, c, p);
                  });
    if (kFloat && tn < tiles) next.land(x, input(tn), 2, p.inv_in);
    landed = 3;
    __syncthreads();  // q4 is read before the next tile's stages
  }
}

// Launch `kernel` on min(tiles, SMs) persistent blocks with `smem` bytes
// of shared memory.
template <class P>
int launch_blocks(void (*kernel)(const P, int, int, int), const P& p,
                  size_t smem, int n, cudaStream_t stream) {
  if (n == 0 || p.h3 == 0 || p.w3 == 0) return 0;
  const int tiles_h = (p.h3 + p.tile - 1) / p.tile;
  const int tiles_w = (p.w3 + p.tile - 1) / p.tile;
  const long long tiles = static_cast<long long>(n) * tiles_h * tiles_w;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  kernel<<<grid, kThreads, smem, stream>>>(p, tiles_h, tiles_w,
                                           static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// The kernel of x's kind and the epilogue's variant (the tail: s8,
// exact); an image kind's with stem1's weights w_s1 and the image's ci
// channels, stem1 on tensor cores for a bf16 image unless `cores`.
template <bool kRegion>
int launch90(const Params& p, int n, int affine2, const void* w_s1, int ci,
             bool cores, cudaStream_t stream) {
  const bool image = p.x_kind == kImgBF16 || p.x_kind == kImgF32;
  const bool tc = p.x_kind == kImgBF16 && !cores;
  const size_t smem = layout90(kRegion, p.tile, p.c1, p.c, p.cm, p.co,
                               image ? 21 : kRegion ? 17 : 13, p.e,
                               image ? ci : 0, tc).total;
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!kRegion) {
    return launch_blocks(region_kernel90<false, kS8, 0>, p, smem, n, stream);
  } else {
#define REGION_MODES(K, TC) \
  {region_kernel90<true, K, 0, TC>, region_kernel90<true, K, 1, TC>, \
   region_kernel90<true, K, 2, TC>}
    const int mode = affine2 ? 2 : p.fast ? 1 : 0;
    if (image) {
      using Kernel = void (*)(const ImageParams, int, int, int);
      const Kernel table[3][3] = {REGION_MODES(kImgBF16, true),
                                  REGION_MODES(kImgBF16, false),
                                  REGION_MODES(kImgF32, false)};
      const ImageParams ip{p, w_s1, ci};
      return launch_blocks(table[tc ? 0 : p.x_kind - kImgBF16 + 1][mode], ip,
                           smem, n, stream);
    }
    using Kernel = void (*)(const Params, int, int, int);
    const Kernel table[3][3] = {REGION_MODES(kS8, false),
                                REGION_MODES(kBF16, false),
                                REGION_MODES(kF32, false)};
#undef REGION_MODES
    return launch_blocks(table[p.x_kind][mode], p, smem, n, stream);
  }
}

bool channels_ok(int c1, int c, int cm, int co) {
  return c1 > 0 && c > 0 && cm > 0 && co > 0 && c1 % 16 == 0 &&
         c % 16 == 0 && cm % 16 == 0 && co % 16 == 0;
}


// x [n, h1, w1, c1] (h1, w1 multiples of 4) of kind x_kind (0 s8, 1 bf16,
// 2 f32: quantized with inv_in) -> out s8 [n, h1/4, w1/4, co]. epi f32
// [17, e], e >= max(c, cm, co). x_kind 3 or 4: x is the bf16 or f32 image
// [n, h1, w1, ci] (ci <= kMaxImageChannels), w_s1 stem1's weights [9, c1,
// ci] of its type, epi [21, e] with stem1's rows, e >= c1 too. `affine2`:
// the affine2 epilogue. `twin` runs the first design (neither mode);
// `cores` an image's stem1 on CUDA cores (the rawimg mode's first design).
// Returns a cudaError_t code.
int region_entry(const void* x, int x_kind, float inv_in, const int8_t* w_s2,
                 const int8_t* w_pw, const int8_t* w_fb0, const int8_t* w_ex,
                 const float* epi, int epi_rows, int e, int8_t* out, int n,
                 int h1, int w1, int c1, int c, int cm, int co, int tile,
                 float alpha, int cast_bf16, int fast, const void* w_s1,
                 int ci, int affine2, bool twin, bool cores,
                 cudaStream_t stream) {
  const bool image = x_kind == kImgBF16 || x_kind == kImgF32;
  if (h1 % 4 || w1 % 4 || !channels_ok(c1, c, cm, co) ||
      epi_rows != (image ? 21 : 17) || e < c || e < cm || e < co ||
      (image && e < c1) || e % 4 || tile < 1 || n > 65535 ||
      x_kind < kS8 || x_kind > kImgF32 ||
      (image && (w_s1 == nullptr || ci < 1 || ci > kMaxImageChannels ||
                 (4 * tile + 9) * (4 * tile + 9) * ci >
                     kImageLoads * kThreads)) ||
      (twin && (image || affine2)) || (cores && !image))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,      w_s2,   w_pw,   w_fb0,  w_ex,  epi,   out,
                 h1 / 2, w1 / 2, h1 / 4, w1 / 4, c1,    c,     cm,
                 co,     e,      tile,   alpha,  cast_bf16, fast, x_kind,
                 inv_in};
  return twin ? launch_mma<true>(p, n, stream)
              : launch90<true>(p, n, affine2, w_s1, ci, cores, stream);
}

// x s8 [n, h2, w2, c] (stem2's output; h2, w2 even) -> out s8
// [n, h2/2, w2/2, co]; epi f32 [13, e], the exact epilogue.
int tail_entry(const int8_t* x, const int8_t* w_pw, const int8_t* w_fb0,
               const int8_t* w_ex, const float* epi, int epi_rows, int e,
               int8_t* out, int n, int h2, int w2, int c, int cm, int co,
               int tile, float alpha, int cast_bf16, bool twin,
               cudaStream_t stream) {
  if (h2 % 2 || w2 % 2 || !channels_ok(16, c, cm, co) || epi_rows != 13 ||
      e < c || e < cm || e < co || e % 4 || tile < 1 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,  nullptr, w_pw,   w_fb0,  w_ex, epi,   out,
                 h2, w2,      h2 / 2, w2 / 2, 0,    c,     cm,
                 co, e,       tile,   alpha,  cast_bf16, 0, kS8, 1.0f};
  return twin ? launch_mma<false>(p, n, stream)
              : launch90<false>(p, n, 0, nullptr, 0, false, stream);
}

}  // namespace

#define REGION_ARGS                                                         \
  const void *x, int x_kind, float inv_in, const int8_t *w_s2,              \
      const int8_t *w_pw, const int8_t *w_fb0, const int8_t *w_ex,          \
      const float *epi, int epi_rows, int e, int8_t *out, int n, int h1,    \
      int w1, int c1, int c, int cm, int co, int tile, float alpha,         \
      int cast_bf16, int fast, const void *w_s1, int ci, int affine2,       \
      cudaStream_t stream
#define REGION_PASS                                                         \
  x, x_kind, inv_in, w_s2, w_pw, w_fb0, w_ex, epi, epi_rows, e, out, n, h1, \
      w1, c1, c, cm, co, tile, alpha, cast_bf16, fast, w_s1, ci, affine2
#define TAIL_ARGS                                                           \
  const int8_t *x, const int8_t *w_pw, const int8_t *w_fb0,                 \
      const int8_t *w_ex, const float *epi, int epi_rows, int e,            \
      int8_t *out, int n, int h2, int w2, int c, int cm, int co, int tile,  \
      float alpha, int cast_bf16, cudaStream_t stream
#define TAIL_PASS                                                           \
  x, w_pw, w_fb0, w_ex, epi, epi_rows, e, out, n, h2, w2, c, cm, co, tile,  \
      alpha, cast_bf16

extern "C" int s2d_region_block_q(REGION_ARGS) {
  return region_entry(REGION_PASS, false, false, stream);
}
extern "C" int s2d_region_block_q_mma(REGION_ARGS) {
  return region_entry(REGION_PASS, true, false, stream);
}
extern "C" int s2d_region_block_q_cores(REGION_ARGS) {
  return region_entry(REGION_PASS, false, true, stream);
}
extern "C" int s2d_tail_block_q(TAIL_ARGS) {
  return tail_entry(TAIL_PASS, false, stream);
}
extern "C" int s2d_tail_block_q_mma(TAIL_ARGS) {
  return tail_entry(TAIL_PASS, true, stream);
}
