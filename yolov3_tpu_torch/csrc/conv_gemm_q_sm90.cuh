// Hopper-native core of the port's int8 1x1, 3x3 and 3x3 stride-2
// ConvBlock kernels (float or s8 input) and of its bf16 1x1 ConvBlock
// (sm_90a): pointwise_conv_block_q.cu, conv3x3_block_q.cu,
// down_conv_block_q.cu and exit_conv_block_q.cu include it and expose one
// C entry point each (CONVQ90_ENTRY),
// pointwise_conv_block.cu one more (bf16 operands); each checks its own
// contract and the tile plan before it launches. The
// operand type is one template parameter (OP) of one kernel: the ring,
// barriers, producer, persistent loop and epilogue swizzle are shared.
//
// bf16 operands (OP = kOpBF16): y = leaky(x @ W^T + bias) * mul + add
// over x [M, Ci] and W [Co, Ci] bf16 (K-major, like the s8 weights, so
// both operands' descriptors are the s8 ones: a wgmma k16 step of bf16
// is 32 bytes of K, as a k32 step of s8), summed in f32 (wgmma
// m64nBNk16 .f32.bf16.bf16, as many accumulator registers as s32), the
// f32 epilogue of conv_block_kernel.py, stored bf16 or f32. The tensor
// maps are over bytes for both types, so BK (64 or 128 bytes) is 32 or
// 64 bf16 channels and TMA's zero fill pads Ci in K.
//
// s8 operands compute what conv_block_q.cuh computes, code for code: the
// implicit GEMM over NHWC tensors, exact in int32,
//
//     acc[p, o] = sum_{u,v} sum_c q(x[n, oh*s - pt + u, ow*s - pl + v, c])
//                                * W[u, v][o, c]
//
// (stride s 1, or 2 for a 3x3 on any x; pt, pl the XLA SAME pads)
// with the taps outside the image reading zeros, then the same float32
// epilogue op by op (see conv_block_q.cuh; -fmad=false, rintf): b/dq,
// leaky, mul*dq, add, the optional bf16 casts, the s8 residual, the
// bf16 / f32 output and the quantize with 1/s_next (a scalar, or epi row
// 3 with `inv_next_row`).
//
// What bounds it, and what the design does about it. At b8 on the
// serving path the 3x3s do 2*M*9*C*Co operations over M*(C + 2*Co)
// bytes, 190..3000 operations a byte: the deep 16^2-64^2 stages are bound
// by the tensor cores, the 128^2 stage by its bytes. The 1x1s do
// 2*M*Ci*Co over M*(Ci + Co) bytes, 20..340 a byte: all bound by bytes.
// The stride-2 3x3s (bf16 in) do 2*M*9*C*Co over about 4*M*C*2 + M*Co
// bytes (M output pixels), 140..2300 a byte; the stem region's exit (s8
// in, 256^2 x 64 -> 128) ~380 a byte, bound by its bytes. All were held
// back by
// latency, not by either bound: WMMA fragments, and a K loop that waited
// on device memory at every step. On this core the s8 launches are bound
// by the L2 -> SM stream of their tiles (each SM draws ~36 GB/s from L2
// whatever the others do, and a 3x3 re-reads each pixel for each of its
// nine taps), the bf16 / f32 ones by the quantize in the producer. So:
// - products: wgmma m64nBNk32 s8 x s8 -> s32 (or k16 bf16 -> f32), A
//   and B read from shared memory through K-major descriptors (64B or
//   128B swizzle, BK bytes of K a row), accumulators in the consumer
//   warpgroups' registers;
// - copies: a ring of `stages` tiles in dynamic shared memory with a
//   full and an empty mbarrier per stage; one producer warpgroup keeps
//   the ring filled while the consumers multiply, so a stage's copy
//   overlaps the products of the stages before it;
// - persistent blocks: min(tiles, SMs) blocks each walk tiles b, b +
//   grid, ...; the ring runs on across tiles, so the next tile's copies
//   overlap this tile's epilogue;
// - s8 inputs through TMA. The 1x1's A is a 2D map over [M, Ci]. The
//   3x3's A is a 4D map over [N, H, W, Ci], and a block's pixels are a
//   TH x TW rectangle of one output image (TH*TW = BM): tap (u, v) is
//   then the same box at (oh0*s - pt + u, ow0*s - pl + v), and TMA's zero
//   fill of the elements outside the tensor IS the SAME padding (and the
//   ragged Ci, Co and pixel edges). At stride 2 the map traverses H and W
//   with element strides of 2 (a 2TH x 2TW traversal box, so TW <= 128)
//   and lands the same dense TH x TW x BK box. Weights: a 3D map over
//   [taps, Co, Ci];
// - bf16 and f32 inputs: the producer warpgroups load 16 channels at a
//   time, four chunks' loads in flight together, quantizes them to the
//   codes of conv_block_q.cuh's load_a16 (the 1x1's requantized residual
//   first) on the FMA pipe alone (quantize_bits), and writes the same
//   swizzled layout that TMA writes, into the same ring, one arrival a
//   warp; the weights still come by TMA. The stride enters only the
//   address of each chunk row's pixel (ih = oh*s - pt + u): at stride 2
//   each input pixel is loaded and quantized by ~2.25 taps, not 9;
// - the epilogue from the accumulator registers: lanes swap half their
//   sums with a neighbour so each holds four consecutive channels of
//   one pixel, and reads the residual and stores s8 / bf16 / f32 four
//   channels (4, 8 or 16 bytes) at a time; the tile's epilogue rows are
//   copied into shared memory once a tile (read from device memory, each
//   4-channel step would wait for its own loads);
// - the s8 stride-2 path (RES, the exit's library alone; a ~20% faster
//   exit on the H100, PERF.md): each consumer warpgroup makes every s8
//   code of its tile before it stores any (the bf16 cast and the
//   quantize on the integer and FMA pipes, bf16_round_bits and
//   quantize_bits, rather than the conversion pipe), stages them in
//   shared memory and writes whole pixels' channels 16 bytes a thread;
// - the tile plan (BM 64 or 128 pixels, BN 32/64/128/256 channels, BK 64
//   or 128 bytes, TH x TW, stages) is chosen per launch in Python
//   (ops/kernels/_conv_q.py::conv_plan): the largest tiles that keep the
//   132 SMs busy, since each SM's L2 stream is the limit.
//
// Block layout: bm/64 consumer warpgroups (threads 0 .. bm*2-1), each
// owning 64 pixels x BN channels, then one producer warpgroup, or for a
// float x's converting producer as many as make three warpgroups (two
// under BM = 64, which take the K steps in turns, so that two steps'
// loads are in flight); setmaxnreg moves registers from the producers to
// the consumers.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Everything here has internal linkage: the two libraries that include
// this header are loaded into one process, and a function-local static of
// an inline function would otherwise be one object shared by both.
namespace convq90 {
namespace {

enum InKind { kS8 = 0, kBF16 = 1, kF32 = 2 };  // as convq::InKind
// the products' operands: s8 x s8 -> s32 (the int8 ConvBlocks) or bf16 x
// bf16 -> f32 (the bf16 1x1 ConvBlock)
enum Op { kOpS8 = 0, kOpBF16 = 1 };

constexpr int kWG = 128;  // threads of a warpgroup
constexpr int kMaxSmem = 232448;
constexpr int kAlign = 1024;  // the 128B swizzle's period

struct Params {
  const void* x;          // [n, h, w, ci] s8, bf16 or f32
  const void* w;          // [taps, co, ci] s8, or [co, ci] bf16
  // the epilogue's [co] f32 rows: b/dq, mul*dq, add and 1/s_next (or
  // null: the scalar inv_next) for s8; bias, mul and add for bf16
  const float* epi_b;
  const float* epi_m;
  const float* epi_a;
  const float* epi_inv;
  const int8_t* res_in;   // [n, h, w, ci] s8 or null (1x1, bf16 x)
  const int8_t* res_out;  // [n, oh, ow, co] s8 or null (3x3)
  int8_t* out_s8;         // [n, oh, ow, co] or null
  void* out_f;            // [n, oh, ow, co] bf16 or f32, or null
  int out_f_bf16;
  int n, h, w_, ci, co, ksize;
  int oh, ow, stride, pad_t, pad_l;  // the output's size; stride 1 or 2
  float inv_in, inv_next, res_scale, alpha;
  int cast_bf16;
  int bm, bk, th, tw, stages;  // the tile plan; BN is the template's
  int tiles_h, tiles_w;        // 3x3: rectangles down and across the output
  int kbytes;                  // bytes of one pixel's ci operands
  int kchunks;                 // BK-byte steps over them
  int mtiles, tiles;           // pixel tiles; output tiles (x Co / BN)
};

// Output tile `t` (pixel tile fastest): channels n0.., and pixels m0..
// (1x1) or the TH x TW rectangle of the output image at (img, oh0, ow0)
// (3x3).
struct Tile {
  int n0, m0, img, oh0, ow0;
};

template <int BN>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile tl{};
  const int mt = t % p.mtiles;
  tl.n0 = (t / p.mtiles) * BN;
  if (p.ksize == 1) {
    tl.m0 = mt * p.bm;
  } else {
    const int per = p.tiles_h * p.tiles_w;
    tl.img = mt / per;
    const int r = mt - tl.img * per;
    tl.oh0 = (r / p.tiles_w) * p.th;
    tl.ow0 = (r % p.tiles_w) * p.tw;
  }
  return tl;
}

// Producer warpgroups of a block: one TMA thread's, or the converting
// producer's, which takes what BM / 64 consumer warpgroups leave of three
__host__ __device__ __forceinline__ int producer_wgs(bool tma, int bm) {
  return tma ? 1 : 3 - bm / 64;
}

// --- device helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// barrier `id` (1, 2) of one consumer warpgroup's 128 threads
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kWG) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile whose rows are `bk` bytes,
// swizzled over bk bytes (layout 1 = 128B, 2 = 64B), 8-row groups 8*bk
// bytes apart; `addr` may step by 32 bytes of K inside a row
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int bk) {
  const uint64_t layout = bk == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) | (layout << 62);
}

// where TMA's swizzle puts byte offset `o` of a tile with bk-byte rows:
// the 16-byte chunk index (bits 4..) XOR the row group bits (7..)
__device__ __forceinline__ uint32_t swizzle(uint32_t o, int bk) {
  const uint32_t mask = bk == 128 ? 7u : 3u;
  return o ^ (((o >> 7) & mask) << 4);
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The accumulator operands of an m64nBN wgmma: the strings %0 .. and the
// BN/2 registers d[0] ..
#define CQ_ACC32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15"
#define CQ_OUT32 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
  "+r"(d[15])
#define CQ_ACC64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define CQ_OUT64 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31])
#define CQ_ACC128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"
#define CQ_OUT128 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), \
  "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), \
  "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), \
  "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
  "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define CQ_ACC256 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define CQ_OUT256 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), \
  "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), \
  "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), \
  "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), \
  "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
  "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), \
  "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), \
  "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), \
  "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), \
  "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), \
  "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), \
  "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), \
  "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
  "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), \
  "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
  "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), \
  "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), \
  "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), \
  "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), \
  "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), \
  "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
  "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), \
  "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

// d[BN/2] += A (64 rows x 32 bytes of K) * B (BN rows x 32 bytes)^T, both
// K-major in shared memory (descriptors a, b): s8 x s8 -> s32 (k32) or
// bf16 x bf16 -> f32 (k16, the f32 sums' bits in d)
template <int BN, int OP>
struct Mma;

#define CQ_MMA(BN, IA, IB, IP)                                              \
  template <>                                                               \
  struct Mma<BN, kOpS8> {                                                   \
    __device__ __forceinline__ static void run(uint32_t (&d)[BN / 2],       \
                                               uint64_t a, uint64_t b) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IP ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #BN                  \
                   "k32.s32.s8.s8 {" CQ_ACC##BN "}, " IA ", " IB ", p;\n}\n" \
                   : CQ_OUT##BN                                             \
                   : "l"(a), "l"(b), "r"(1));                               \
    }                                                                       \
  };                                                                        \
  template <>                                                               \
  struct Mma<BN, kOpBF16> {                                                 \
    __device__ __forceinline__ static void run(uint32_t (&d)[BN / 2],       \
                                               uint64_t a, uint64_t b) {    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IP ", 0;\n"          \
                   "wgmma.mma_async.sync.aligned.m64n" #BN                  \
                   "k16.f32.bf16.bf16 {" CQ_ACC##BN "}, " IA ", " IB        \
                   ", p, 1, 1, 0, 0;\n}\n"                                   \
                   : CQ_OUT##BN                                             \
                   : "l"(a), "l"(b), "r"(1));                               \
    }                                                                       \
  };

CQ_MMA(32, "%16", "%17", "%18")
CQ_MMA(64, "%32", "%33", "%34")
CQ_MMA(128, "%64", "%65", "%66")
CQ_MMA(256, "%128", "%129", "%130")

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

// quantize(v, inv) as the low byte of a float's bits, on the FMA pipe
// alone (no quarter-rate float-to-int conversion): clamping before the
// rounding gives the same code (the bounds are integers; NaN clamps to
// -127 as fmaxf does there), and adding 1.5 * 2^23 rounds to the nearest
// integer, half to even, into the low bits of the mantissa, where the
// code sits as a two's-complement byte (2^22 is 0 mod 256).
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}

// bf16_round on the integer pipe (no conversion instruction): the
// nearest bf16, ties to even, in the float's bits (PyTorch's own
// round-to-nearest-even); infinities, and overflow to them, as the
// conversion gives them, and a NaN stays a NaN (quantize_bits maps every
// NaN to -127, as quantize does)
__device__ __forceinline__ float bf16_round_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t r = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return v != v ? v : __uint_as_float(r);
}

// the low bytes of a, b, c, d as one word (a lowest)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The raw words of 16 consecutive channels of a bf16 or f32 x (and of
// the 1x1's s8 residual input), loaded before any is converted so that a
// thread's loads are in flight together.
template <int KIND>
struct Raw {
  uint4 v[KIND == kBF16 ? 2 : 4];
  uint4 res;
};

template <int KIND>
__device__ __forceinline__ void load_raw(const Params& p, size_t off,
                                         Raw<KIND>& r) {
  const uint4* src =
      KIND == kBF16
          ? reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(p.x) + off)
          : reinterpret_cast<const uint4*>(static_cast<const float*>(p.x) +
                                           off);
#pragma unroll
  for (int j = 0; j < (KIND == kBF16 ? 2 : 4); ++j) r.v[j] = src[j];
  if (KIND == kBF16 && p.res_in != nullptr)
    r.res = *reinterpret_cast<const uint4*>(p.res_in + off);
}

// the s8 codes of those 16 channels: conv_block_q.cuh's load_a16's codes
// (the requantized residual first, for a bf16 x; quantize_bits for the
// quantize)
template <int KIND>
__device__ __forceinline__ uint4 quantize_raw(const Params& p,
                                              const Raw<KIND>& r) {
  float f[16];
  if constexpr (KIND == kBF16) {
    // a bf16 is the top half of the f32 with the same value
    const uint32_t words[8] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w,
                               r.v[1].x, r.v[1].y, r.v[1].z, r.v[1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
    if (p.res_in != nullptr) {
      Vec16 rv;
      rv.u = r.res;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float rq = bf16_round(
            __fmul_rn(static_cast<float>(rv.s8[i]), p.res_scale));
        f[i] = bf16_round(__fadd_rn(rq, f[i]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * j] = __uint_as_float(r.v[j].x);
      f[4 * j + 1] = __uint_as_float(r.v[j].y);
      f[4 * j + 2] = __uint_as_float(r.v[j].z);
      f[4 * j + 3] = __uint_as_float(r.v[j].w);
    }
  }
  uint32_t q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = quantize_bits(f[i], p.inv_in);
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]),
                    pack4(q[12], q[13], q[14], q[15]));
}

// four consecutive floats of an epilogue row
__device__ __forceinline__ void row4(const float* row, int c, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(row + c);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

// the float output's four channels at element offset `o`, bf16 or f32
__device__ __forceinline__ void store_f4(const Params& p, const float (&y)[4],
                                         size_t o) {
  if (p.out_f_bf16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out_f) + o) = v;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out_f) + o) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

// The epilogue of four consecutive channels lc..lc+3 of a tile (element
// offset `o` of the output) from their s32 sums, conv_block_q.cuh's op
// for op; `e` holds the tile's epilogue rows in shared memory, BN floats
// each (b/dq, mul*dq, add, and 1/s_next with epi_inv).
template <int BN>
__device__ __forceinline__ void epilogue4(const Params& p, const float* e,
                                          const uint32_t (&acc)[4], size_t o,
                                          int lc) {
  float b[4], m[4], a[4], iv[4];
  row4(e, lc, b);
  row4(e + BN, lc, m);
  row4(e + 2 * BN, lc, a);
  if (p.epi_inv != nullptr)
    row4(e + 3 * BN, lc, iv);
  else
    iv[0] = iv[1] = iv[2] = iv[3] = p.inv_next;
  union {
    uint32_t u;
    int8_t s8[4];
  } res, q;
  if (p.res_out != nullptr)
    res.u = *reinterpret_cast<const uint32_t*>(p.res_out + o);
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = __fadd_rn(__int2float_rn(static_cast<int>(acc[i])), b[i]);
    v = v >= 0.0f ? v : __fmul_rn(p.alpha, v);
    v = __fadd_rn(__fmul_rn(v, m[i]), a[i]);
    if (p.cast_bf16) v = bf16_round(v);
    if (p.res_out != nullptr) {
      float r = __fmul_rn(static_cast<float>(res.s8[i]), p.res_scale);
      if (p.cast_bf16) r = bf16_round(r);
      v = __fadd_rn(r, v);
      if (p.cast_bf16) v = bf16_round(v);
    }
    y[i] = v;
    q.s8[i] = quantize(v, iv[i]);
  }
  if (p.out_f != nullptr) store_f4(p, y, o);
  if (p.out_s8 != nullptr) *reinterpret_cast<uint32_t*>(p.out_s8 + o) = q.u;
}

// The s8 stride-2 path's epilogue of the same four channels (an s8
// output alone, no residual: the exit's): epilogue4's codes, returned
// packed (channel lc lowest) for the caller to stage. The bf16 cast and
// the quantize run on the integer and FMA pipes (bf16_round_bits,
// quantize_bits; the same codes) rather than the conversion pipe, which
// the flagship exit's epilogue waited on (PERF.md).
template <int BN>
__device__ __forceinline__ uint32_t codes4(const Params& p, const float* e,
                                           const uint32_t (&acc)[4],
                                           int lc) {
  float b[4], m[4], a[4], iv[4];
  row4(e, lc, b);
  row4(e + BN, lc, m);
  row4(e + 2 * BN, lc, a);
  if (p.epi_inv != nullptr)
    row4(e + 3 * BN, lc, iv);
  else
    iv[0] = iv[1] = iv[2] = iv[3] = p.inv_next;
  uint32_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = __fadd_rn(__int2float_rn(static_cast<int>(acc[i])), b[i]);
    v = v >= 0.0f ? v : __fmul_rn(p.alpha, v);
    v = __fadd_rn(__fmul_rn(v, m[i]), a[i]);
    if (p.cast_bf16) v = bf16_round_bits(v);
    q[i] = quantize_bits(v, iv[i]);
  }
  return pack4(q[0], q[1], q[2], q[3]);
}

// The bf16 1x1's epilogue of the same four channels from their f32 sums
// (the bits in acc), conv_block_kernel.py's: leaky(acc + bias) * mul + add
template <int BN>
__device__ __forceinline__ void epilogue4_f(const Params& p, const float* e,
                                            const uint32_t (&acc)[4],
                                            size_t o, int lc) {
  float b[4], m[4], a[4], y[4];
  row4(e, lc, b);
  row4(e + BN, lc, m);
  row4(e + 2 * BN, lc, a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = __fadd_rn(__uint_as_float(acc[i]), b[i]);
    v = v >= 0.0f ? v : __fmul_rn(p.alpha, v);
    y[i] = __fadd_rn(__fmul_rn(v, m[i]), a[i]);
  }
  store_f4(p, y, o);
}

// --- the kernel -------------------------------------------------------------

// BN output channels a tile, x of kind KIND, operands OP (a bf16 x is
// quantized by the producer for s8 operands, copied by TMA for bf16 ones);
// RES: the s8 stride-2 path (the exit; launch's rule), the s8 output
// staged in shared memory
template <int BN, int KIND, int OP, bool RES>
__global__ void __launch_bounds__(3 * kWG, 1)
conv_gemm_q_kernel(const __grid_constant__ Params p,
                   const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b) {
  // A by TMA, or through the converting producer
  constexpr bool kTmaA = OP == kOpBF16 || KIND == kS8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const int stages = p.stages;
  const uint32_t a_bytes = p.bm * p.bk;
  const uint32_t b_bytes = BN * p.bk;
  const uint32_t stage_bytes = a_bytes + b_bytes;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)
  const uint32_t bars = base + stages * stage_bytes;
  const int nwg = p.bm / 64;
  const int nprod = producer_wgs(kTmaA, p.bm);
  const int total = p.ksize * p.ksize * p.kchunks;  // K steps a tile
  const int m_total = p.n * p.oh * p.ow;  // output pixels

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // TMA: one arrival with the stage's bytes; converting: one for each
      // producer warp plus the weights' arrival with their bytes
      mbar_init(bars + 8 * s, kTmaA ? 1 : 4 + 1);
      // each consumer warp releases the stage once its products are done
      mbar_init(bars + 8 * (stages + s), 4 * nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The block walks tiles blockIdx.x, + gridDim.x, ...; `it` counts K
  // steps over all of them, so the ring's stage and phase run on across
  // tiles and the producer loads the next tile during the epilogue.
  if (threadIdx.x >= nwg * kWG) {
    // ---- producer warpgroup: keeps the ring filled ----
    const int pt = threadIdx.x - nwg * kWG;
    if constexpr (kTmaA) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (pt != 0) return;
      int it = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_of<BN>(p, t);
        for (int kit = 0; kit < total; ++kit, ++it) {
          const int s = it % stages;
          mbar_wait(bars + 8 * (stages + s), ((it / stages) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = base + s * stage_bytes;
          const int tap = kit / p.kchunks;
          const int k0 = (kit - tap * p.kchunks) * p.bk;
          mbar_arrive_tx(full, stage_bytes);
          // the box lands BM x BK bytes at either stride: stage_bytes
          if (p.ksize == 1)
            tma_2d(sa, &map_a, full, k0, tl.m0);
          else
            tma_4d(sa, &map_a, full, k0,
                   tl.ow0 * p.stride - p.pad_l + tap % 3,
                   tl.oh0 * p.stride - p.pad_t + tap / 3, tl.img);
          tma_3d(sa + a_bytes, &map_b, full, k0, tl.n0, tap);
        }
      }
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::: "memory");
      constexpr int kGroup = KIND == kBF16 ? 4 : 2;
      // producer warpgroup q converts the K steps it = q (mod nprod), so
      // nprod steps' loads are in flight together; its thread lpt the
      // chunks lpt + i * kWG of each: row r0 + i * rstep of the tile,
      // 16-byte column c, the same each step
      const int q = pt / kWG;
      const int lpt = pt % kWG;
      const int cpr = p.bk / 16;  // 16-byte chunks a row
      const int cpt = p.bm * cpr / kWG;  // chunks a thread a step: 2..8
      const int c = lpt % cpr;
      const int r0 = lpt / cpr;
      const int rstep = kWG / cpr;
      int it = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const Tile tl = tile_of<BN>(p, t);
        // each chunk row's pixel, once a tile: its flat index (1x1, in
        // ph), or the input position of its tap (0, 0) (3x3)
        int ph[8], pw[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i * rstep;
          ph[i] = p.ksize == 1 ? tl.m0 + r
                               : (tl.oh0 + r / p.tw) * p.stride - p.pad_t;
          pw[i] = (tl.ow0 + r % p.tw) * p.stride - p.pad_l;
        }
        for (int kit = 0; kit < total; ++kit, ++it) {
          if (it % nprod != q) continue;
          const int s = it % stages;
          mbar_wait(bars + 8 * (stages + s), ((it / stages) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = base + s * stage_bytes;
          const int tap = kit / p.kchunks;
          const int k0 = (kit - tap * p.kchunks) * p.bk;
          if (lpt == 0) {
            mbar_arrive_tx(full, b_bytes);
            tma_3d(sa + a_bytes, &map_b, full, k0, tl.n0, tap);
          }
          const int u = tap / 3;
          const int v = tap % 3;
          const int kc = k0 + 16 * c;
          uint8_t* const tile = base_ptr + s * stage_bytes;
          // kGroup chunks at a time: all their loads first
#pragma unroll
          for (int i0 = 0; i0 < 8; i0 += kGroup) {
            if (i0 >= cpt) break;
            Raw<KIND> raw[kGroup];
            bool ok[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const int i = i0 + g;
              size_t off;
              if (p.ksize == 1) {
                ok[g] = kc < p.ci && ph[i] < m_total;
                off = static_cast<size_t>(ph[i]) * p.ci + kc;
              } else {
                const int ih = ph[i] + u;
                const int iw = pw[i] + v;
                ok[g] = kc < p.ci && ih >= 0 && ih < p.h && iw >= 0 &&
                        iw < p.w_;
                off = (static_cast<size_t>(tl.img * p.h + ih) * p.w_ + iw) *
                          p.ci + kc;
              }
              ok[g] = ok[g] && i < cpt;
              if (ok[g]) load_raw<KIND>(p, off, raw[g]);
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const int i = i0 + g;
              if (i >= cpt) break;
              const uint4 val = ok[g] ? quantize_raw<KIND>(p, raw[g])
                                      : make_uint4(0, 0, 0, 0);
              const int r = r0 + i * rstep;
              *reinterpret_cast<uint4*>(tile + swizzle(r * p.bk + 16 * c,
                                                       p.bk)) = val;
            }
          }
          // the generic-proxy stores become visible to wgmma's reads; the
          // warp's lanes are done before its one arrival
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (pt % 32 == 0) mbar_arrive(full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: products and epilogue ----
    // 384 threads start at 168 registers; the producer warpgroups give up
    // what the consumers take (the TMA one more than the converting one;
    // two converting ones leave a single consumer as much)
    if (kTmaA || nwg == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n" ::: "memory");
    const int g = threadIdx.x / kWG;
    // accumulator layout: d[4j + e] of lane l in warp w is pixel row
    // 16 w + l/4 (+8 for e >= 2), channel 8 j + 2 (l % 4) + (e & 1).
    // Lanes l and l^1 swap halves, so each holds channels 8 j + 4 (q/2)
    // .. +3 of one row: the even lane row 16 w + l/4, the odd one row +8.
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % kWG) / 32;
    const int q = lane & 3;
    const bool odd = q & 1;
    const int row = g * 64 + warp * 16 + (lane >> 2) + (odd ? 8 : 0);
    // this warpgroup's copy of a tile's epilogue rows, after the ring's
    // barriers: four rows of BN floats; then, on the s8 stride-2 path
    // (RES), its 64 rows of s8 codes (padded to kStageRow bytes),
    // written out in whole 16-byte pieces once the warpgroup has made
    // them (stored from the registers, each warp store would write 8
    // bytes of each of 16 pixels)
    float* const e_all =
        reinterpret_cast<float*>(base_ptr + stages * (stage_bytes + 16));
    float* const e = e_all + g * 4 * BN;
    constexpr int kStageRow = BN + 16;
    uint8_t* const staged =
        reinterpret_cast<uint8_t*>(e_all + nwg * 4 * BN) + g * 64 * kStageRow;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_of<BN>(p, t);
      uint32_t acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kit = 0; kit < total; ++kit, ++it) {
        const int s = it % stages;
        mbar_wait(bars + 8 * s, (it / stages) & 1);
        const uint32_t sa = base + s * stage_bytes + g * 64 * p.bk;
        const uint32_t sb = base + s * stage_bytes + a_bytes;
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kk = 0; kk < p.bk; kk += 32)
          Mma<BN, OP>::run(acc, smem_desc(sa + kk, p.bk),
                           smem_desc(sb + kk, p.bk));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_regs(acc);
        // the previous step's products are done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        if (kit > 0 && lane == 0)
          mbar_arrive(bars + 8 * (stages + (it - 1) % stages));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars + 8 * (stages + (it - 1) % stages));

      // the tile's epilogue rows into shared memory, once a tile (read
      // from device memory, each 4-channel epilogue below would wait for
      // its own loads). The first barrier: the whole warpgroup is done
      // with the last tile's rows.
      named_barrier(1 + g);
      for (int i = threadIdx.x % kWG; i < BN; i += kWG) {
        const int gc = tl.n0 + i;
        if (gc < p.co) {
          e[i] = p.epi_b[gc];
          e[BN + i] = p.epi_m[gc];
          e[2 * BN + i] = p.epi_a[gc];
          if (p.epi_inv != nullptr) e[3 * BN + i] = p.epi_inv[gc];
        }
      }
      named_barrier(1 + g);

      if constexpr (RES) {
        // every code of the tile first, then the stores: a store between
        // them would keep the next channels' epilogue rows from loading
        // early (the compiler cannot tell them apart)
        uint32_t codes[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t s0 = odd ? acc[4 * j] : acc[4 * j + 2];
          const uint32_t s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
          const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const uint32_t v[4] = {odd ? r0 : acc[4 * j],
                                 odd ? r1 : acc[4 * j + 1],
                                 odd ? acc[4 * j + 2] : r0,
                                 odd ? acc[4 * j + 3] : r1};
          codes[j] = codes4<BN>(p, e, v, 8 * j + 4 * (q >> 1));
        }
        uint8_t* const mine =
            staged + (row - g * 64) * kStageRow + 4 * (q >> 1);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<uint32_t*>(mine + 8 * j) = codes[j];
        // the staged rows out, 16 bytes a thread: a warp writes four
        // whole pixels' BN channels at a time
        named_barrier(1 + g);
        constexpr int kChunks = BN / 16;
        for (int c = threadIdx.x % kWG; c < 64 * kChunks; c += kWG) {
          const int lr = c / kChunks;
          const int col = (c - lr * kChunks) * 16;
          const int r = g * 64 + lr;
          const int oh = tl.oh0 + r / p.tw;
          const int ow = tl.ow0 + r % p.tw;
          if (oh < p.oh && ow < p.ow && tl.n0 + col < p.co)
            *reinterpret_cast<uint4*>(
                p.out_s8 +
                (static_cast<size_t>(tl.img * p.oh + oh) * p.ow + ow) * p.co +
                tl.n0 + col) =
                *reinterpret_cast<const uint4*>(staged + lr * kStageRow + col);
        }
        continue;
      }
      bool row_ok;
      size_t orow;
      if (p.ksize == 1) {
        const int pix = tl.m0 + row;
        row_ok = pix < m_total;
        orow = static_cast<size_t>(pix) * p.co;
      } else {
        const int oh = tl.oh0 + row / p.tw;
        const int ow = tl.ow0 + row % p.tw;
        row_ok = oh < p.oh && ow < p.ow;
        orow = (static_cast<size_t>(tl.img * p.oh + oh) * p.ow + ow) * p.co;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t s0 = odd ? acc[4 * j] : acc[4 * j + 2];
        const uint32_t s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const uint32_t v[4] = {odd ? r0 : acc[4 * j], odd ? r1 : acc[4 * j + 1],
                               odd ? acc[4 * j + 2] : r0,
                               odd ? acc[4 * j + 3] : r1};
        const int lc = 8 * j + 4 * (q >> 1);
        const int gc = tl.n0 + lc;
        if (row_ok && gc < p.co) {
          if constexpr (OP == kOpS8)
            epilogue4<BN>(p, e, v, orow + gc, lc);
          else
            epilogue4_f<BN>(p, e, v, orow + gc, lc);
        }
      }
    }
  }
}

// --- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr cuuint32_t kOnes[5] = {1, 1, 1, 1, 1};

// a tiled map over bytes (s8 elements, or each bf16 as two), dims
// innermost first, byte strides of dims 1.., the traversal box and its
// element strides (a stride s reads every s-th element of the box's
// extent, landing box / s of them), the 128B or 64B swizzle matching its
// bk-byte rows; what falls outside the tensor reads as zero
inline bool encode(CUtensorMap* map, const void* ptr, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides,
                   const cuuint32_t* box, int bk,
                   const cuuint32_t* estrides = kOnes) {
  const EncodeTiled fn = encode_fn();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr),
            dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// alignment slack, the ring and its barriers, and each consumer
// warpgroup's four epilogue rows of BN floats (and, with `staged`, its 64
// staged rows of BN + 16 bytes)
inline int smem_bytes(int bm, int bn, int bk, int stages,
                      bool staged = false) {
  return kAlign + stages * ((bm + bn) * bk + 16) + bm / 64 * 16 * bn +
         (staged ? bm * (bn + 16) : 0);
}

template <int BN, int KIND, int OP, bool RES = false>
int run(const Params& p, const CUtensorMap& a, const CUtensorMap& b,
        dim3 grid, int smem, cudaStream_t stream) {
  static int smem_set = 0;  // this library's kernel's dynamic smem limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_gemm_q_kernel<BN, KIND, OP, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  constexpr bool tma = OP == kOpBF16 || KIND == kS8;
  conv_gemm_q_kernel<BN, KIND, OP, RES>
      <<<grid, (p.bm / 64 + producer_wgs(tma, p.bm)) * kWG, smem, stream>>>(
          p, a, b);
  return static_cast<int>(cudaGetLastError());
}

// s8 operands take an s8, bf16 or f32 x (`res`: the s8 stride-2 path);
// bf16 operands a bf16 x
template <int BN, int OP>
int run_kind(const Params& p, int x_kind, bool res, const CUtensorMap& a,
             const CUtensorMap& b, dim3 grid, int smem, cudaStream_t stream) {
  if constexpr (OP == kOpBF16) {
    return run<BN, kBF16, kOpBF16>(p, a, b, grid, smem, stream);
  } else {
    switch (x_kind) {
      case kS8:
#ifdef CONVQ90_S8_STRIDE2
        if (res)
          return run<BN, kS8, kOpS8, true>(p, a, b, grid, smem, stream);
#endif
        return run<BN, kS8, kOpS8>(p, a, b, grid, smem, stream);
      case kBF16:
        return run<BN, kBF16, kOpS8>(p, a, b, grid, smem, stream);
      case kF32:
        return run<BN, kF32, kOpS8>(p, a, b, grid, smem, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// Check the plan, encode the maps and launch on `stream`; returns a
// cudaError_t code (0 on success). OP's operands: s8 (a 1x1 or 3x3 on
// an s8, bf16 or f32 x, or a 3x3 stride 2 on any of them) or bf16 (a 1x1
// on a bf16 x).
template <int OP>
int launch(Params p, int x_kind, int bn, cudaStream_t stream) {
  const long long m = static_cast<long long>(p.n) * p.oh * p.ow;
  if (m == 0 || p.co == 0) return 0;
  // stride 2: a 3x3 with s8 operands, the output covering the input at
  // the stride; on an s8 x (TMA) the 2TH x 2TW traversal box within
  // TMA's 256 elements a dimension
  const bool strided =
      p.stride == 1
          ? p.oh == p.h && p.ow == p.w_
          : p.stride == 2 && p.ksize == 3 && OP == kOpS8 &&
                p.oh == (p.h + 1) / 2 && p.ow == (p.w_ + 1) / 2 &&
                (x_kind != kS8 || (2 * p.th <= 256 && 2 * p.tw <= 256));
  const bool pads = p.pad_t >= 0 && p.pad_l >= 0 && p.pad_t < p.ksize &&
                    p.pad_l < p.ksize;
  const int esize = OP == kOpS8 ? 1 : 2;
  // the s8 stride-2 path (RES; built into the libraries that define
  // CONVQ90_S8_STRIDE2, the exit's): an s8 x at stride 2 with an s8
  // output alone, when the staged rows fit beside the ring
  bool res = false;
#ifdef CONVQ90_S8_STRIDE2
  res = OP == kOpS8 && x_kind == kS8 && p.stride == 2 &&
        p.res_out == nullptr && p.out_f == nullptr && p.out_s8 != nullptr &&
        smem_bytes(p.bm, bn, p.bk, p.stages, true) <= kMaxSmem;
#endif
  const int smem = smem_bytes(p.bm, bn, p.bk, p.stages, res);
  const bool rect = p.ksize == 1 ? (p.th == 1 && p.tw == p.bm)
                                 : (p.th * p.tw == p.bm && p.tw <= 256);
  // s8: channels in 16s (TMA rows and the producer's 16-channel chunks);
  // bf16: a 1x1 on a bf16 x, rows of whole 16 bytes, channels in 8s
  const bool chans = OP == kOpS8
                         ? p.ci % 16 == 0 && p.co % 16 == 0
                         : p.ksize == 1 && x_kind == kBF16 && p.ci % 8 == 0 &&
                               p.co % 8 == 0;
  if (!chans || !strided || !pads || m > 0x7fffffffLL ||
      !(p.ksize == 1 || p.ksize == 3) ||
      !(p.bm == 64 || p.bm == 128) ||
      !(bn == 32 || bn == 64 || bn == 128 || bn == 256) ||
      !(p.bk == 64 || p.bk == 128) || !rect || p.th < 1 || p.tw < 1 ||
      p.stages < 2 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  p.kbytes = p.ci * esize;
  p.kchunks = (p.kbytes + p.bk - 1) / p.bk;
  long long mtiles;
  if (p.ksize == 1) {
    mtiles = (m + p.bm - 1) / p.bm;
  } else {
    p.tiles_h = (p.oh + p.th - 1) / p.th;
    p.tiles_w = (p.ow + p.tw - 1) / p.tw;
    mtiles = static_cast<long long>(p.n) * p.tiles_h * p.tiles_w;
  }
  const long long tiles = mtiles * ((p.co + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.mtiles = static_cast<int>(mtiles);
  p.tiles = static_cast<int>(tiles);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int taps = p.ksize * p.ksize;
  const cuuint64_t kb = static_cast<cuuint64_t>(p.kbytes);
  CUtensorMap map_a{}, map_b{};
  {
    const cuuint64_t dims[3] = {kb, static_cast<cuuint64_t>(p.co),
                                static_cast<cuuint64_t>(taps)};
    const cuuint64_t strides[2] = {kb, static_cast<cuuint64_t>(p.co) * kb};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(p.bk),
                               static_cast<cuuint32_t>(bn), 1};
    if (!encode(&map_b, p.w, 3, dims, strides, box, p.bk))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (OP == kOpBF16 || x_kind == kS8) {
    bool ok;
    if (p.ksize == 1) {
      const cuuint64_t dims[2] = {kb, static_cast<cuuint64_t>(m)};
      const cuuint64_t strides[1] = {kb};
      const cuuint32_t box[2] = {static_cast<cuuint32_t>(p.bk),
                                 static_cast<cuuint32_t>(p.bm)};
      ok = encode(&map_a, p.x, 2, dims, strides, box, p.bk);
    } else {
      const cuuint64_t dims[4] = {
          kb, static_cast<cuuint64_t>(p.w_), static_cast<cuuint64_t>(p.h),
          static_cast<cuuint64_t>(p.n)};
      const cuuint64_t strides[3] = {
          kb, static_cast<cuuint64_t>(p.w_) * kb,
          static_cast<cuuint64_t>(p.h) * p.w_ * kb};
      // stride s: every s-th pixel of an s*TH x s*TW box, TH x TW landed
      const cuuint32_t s = static_cast<cuuint32_t>(p.stride);
      const cuuint32_t box[4] = {static_cast<cuuint32_t>(p.bk),
                                 s * static_cast<cuuint32_t>(p.tw),
                                 s * static_cast<cuuint32_t>(p.th), 1};
      const cuuint32_t estrides[4] = {1, s, s, 1};
      ok = encode(&map_a, p.x, 4, dims, strides, box, p.bk, estrides);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  // persistent: one block an SM at most, each walking its tiles
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  switch (bn) {
    case 32:
      return run_kind<32, OP>(p, x_kind, res, map_a, map_b, grid, smem,
                                  stream);
    case 64:
      return run_kind<64, OP>(p, x_kind, res, map_a, map_b, grid, smem,
                                  stream);
    case 128:
      return run_kind<128, OP>(p, x_kind, res, map_a, map_b, grid, smem,
                                  stream);
    default:
      return run_kind<256, OP>(p, x_kind, res, map_a, map_b, grid, smem,
                                  stream);
  }
}

}  // namespace
}  // namespace convq90

// The C entry point of the int8 1x1, 3x3, stride-2 and exit kernels:
// conv_block_q.cuh's CONVQ_ENTRY arguments, then `inv_next_row` and the
// tile plan (bm, bn, bk, th, tw, stages); `check` is the kernel's own
// contract (a cudaErrorInvalidValue when it is broken, as for a plan it
// cannot run).
#define CONVQ90_ENTRY(NAME, CHECK)                                          \
  extern "C" int NAME(                                                      \
      const void* x, int x_kind, const int8_t* w, const float* epi,         \
      const int8_t* res_in, const int8_t* res_out, int8_t* out_s8,          \
      void* out_f, int out_f_bf16, int n, int h, int wd, int ci, int co,    \
      int oh, int ow, int ksize, int stride, int pad_t, int pad_l,          \
      float inv_in, float inv_next, float res_scale, float alpha,           \
      int cast_bf16, int inv_next_row, int bm, int bn, int bk, int th,      \
      int tw, int stages, cudaStream_t stream) {                            \
    if (!(CHECK)) return static_cast<int>(cudaErrorInvalidValue);           \
    convq90::Params p{};                                                    \
    p.x = x;                                                                \
    p.w = w;                                                                \
    p.epi_b = epi;                                                          \
    p.epi_m = epi + co;                                                     \
    p.epi_a = epi + 2 * co;                                                 \
    p.epi_inv = inv_next_row ? epi + 3 * co : nullptr;                      \
    p.res_in = res_in;                                                      \
    p.res_out = res_out;                                                    \
    p.out_s8 = out_s8;                                                      \
    p.out_f = out_f;                                                        \
    p.out_f_bf16 = out_f_bf16;                                              \
    p.n = n;                                                                \
    p.h = h;                                                                \
    p.w_ = wd;                                                              \
    p.ci = ci;                                                              \
    p.co = co;                                                              \
    p.ksize = ksize;                                                        \
    p.oh = oh;                                                              \
    p.ow = ow;                                                              \
    p.stride = stride;                                                      \
    p.pad_t = pad_t;                                                        \
    p.pad_l = pad_l;                                                        \
    p.inv_in = inv_in;                                                      \
    p.inv_next = inv_next;                                                  \
    p.res_scale = res_scale;                                                \
    p.alpha = alpha;                                                        \
    p.cast_bf16 = cast_bf16;                                                \
    p.bm = bm;                                                              \
    p.bk = bk;                                                              \
    p.th = th;                                                              \
    p.tw = tw;                                                              \
    p.stages = stages;                                                      \
    return convq90::launch<convq90::kOpS8>(p, x_kind, bn, stream);          \
  }
