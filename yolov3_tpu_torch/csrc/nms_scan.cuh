// The serial half of the port's greedy NMS kernels for Hopper (sm_90a):
// nms_suppress.cu (boxes) and greedy_suppress.cu (an IoU slab) include it
// and launch nms_scan_kernel after their own mask pass.
//
// The mask: for C problems of K score-sorted slots, a [C, K, words] u64
// array (words = ceil(K / 64)); bit b of mask[c][j][w] says that slot j,
// if kept, suppresses the later slot i = 64 w + b > j. Only the words on
// or above the diagonal (w >= j / 64) are read, and only those of words
// below the highest valid slot's.
//
// The scan: one warp per problem walks the words of slots up to its
// highest valid slot. For word w it ORs, over the lanes, the words w of
// the kept rows before it (the slots they suppress; a warp OR of up to
// 64w loads in parallel), marks the invalid slots as removed too, and
// then decides its 64 slots in order: slot 64 w + b is kept iff bit b is
// clear, and a kept slot ORs in its own row's word w (the later slots of
// the word it suppresses). The rows of the word are loaded before the
// OR, and broadcast by shuffles that do not wait on the decisions, so a
// step of the serial chain is a bit test and an OR in registers. A kept
// word is written to shared memory (words u64, dynamic) for the later
// words' ORs. keep [C, K] u8 out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each library that includes this header has its own
// copy of the kernel.
namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;  // slots a mask word covers
constexpr unsigned kFull = 0xffffffffu;

// One warp per problem; kept[w] in shared memory holds word w's kept bits.
__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint8_t* __restrict__ valid,
                const u64* __restrict__ mask, uint8_t* __restrict__ keep,
                int k, int words) {
  extern __shared__ u64 kept[];
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const uint8_t* v = valid + base;
  const u64* m = mask + base * words;

  int last = 0;
  for (int j = lane; j < k; j += 32)
    if (v[j]) last = j + 1;
  const int bound = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(last)));
  const int nw = (bound + kWord - 1) / kWord;

  for (int w = 0; w < nw; ++w) {
    const int j0 = w * kWord;
    const int lo = j0 + lane, hi = j0 + 32 + lane;
    // the word's own rows (word w of rows j0 .. j0 + 63)
    const u64 d_lo = lo < k ? m[static_cast<size_t>(lo) * words + w] : 0;
    const u64 d_hi = hi < k ? m[static_cast<size_t>(hi) * words + w] : 0;
    // the slots of word w that the kept rows before it suppress
    u64 acc = 0;
#pragma unroll 4
    for (int i = lane; i < j0; i += 32)
      if ((kept[i / kWord] >> (i % kWord)) & 1)
        acc |= m[static_cast<size_t>(i) * words + w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc |= __shfl_xor_sync(kFull, acc, off);
    const unsigned ok_lo = __ballot_sync(kFull, lo < k && v[lo]);
    const unsigned ok_hi = __ballot_sync(kFull, hi < k && v[hi]);
    // removed: suppressed, or not a valid slot (it never suppresses)
    u64 cur = acc | ~((static_cast<u64>(ok_hi) << 32) | ok_lo);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const u64 row = __shfl_sync(kFull, d_lo, b);
      if (!((cur >> b) & 1)) cur |= row;
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const u64 row = __shfl_sync(kFull, d_hi, b);
      if (!((cur >> (32 + b)) & 1)) cur |= row;
    }
    if (lane == 0) kept[w] = ~cur;
    __syncwarp();
  }

  for (int j = lane; j < k; j += 32)
    keep[base + j] =
        j < nw * kWord ? static_cast<uint8_t>((kept[j / kWord] >>
                                               (j % kWord)) & 1)
                       : 0;
}

}  // namespace
