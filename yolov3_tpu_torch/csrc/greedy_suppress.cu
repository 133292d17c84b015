// Greedy NMS suppression from a precomputed IoU slab, for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/nms_kernel.py::greedy_suppress_pallas, the
// compatibility entry that takes the IoU matrices instead of the boxes.
// For C independent problems of K score-sorted candidates:
//
//     keep[i] = valid[i] && no kept j < i has iou[i, j] > threshold
//
// reading row i of the slab, as the TPU kernel does (for a slab from
// pairwise_iou the rows and columns are the same numbers).
//
// What bounds it: the slab's bytes, of which the function needs only
// iou[i, j] for each valid i and kept j < i (the lower triangle of the
// valid rows: 67 MB of the 134 MB slab at C = 128, K = 512 saturated,
// 0.020 ms at 3.35 TB/s); and the recurrence, decision i needing every
// decision before it. The first design (greedy_suppress_chain below) ran
// one block per problem and one block-wide OR per candidate, ~1.2 us a
// step at C = 128, K = 512.
//
// Design: nms_suppress.cu's split into a parallel and a serial part.
// 1. Mask pass (greedy_mask_kernel), on the whole card: one block of 128
//    threads per (problem, 64 x 64 tile on or below the slab's diagonal)
//    reads the tile's valid rows i, coalesced, into shared memory, and
//    writes its transpose as bits: bit i % 64 of mask[c][j][i / 64] is
//    set iff valid[i], j < i and iou[c, i, j] > threshold (a NaN, or a
//    value equal to the threshold, sets none), one u64 per column j. A
//    warp's ballot over 32 rows of one column makes half a word. Rows of
//    invalid candidates are never read. The workspace [C, K, ceil(K/64)]
//    u64 is the wrapper's (4 MB at C = 128, K = 512).
// 2. Scan: nms_scan.cuh's nms_scan_kernel, the box kernel's, unchanged.
// Two launches a call. There is no arithmetic, only comparisons, so the
// keep masks are bit-equal to the plain version and to the first design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_scan.cuh"

namespace {

constexpr int kMaskThreads = 128;
constexpr int kChainThreads = 128;

// Block (c, rb * words + w): slab rows i = 64 w .. (the candidates) and
// columns j = 64 rb .. (the suppressors); tiles above the diagonal (w <
// rb) have nothing to do.
__global__ void __launch_bounds__(kMaskThreads)
greedy_mask_kernel(const float* __restrict__ iou,
                   const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                   int k, int words, float thr) {
  const int rb = blockIdx.y / words;
  const int w = blockIdx.y - rb * words;
  if (w < rb) return;
  // one column more than the tile, so a warp reading one column down its
  // 32 rows hits 32 banks
  __shared__ float tile[kWord][kWord + 1];
  __shared__ uint8_t row_ok[kWord];
  __shared__ unsigned half[2][kWord];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const int i0 = w * kWord, j0 = rb * kWord;
  if (t < kWord) row_ok[t] = i0 + t < k && valid[base + i0 + t];
  __syncthreads();
  // the valid rows, a warp reading 32 consecutive floats of one row
  const int col = t % kWord;
  const bool col_ok = j0 + col < k;
#pragma unroll 8
  for (int r = t / kWord; r < kWord; r += kMaskThreads / kWord)
    if (row_ok[r] && col_ok)
      tile[r][col] = iou[(base + i0 + r) * k + j0 + col];
  __syncthreads();
  // warp q: rows 32 (q & 1) .., columns 32 (q >> 1) ..; lane l holds the
  // bits of column 32 (q >> 1) + l over the warp's rows
  const int lane = t % 32, q = t / 32;
  const int r = 32 * (q & 1) + lane;
  const int c0 = 32 * (q >> 1);
  unsigned bits = 0;
#pragma unroll 4
  for (int cc = 0; cc < 32; ++cc) {
    const int c = c0 + cc;
    const bool hit = row_ok[r] && i0 + r > j0 + c && j0 + c < k &&
                     tile[r][c] > thr;
    const unsigned b = __ballot_sync(kFull, hit);
    if (lane == cc) bits = b;
  }
  half[q & 1][c0 + lane] = bits;
  __syncthreads();
  if (t < kWord && j0 + t < k)
    mask[(base + j0 + t) * words + w] =
        (static_cast<u64>(half[1][t]) << 32) | half[0][t];
}

// The first design, kept for A/B timing (entry greedy_suppress_chain):
// one thread block per problem; thread `tid` owns slots j = tid, tid + T,
// ... and is the only one that writes keep[j], one `__syncthreads_or`
// per step, and the loop stops at the problem's last valid slot + 1
// (nms_kernel.py:280). Step i reads only iou[i, 0..i-1], coalesced.
__global__ void __launch_bounds__(kChainThreads)
greedy_suppress_chain_kernel(const float* __restrict__ iou,
                             const uint8_t* __restrict__ valid,
                             uint8_t* __restrict__ keep, int k, float thr) {
  // the keep flags (not `kept`: nms_scan.cuh's extern array of u64)
  extern __shared__ uint8_t flags[];
  __shared__ int s_bound;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const uint8_t* v = valid + base;

  if (tid == 0) s_bound = 0;
  __syncthreads();
  int my_bound = 0;
  for (int j = tid; j < k; j += kChainThreads) {
    flags[j] = 0;
    if (v[j]) my_bound = j + 1;
  }
  atomicMax(&s_bound, my_bound);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    const float* row = iou + (base + i) * k;
    int hit = 0;
    for (int j = tid; j < i; j += kChainThreads)
      hit |= flags[j] && row[j] > thr;
    hit = __syncthreads_or(hit);
    if (i % kChainThreads == tid) flags[i] = (v[i] && !hit) ? 1 : 0;
  }

  for (int j = tid; j < k; j += kChainThreads) keep[base + j] = flags[j];
}

// Both entries take K <= 255 * 64: the mask grid's words^2 blocks in
// gridDim.y.
bool k_ok(int c, int k) {
  const long long words = (static_cast<long long>(k) + kWord - 1) / kWord;
  return c >= 0 && k >= 0 && words * words <= 65535;
}

}  // namespace

// iou [c, k, k] f32 contiguous, valid [c, k] u8 -> keep [c, k] u8, with
// `mask` a [c, k, ceil(k/64)] u64 workspace. Returns a cudaError_t code
// (0 on success).
extern "C" int greedy_suppress(const float* iou, const uint8_t* valid,
                               uint8_t* keep, u64* mask, int c, int k,
                               float thr, cudaStream_t stream) {
  if (!k_ok(c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0 || k == 0) return 0;
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + kWord - 1) / kWord;
  greedy_mask_kernel<<<dim3(c, words * words), kMaskThreads, 0, stream>>>(
      iou, valid, mask, k, words, thr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<c, 32, words * sizeof(u64), stream>>>(valid, mask, keep,
                                                          k, words);
  return static_cast<int>(cudaGetLastError());
}

// The first design's entry, same contract without the workspace.
extern "C" int greedy_suppress_chain(const float* iou, const uint8_t* valid,
                                     uint8_t* keep, int c, int k, float thr,
                                     cudaStream_t stream) {
  if (!k_ok(c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0 || k == 0) return 0;
  greedy_suppress_chain_kernel<<<c, kChainThreads, k, stream>>>(
      iou, valid, keep, k, thr);
  return static_cast<int>(cudaGetLastError());
}
