// Greedy NMS suppression for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/nms_kernel.py::suppress_boxes_pallas_t
// (and its row-layout twin suppress_boxes_pallas, which has the same
// contract). For C independent problems, each K score-sorted ltrb boxes
// with a valid mask:
//
//     keep[i] = valid[i] && no kept j < i has IoU(j, i) > threshold
//
// What bounds it: not bytes (C*K*18 bytes in and out, about 1 MB at
// C = 128, K = 512) and not the IoU tests (~2M at C = 16, K = 512, a few
// us of the card's f32 rate), but the recurrence: decision i needs every
// decision before it. The first design (nms_suppress_chain below) ran
// one block per problem and one block-wide OR per candidate, ~0.74 us a
// step at K = 512 on 16 of the 132 SMs.
//
// Design: the function splits into its parallel part and its serial part.
// 1. Mask pass (nms_mask_kernel): every IoU test that the recurrence could
//    need, on the whole card: mask[c][i][w] bit b says IoU(i, j) >
//    threshold for slot j = 64 w + b > i. One block of 64 threads per
//    (problem, 64-row block, 64-column word) on or above the diagonal;
//    thread t owns row i and writes one 64-bit word. Rows of invalid
//    slots are never read as suppressors and are written as 0. The
//    workspace [C, K, ceil(K/64)] u64 is the wrapper's (512 KB at
//    C = 16, K = 512).
// 2. Scan (nms_scan_kernel, nms_scan.cuh, shared with the IoU-slab
//    kernel greedy_suppress.cu): one warp per problem walks the mask
//    words up to its highest valid slot, ORs the words of the kept rows
//    before each word, and decides the word's 64 slots in order with a
//    bit test and an OR in registers a step.
// Two launches a call: the serving call has one device op more than with
// the first design.
//
// Numerics: the IoU is written op for op as ops/nms.py::pairwise_iou,
// with explicitly rounded intrinsics (and -fmad=false), so no multiply and
// add are contracted into an FMA, and with IEEE division; the earlier
// box's operands come first, as in the first design (IEEE min, max and
// add are commutative besides). The result is bit-equal to the plain
// PyTorch version, to the host numpy oracle and to the first design.
// Degenerate boxes give 0/0 = NaN, and NaN > threshold is false on all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_scan.cuh"

namespace {

constexpr int kChainThreads = 128;

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

// IoU(e, x) > thr of an earlier box e and a later box x (area ea, xa)
__device__ __forceinline__ bool overlaps(float el, float et, float er,
                                         float eb, float ea, float xl,
                                         float xt, float xr, float xb,
                                         float xa, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(er, xr), fmaxf(el, xl)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(eb, xb), fmaxf(et, xt)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(ea, xa), inter)) > thr;
}

// Block (c, rb * words + w): rows 64 rb .. of problem c against the
// slots of word w; blocks below the diagonal (w < rb) have nothing to do.
__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float* __restrict__ cand,
                const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                int k, int words, float thr) {
  const int rb = blockIdx.y / words;
  const int w = blockIdx.y - rb * words;
  if (w < rb) return;
  __shared__ float sl[kWord], st[kWord], sr[kWord], sb[kWord], sa[kWord];
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float4* box = reinterpret_cast<const float4*>(cand) + base;
  const int t = threadIdx.x;
  const int j0 = w * kWord;
  if (j0 + t < k) {
    const float4 q = box[j0 + t];
    sl[t] = q.x;
    st[t] = q.y;
    sr[t] = q.z;
    sb[t] = q.w;
    sa[t] = box_area(q);
  }
  __syncthreads();
  const int i = rb * kWord + t;
  if (i >= k) return;
  u64 bits = 0;
  if (valid[base + i]) {
    const float4 q = box[i];
    const float a = box_area(q);
    const int n = min(kWord, k - j0);
    for (int b = max(0, i - j0 + 1); b < n; ++b)
      if (overlaps(q.x, q.y, q.z, q.w, a, sl[b], st[b], sr[b], sb[b], sa[b],
                   thr))
        bits |= 1ull << b;
  }
  mask[(base + i) * words + w] = bits;
}

// The first design, kept for A/B timing (entry nms_suppress_chain): one
// thread block per problem, the boxes in shared memory as l/t/r/b planes
// plus the areas, and each step i one `__syncthreads_or` over "some kept
// j < i that I own has IoU(j, i) > threshold", after which the owner of
// i records valid[i] && !hit. Thread `tid` owns slots tid, tid + T, ...,
// the only thread that reads or writes their keep flags.
__global__ void __launch_bounds__(kChainThreads)
nms_suppress_chain_kernel(const float* __restrict__ cand,
                          const uint8_t* __restrict__ valid,
                          uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ float smem[];
  float* l = smem;
  float* t = l + k;
  float* r = t + k;
  float* b = r + k;
  float* area = b + k;
  uint8_t* kept = reinterpret_cast<uint8_t*>(area + k);
  __shared__ int s_bound;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float4* box = reinterpret_cast<const float4*>(cand) + base;
  const uint8_t* v = valid + base;

  if (tid == 0) s_bound = 0;
  __syncthreads();
  int my_bound = 0;
  for (int j = tid; j < k; j += kChainThreads) {
    const float4 q = box[j];
    l[j] = q.x;
    t[j] = q.y;
    r[j] = q.z;
    b[j] = q.w;
    area[j] = box_area(q);
    kept[j] = 0;
    if (v[j]) my_bound = j + 1;
  }
  atomicMax(&s_bound, my_bound);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    const float li = l[i], ti = t[i], ri = r[i], bi = b[i], ai = area[i];
    int hit = 0;
    for (int j = tid; j < i; j += kChainThreads)
      if (kept[j])
        hit |= overlaps(l[j], t[j], r[j], b[j], area[j], li, ti, ri, bi, ai,
                        thr);
    hit = __syncthreads_or(hit);
    if (i % kChainThreads == tid) kept[i] = (v[i] && !hit) ? 1 : 0;
  }

  for (int j = tid; j < k; j += kChainThreads) keep[base + j] = kept[j];
}

}  // namespace

// cand [c, k, 4] f32 contiguous, valid [c, k] u8 -> keep [c, k] u8, with
// `mask` a [c, k, ceil(k/64)] u64 workspace. Returns a cudaError_t code
// (0 on success).
extern "C" int nms_suppress(const float* cand, const uint8_t* valid,
                            uint8_t* keep, u64* mask, int c, int k,
                            float thr, cudaStream_t stream) {
  if (c == 0 || k == 0) return 0;
  const int words = (k + kWord - 1) / kWord;
  if (mask == nullptr || words * words > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  nms_mask_kernel<<<dim3(c, words * words), kWord, 0, stream>>>(
      cand, valid, mask, k, words, thr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<c, 32, words * sizeof(u64), stream>>>(valid, mask, keep,
                                                          k, words);
  return static_cast<int>(cudaGetLastError());
}

// The first design's entry, same contract without the workspace.
extern "C" int nms_suppress_chain(const float* cand, const uint8_t* valid,
                                  uint8_t* keep, int c, int k, float thr,
                                  cudaStream_t stream) {
  if (c == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_chain_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_suppress_chain_kernel<<<c, kChainThreads, smem, stream>>>(
      cand, valid, keep, k, thr);
  return static_cast<int>(cudaGetLastError());
}
