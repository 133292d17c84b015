// Greedy NMS suppression from a precomputed IoU slab, for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/nms_kernel.py::greedy_suppress_pallas, the
// compatibility entry that takes the IoU matrices instead of the boxes.
// For C independent problems of K score-sorted candidates:
//
//     keep[i] = valid[i] && no kept j < i has iou[i, j] > threshold
//
// reading row i of the slab, as the TPU kernel does (for a slab from
// pairwise_iou the rows and columns are the same numbers). The recurrence
// is nms_suppress.cu's: one thread block per problem, thread `tid` owns
// slots j = tid, tid + T, ... and is the only one that writes keep[j], one
// `__syncthreads_or` per step, and the loop stops at the problem's last
// valid slot + 1 (nms_kernel.py:280). Step i reads only iou[i, 0..i-1],
// coalesced.
//
// What bounds it: the slab's bytes, C*K*K*4 (134 MB at C = 128, K = 512,
// 0.040 ms at 3.35 TB/s), of which a problem with b valid slots needs only
// the b*(b-1)/2 entries below the diagonal of its first b rows; and the
// latency chain of b block-wide reductions. No arithmetic besides the
// comparisons, so the result is bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
greedy_suppress_kernel(const float* __restrict__ iou,
                       const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ uint8_t kept[];
  __shared__ int s_bound;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const uint8_t* v = valid + base;

  if (tid == 0) s_bound = 0;
  __syncthreads();
  int my_bound = 0;
  for (int j = tid; j < k; j += kThreads) {
    kept[j] = 0;
    if (v[j]) my_bound = j + 1;
  }
  atomicMax(&s_bound, my_bound);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    const float* row = iou + (base + i) * k;
    int hit = 0;
    for (int j = tid; j < i; j += kThreads) hit |= kept[j] && row[j] > thr;
    hit = __syncthreads_or(hit);
    if (i % kThreads == tid) kept[i] = (v[i] && !hit) ? 1 : 0;
  }

  for (int j = tid; j < k; j += kThreads) keep[base + j] = kept[j];
}

}  // namespace

// iou [c, k, k] f32 contiguous, valid [c, k] u8 -> keep [c, k] u8.
// Returns a cudaError_t code (0 on success).
extern "C" int greedy_suppress(const float* iou, const uint8_t* valid,
                               uint8_t* keep, int c, int k, float thr,
                               cudaStream_t stream) {
  if (c == 0 || k == 0) return 0;
  if (c < 0 || k < 0 || k > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  greedy_suppress_kernel<<<c, kThreads, k, stream>>>(iou, valid, keep, k,
                                                     thr);
  return static_cast<int>(cudaGetLastError());
}
