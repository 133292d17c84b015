// Greedy NMS suppression for Hopper (sm_90a).
//
// Replaces yolov3_tpu/ops/pallas/nms_kernel.py::suppress_boxes_pallas_t
// (and its row-layout twin suppress_boxes_pallas, which has the same
// contract). For C independent problems, each K score-sorted ltrb boxes
// with a valid mask:
//
//     keep[i] = valid[i] && no kept j < i has IoU(j, i) > threshold
//
// What bounds it: not bytes (C*K*17 bytes in and out, about 1 MB at
// C = 128, K = 512) but a latency chain of up to K block-wide reductions,
// one per candidate, each of which must finish before the next decision.
//
// Design: one thread block per problem. The block copies its K boxes into
// shared memory as l/t/r/b planes plus the areas (5*K*4 bytes, 10 KB at
// K = 512) and finds its own loop bound, the highest valid slot + 1, so a
// sparse problem stops early. Thread `tid` owns slots j = tid, tid + T, ...
// and is the only thread that reads or writes keep[j], so the keep flags
// need no barrier of their own; each step i is one `__syncthreads_or`
// over "some kept j < i I own has IoU(j, i) > threshold", after which the
// owner of i records valid[i] && !hit. Since keep[j] is still 0 for
// j >= i, the j < i rule follows on its own.
//
// Numerics: the IoU is written op for op as ops/nms.py::pairwise_iou,
// with explicitly rounded intrinsics (and -fmad=false), so no multiply and
// add are contracted into an FMA, and with IEEE division. The result is
// bit-equal to the plain PyTorch version and to the host numpy oracle.
// Degenerate boxes give 0/0 = NaN, and NaN > threshold is false on both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float* __restrict__ cand,
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
  for (int j = tid; j < k; j += kThreads) {
    const float4 q = box[j];
    l[j] = q.x;
    t[j] = q.y;
    r[j] = q.z;
    b[j] = q.w;
    area[j] = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
    kept[j] = 0;
    if (v[j]) my_bound = j + 1;
  }
  atomicMax(&s_bound, my_bound);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    const float li = l[i], ti = t[i], ri = r[i], bi = b[i], ai = area[i];
    int hit = 0;
    for (int j = tid; j < i; j += kThreads) {
      if (kept[j]) {
        const float iw = fmaxf(__fsub_rn(fminf(r[j], ri), fmaxf(l[j], li)),
                               0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(b[j], bi), fmaxf(t[j], ti)),
                               0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float iou =
            __fdiv_rn(inter, __fsub_rn(__fadd_rn(area[j], ai), inter));
        hit |= iou > thr;
      }
    }
    hit = __syncthreads_or(hit);
    if (i % kThreads == tid) kept[i] = (v[i] && !hit) ? 1 : 0;
  }

  for (int j = tid; j < k; j += kThreads) keep[base + j] = kept[j];
}

}  // namespace

// cand [c, k, 4] f32 contiguous, valid [c, k] u8 -> keep [c, k] u8.
// Returns a cudaError_t code (0 on success).
extern "C" int nms_suppress(const float* cand, const uint8_t* valid,
                            uint8_t* keep, int c, int k, float thr,
                            cudaStream_t stream) {
  if (c == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_suppress_kernel<<<c, kThreads, smem, stream>>>(cand, valid, keep, k,
                                                      thr);
  return static_cast<int>(cudaGetLastError());
}
