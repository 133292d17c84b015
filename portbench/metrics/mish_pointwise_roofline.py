"""mish_pointwise_roofline (%): the least time of one call's 43 Mish 1x1
convs (`work_yolov4.mish_pointwise_bound_s` at the call's batch: bf16
operations at 989 TFLOP/s or bytes at 3.35 TB/s, whichever is longer,
for each) over the device time per call of the fused 1x1 kernel's Mish
instantiation (`csrc/conv_gemm_q_sm90.cuh`'s `conv_gemm_q_kernel` with
OP = 2, `kOpBF16Mish`, at each tile width BN) launched in `bench.serve` in
the traced slice. None where no such kernel ran (a program without it)."""

import devtrace
import work_yolov4

KERNELS = tuple(f"conv_gemm_q_kernel<{bn}, 1, 2, false>"
                for bn in (32, 64, 128, 256))


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.span_list("bench.serve"))
    busy = devtrace.union_length(run.trace.ops_in("bench.serve",
                                                  names=KERNELS))
    if calls == 0 or busy == 0:
        return None
    bound = work_yolov4.mish_pointwise_bound_s(run.info["model"],
                                               run.info["batch"])
    return 100.0 * bound / (busy / calls)
