"""int8_core_roofline (%): the least time of one call's 67 quantized convs
on the sm90 core (`csrc/conv_gemm_q_sm90.cuh`'s `conv_gemm_q_kernel`,
under `pointwise_conv_block_q`, `conv3x3_block_q` and `down_conv_block_q`):
`work.int8_core_bound_s` at the call's batch, int8 operations at 1979
TOP/s or bytes at 3.35 TB/s, whichever is longer, over those kernels'
device time per call in the traced slice."""

import devtrace
import work

KERNELS = ("conv_gemm_q_kernel",)


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.span_list("bench.serve"))
    busy = devtrace.union_length(run.trace.ops_in("bench.serve",
                                                  names=KERNELS))
    if calls == 0 or busy == 0:
        return None
    bound = work.int8_core_bound_s(run.info["model"], run.info["batch"])
    return 100.0 * bound / (busy / calls)
