"""device_ms_per_call.serve (ms): in the traced slice, the union of the
device intervals of the kernels launched inside the benchmark's
`bench.serve` spans (model, decode and NMS; not the copies), per call."""

import devtrace


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.span_list("bench.serve"))
    busy = devtrace.union_length(run.trace.ops_in("bench.serve"))
    if calls == 0 or busy == 0:
        return None
    return busy / calls * 1e3
