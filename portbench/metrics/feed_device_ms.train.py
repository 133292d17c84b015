"""feed_device_ms.train (ms): in the traced slice, the union of the device
intervals of the kernels launched inside the benchmark's `bench.feed`
spans (the draws and `preprocess_batch`), per batch."""

import devtrace


def read(run):
    if run.trace is None:
        return None
    steps = len(run.trace.span_list("bench.feed"))
    busy = devtrace.union_length(run.trace.ops_in("bench.feed"))
    if steps == 0 or busy == 0:
        return None
    return busy / steps * 1e3
