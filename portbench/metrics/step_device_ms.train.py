"""step_device_ms.train (ms): in the traced slice, the union of the device
intervals of the kernels launched inside the benchmark's `bench.step`
spans (train-mode forward, loss, backward, Adam), per step."""

import devtrace


def read(run):
    if run.trace is None:
        return None
    steps = len(run.trace.span_list("bench.step"))
    busy = devtrace.union_length(run.trace.ops_in("bench.step"))
    if steps == 0 or busy == 0:
        return None
    return busy / steps * 1e3
