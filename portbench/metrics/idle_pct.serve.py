"""idle_pct.serve (%): the share of the measured window in which no
device op (kernel, copy, memset) ran. The device's busy seconds a call
are the union of the ops' intervals over the traced slice, per `bench.call`
span; times the window's calls, over the window's seconds (host clock).
The window is unprofiled: the profiler slows the host, so the traced
slice's own wall would count its overhead as idle."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_per("bench.call")
    if busy == 0:
        return None
    info = run.info
    return 100.0 * (1.0 - busy * info["calls"] / info["window_s"])
