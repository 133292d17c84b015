"""The program's own spans and counters (`yolov3_tpu_torch/utils/tracing.py`)
on the traced slice's timeline, for the per-layer metrics that read them.

The recorder keeps its spans in memory on the Unix clock. `devtrace.Trace`
keeps the exported trace's times less the trace's base, a whole number of
seconds, which it drops. `line_up` finds the whole number of seconds that
puts every program root span of the slice inside the benchmark span around
its call (`yolo.serve` in `bench.serve`; `yolo.step` in `bench.step` and
`yolo.feed` in `bench.feed`) and keeps the program's spans inside
`run.trace_window`. A device op belongs to a program span if it was
launched inside it (the launch's host time, as `devtrace` gives ops to the
benchmark's spans); device time is a union of intervals.

Each reader returns None where there is nothing to read: no trace, a
program without the recorder (a commit before it), no program span in the
slice, no device op, or a program root span that does not nest.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import devtrace

SERVE = {"yolo.serve": "bench.serve"}
TRAIN = {"yolo.step": "bench.step", "yolo.feed": "bench.feed"}
# how far a program span may poke out of its benchmark span or the slice:
# the profiler's clock and the recorder's agree to a few microseconds
SLACK_S = 200e-6

Span = Tuple[str, float, float, Optional[str], Optional[int]]


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from yolov3_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


class Lined:
    """The program's spans in the traced slice, in the trace's seconds:
    (name, start, end, parent, call_id)."""

    def __init__(self, spans: List[Span], base_s: int):
        self.spans = spans
        self.base_s = base_s

    def of(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e, _, _ in self.spans if n == name]

    def call_ids(self, name: str) -> List[Optional[int]]:
        return [c for n, _, _, _, c in self.spans if n == name]


def _nests(spans: List[Span], outer: Dict[str, List[Tuple[float, float]]]
           ) -> bool:
    for root, bench in outer.items():
        inner = sorted((s, e) for n, s, e, _, _ in spans if n == root)
        if not bench or len(inner) != len(bench):
            return False
        for (s, e), (bs, be) in zip(inner, bench):
            if s < bs - SLACK_S or e > be + SLACK_S:
                return False
    return True


def line_up(trace, window, records: Sequence[tuple],
            roots: Dict[str, str]) -> Optional[Lined]:
    """The recorder's `records` (Unix nanoseconds) placed on `trace`'s
    timeline and cut to `window`, at the whole second at which each root
    span of `roots` ({program root: benchmark span}) in the window nests,
    one to one and in order, in the benchmark spans there; None where no
    second does."""
    if trace is None or window is None or not records:
        return None
    w0, w1 = window
    outer = {r: [(s, e) for s, e in trace.span_list(b)
                 if s >= w0 and e <= w1] for r, b in roots.items()}
    starts = [s for spans in outer.values() for s, _ in spans]
    if not all(outer.values()):
        return None
    first_ns = round(min(starts) * 1e9)
    seconds = set()
    for name, s, _, _, _ in records:
        if name in roots:
            k = (s - first_ns) // 10 ** 9
            seconds.update((k, k + 1))
    for k in sorted(seconds, reverse=True):
        base = k * 10 ** 9
        placed = [(n, (s - base) * 1e-9, (e - base) * 1e-9, p, c)
                  for n, s, e, p, c in records]
        inside = [x for x in placed
                  if x[1] >= w0 - SLACK_S and x[2] <= w1 + SLACK_S]
        if _nests(inside, outer):
            return Lined(inside, k)
    return None


def lined(run, roots: Dict[str, str]) -> Optional[Lined]:
    """`line_up` of the run's trace and the program's recorded spans."""
    tracing = recorder()
    if tracing is None or run.trace is None:
        return None
    return line_up(run.trace, run.trace_window, tracing.spans(), roots)


def launched_in(trace, spans: Sequence[Tuple[float, float]],
                kinds: Sequence[str] = ("kernel",)
                ) -> List[Tuple[float, float]]:
    """Device intervals of the ops whose launch lies inside one of
    `spans` (trace seconds)."""
    merged = devtrace.merged(spans)
    starts = [s for s, _ in merged]
    out = []
    for _, ts, end, launched, cat in trace.ops:
        if launched is None or cat not in kinds:
            continue
        i = bisect.bisect_right(starts, launched) - 1
        if i >= 0 and launched <= merged[i][1]:
            out.append((ts, end))
    return out


def device_ms(run, roots: Dict[str, str], name: str, per: str
              ) -> Optional[float]:
    """Device ms of the kernels launched inside the spans `name`, per root
    span `per` in the slice."""
    line = lined(run, roots)
    if line is None:
        return None
    calls, spans = len(line.of(per)), line.of(name)
    if calls == 0 or not spans:
        return None
    busy = devtrace.union_length(launched_in(run.trace, spans))
    if busy == 0:
        return None
    return busy / calls * 1e3


def host_ms(run, roots: Dict[str, str], name: str, per: str
            ) -> Optional[float]:
    """Host ms inside the spans `name`, per root span `per` in the slice."""
    line = lined(run, roots)
    if line is None:
        return None
    calls, spans = len(line.of(per)), line.of(name)
    if calls == 0 or not spans:
        return None
    return sum(e - s for s, e in spans) / calls * 1e3


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two unions of intervals."""
    a, b = devtrace.merged(a), devtrace.merged(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace, window) -> List[Tuple[float, float]]:
    """The stretches of `window` in which no device op ran."""
    gaps, t = [], window[0]
    for s, e in devtrace.merged(trace.device_intervals(window)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    return gaps


def idle_in_program_pct(run, roots: Dict[str, str]) -> Optional[float]:
    """The share of the slice's device-idle time during which the host was
    inside one of the program's root spans `roots`."""
    line = lined(run, roots)
    if line is None or not run.trace.device_intervals(run.trace_window):
        return None
    gaps = idle_gaps(run.trace, run.trace_window)
    idle = sum(e - s for s, e in gaps)
    if idle == 0:
        return None
    inside = [iv for root in roots for iv in line.of(root)]
    return 100.0 * overlap(gaps, inside) / idle


def kept_pct(run) -> Optional[float]:
    """100 x `nms.kept` / `nms.candidates` over the slice's serving calls,
    each distinct call counted once. The loop cycles its pool, so where the
    window ended decides which batches the slice serves more often than
    others; a batch's counts are exact, so equal counts are the same batch
    served again."""
    line = lined(run, SERVE)
    tracing = recorder()
    if line is None or tracing is None:
        return None
    per_call = tracing.counters(by_call=True)
    counts = {(per_call[c].get("nms.candidates", 0.0),
               per_call[c].get("nms.kept", 0.0))
              for c in line.call_ids("yolo.serve") if c in per_call}
    candidates = sum(c for c, _ in counts)
    if candidates == 0:
        return None
    return 100.0 * sum(k for _, k in counts) / candidates
