"""The traced slice: `torch.profiler` over a fixed number of calls or
steps after the measured window, the benchmark's own spans around each
call into a layer, and the reduction of the device trace to intervals.

A device op (kernel, memcpy, memset) belongs to the benchmark span that
was open on the host when its launch was issued: the op's `correlation`
id names the runtime call that launched it. Device time is always a
union of intervals, never a sum of durations, so overlapping ops count
once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of the intervals as disjoint, sorted intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The device ops and benchmark spans of one traced slice; times in
    seconds on the trace's clock."""

    def __init__(self, events: List[dict]):
        self.spans: List[Tuple[str, float, float]] = []
        self.cpu_ops: List[Tuple[str, float, float]] = []
        launch_ts: Dict[int, float] = {}
        ops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts = float(ev.get("ts", 0.0)) * 1e-6
            end = ts + float(ev.get("dur", 0.0)) * 1e-6
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                ops.append((name, ts, end, args.get("correlation"), cat))
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                self.spans.append((name, ts, end))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch_ts[args["correlation"]] = ts
            elif cat == "cpu_op":
                self.cpu_ops.append((name, ts, end))
        self.spans.sort(key=lambda s: s[1])
        self.ops = []
        for name, ts, end, corr, cat in ops:
            self.ops.append((name, ts, end, launch_ts.get(corr), cat))
        self.ops.sort(key=lambda o: o[1])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events)

    def span_list(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def window(self, name: str) -> Optional[Interval]:
        """From the start of the first span `name` to the end of the last."""
        spans = self.span_list(name)
        if not spans:
            return None
        return spans[0][0], max(e for _, e in spans)

    def ops_in(self, span: str, kinds: Sequence[str] = ("kernel",),
               names: Optional[Sequence[str]] = None) -> List[Interval]:
        """Device intervals of the ops launched inside a span `span`; with
        `names`, only ops whose name contains one of them."""
        spans = self.span_list(span)
        starts = [s for s, _ in spans]
        out = []
        for name, ts, end, launched, cat in self.ops:
            if launched is None or cat not in kinds:
                continue
            if names is not None and not any(n in name for n in names):
                continue
            i = bisect.bisect_right(starts, launched) - 1
            if i >= 0 and launched <= spans[i][1]:
                out.append((ts, end))
        return out

    def device_intervals(self, window: Interval) -> List[Interval]:
        """Every device op's interval, cut to the window."""
        s0, e0 = window
        return [(max(s, s0), min(e, e0)) for _, s, e, _, _ in self.ops
                if e > s0 and s < e0]

    def busy_s(self, window: Interval) -> float:
        return union_length(self.device_intervals(window))

    def busy_per(self, span: str) -> float:
        """Seconds in which a device op ran, over the slice from the first
        span `span` to the last, per span: 0 where there is none."""
        window = self.window(span)
        if window is None:
            return 0.0
        return self.busy_s(window) / len(self.span_list(span))

    def top_ops(self, window: Interval, n: int = 10) -> List[list]:
        """[name, seconds] of the device ops with the most time."""
        tot: Dict[str, float] = {}
        for name, s, e, _, _ in self.ops:
            if e > window[0] and s < window[1]:
                tot[name] = tot.get(name, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span and cpu op open at host time t."""
        span = [n for n, s, e in self.spans if s <= t <= e]
        ops = [(e - s, n) for n, s, e in self.cpu_ops if s <= t <= e]
        label = span[-1] if span else "outside spans"
        if ops:
            label += " / " + min(ops)[1]
        return label[:160]

    def idle_gaps(self, window: Interval, n: int = 10) -> List[list]:
        """[what the host was doing, seconds] of the longest stretches of
        the window in which no device op ran."""
        busy = merged(self.device_intervals(window))
        gaps, t = [], window[0]
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if window[1] > t:
            gaps.append((t, window[1]))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[self._host_at(s), e - s] for s, e in gaps[:n]]


def profile(fn, count: int):
    """Run fn(i) for i in range(count) under `torch.profiler` (CPU and
    CUDA activity) and return its `Trace`."""
    import torch
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(count):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
    return Trace.from_profiler(prof)
