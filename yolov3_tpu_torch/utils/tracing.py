"""The program's own spans and counters, on the profiler's clock.

    with tracing.span("yolo.nms"):
        ...
    tracing.count("nms.kept", keep)

`span(name)` enters `torch.profiler.record_function(name)`, so every
profiler trace (the trainer's `--profile_dir` one included) shows it, and
keeps `(name, start_ns, end_ns, parent, call_id)` in a bounded buffer.
Times are `time.time_ns()`, the Unix clock: a span's `ts` in an exported
Chrome trace plus the trace's `baseTimeNanoseconds` is the same clock.
`parent` is the name of the span open around it on the same thread (None
at the top). A root span (`ROOTS`: one serving call, one train step, one
batch of the device feed) opens a new `call_id`, which the spans and
counts inside it share; outside any root it is None.

Recording is on while a `torch.profiler` session records, and inside
`recording()`, which a process embedding the serving function or the
step can use to collect spans and counters without a profiler. Nothing
else turns it on. While it is off `span` returns one shared no-op context
after a single check, and `count` returns at once: nothing is allocated
or recorded.

`count(name, value)` adds to a counter; a tensor is summed on its device
and never synchronised. `spans()`, `counters()` and `clear()` read and
reset what was recorded; `counters()` synchronises once.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

ROOTS = frozenset(("yolo.serve", "yolo.step", "yolo.feed"))
MAX_RECORDS = 65536

SpanRecord = Tuple[str, int, int, Optional[str], Optional[int]]

# `_is_profiler_enabled` is True while a profiler session records
_profiler = torch.autograd.profiler
_depth = 0  # open `recording()` blocks
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_totals: Dict[str, object] = {}
_per_call: collections.deque = collections.deque(maxlen=MAX_RECORDS)


def is_on() -> bool:
    """Whether spans and counts are recorded now."""
    return bool(_depth or _profiler._is_profiler_enabled)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "call_id", "start", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer else None
        self.call_id = (next(_ids) if self.name in ROOTS
                        else outer.call_id if outer else None)
        self._rf = _profiler.record_function(self.name)
        stack.append(self)
        # both stamps just after the profiler's own: its enter and exit
        # may take tens of microseconds before they read the clock
        self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _spans.append((self.name, self.start, end, self.parent,
                       self.call_id))
        return False


def span(name: str):
    """A context that records the span `name` while recording is on."""
    if not (_depth or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Add `value` (a number, or a tensor's sum) to the counter `name`
    while recording is on, under the innermost root span's call."""
    if not is_on():
        return
    stack = _stack()
    call_id = stack[-1].call_id if stack else None
    if isinstance(value, torch.Tensor):
        value = value.detach().sum(dtype=torch.float64)
    with _lock:
        prev = _totals.get(name)
        _totals[name] = value if prev is None else prev + value
        _per_call.append((call_id, name, value))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counts inside this block, profiler or not."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (at most `MAX_RECORDS`)."""
    return list(_spans)


def _numbers(values: list) -> List[float]:
    """Tensors and numbers as floats; the tensors of each device read in
    one copy to the host."""
    out = [float(v) if not isinstance(v, torch.Tensor) else None
           for v in values]
    by_device: Dict[torch.device, List[int]] = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        host = torch.stack([values[i] for i in idx]).cpu().tolist()
        for i, v in zip(idx, host):
            out[i] = v
    return out


def counters(by_call: bool = False):
    """{counter: total}; with `by_call`, {call_id: {counter: total}} over
    the most recent `MAX_RECORDS` counts."""
    with _lock:
        if not by_call:
            names, values = list(_totals), list(_totals.values())
        else:
            records = list(_per_call)
    if not by_call:
        return dict(zip(names, _numbers(values)))
    out: Dict[Optional[int], Dict[str, float]] = {}
    for (call_id, name, _), v in zip(records,
                                     _numbers([r[2] for r in records])):
        calls = out.setdefault(call_id, {})
        calls[name] = calls.get(name, 0.0) + v
    return out


def clear() -> None:
    """Forget every recorded span and count."""
    with _lock:
        _spans.clear()
        _totals.clear()
        _per_call.clear()
