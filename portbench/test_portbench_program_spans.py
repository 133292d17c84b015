"""CPU tests of `program_spans`: the program's recorded spans lined up with
a hand-made device trace (the whole-second base found, ops given to the
span they were launched in, None where a root span does not nest or the
program has no recorder), the idle share inside the program on hand-made
gaps, the kept share over distinct calls, and traced CPU runs whose
program-span readers find the program's spans.

Run with `python -m pytest portbench/test_portbench_program_spans.py -q`
from the root of the repository.
"""

import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import devtrace  # noqa: E402
import program_spans as P  # noqa: E402
import run as R  # noqa: E402
from loops.common import Run  # noqa: E402
from test_portbench_harness import SEED, _spec  # noqa: E402

BASE_S = 1790857026  # the trace's base, whole seconds
US = 1000  # nanoseconds


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _ns(us):
    """A time on the trace's clock (us past the base) on the Unix clock."""
    return BASE_S * 10 ** 9 + int(us * US)


class FakeRecorder:
    def __init__(self, records, by_call=None):
        self.records, self.by_call = records, by_call or {}

    def spans(self):
        return list(self.records)

    def counters(self, by_call=False):
        assert by_call
        return self.by_call


def _serving(calls=2, late=None):
    """`calls` serving calls 1000 us apart: `bench.call` [t, t+100],
    `bench.serve` [t, t+60]; the program's `yolo.serve` [t+2, t+58] holds
    `yolo.stem` [t+3, t+20] and `yolo.nms` [t+30, t+50]. A stem kernel
    launched at t+5 runs [t+10, t+40], an NMS kernel launched at t+31 runs
    [t+40, t+55], a copy after the call [t+70, t+90]. With `late` = k, call
    k's `yolo.serve` ends 340 us after its `bench.serve`."""
    events, records = [], []
    for k in range(calls):
        t = 10000 + 1000 * k
        c = 3 * k
        events += [
            _ev("user_annotation", "bench.call", t, 100),
            _ev("user_annotation", "bench.serve", t, 60),
            _ev("cuda_runtime", "cudaLaunchKernel", t + 5, 1, corr=c),
            _ev("cuda_runtime", "cudaLaunchKernel", t + 31, 1, corr=c + 1),
            _ev("cuda_runtime", "cudaMemcpyAsync", t + 62, 1, corr=c + 2),
            _ev("kernel", "conv", t + 10, 30, corr=c),
            _ev("kernel", "nms", t + 40, 15, corr=c + 1),
            _ev("gpu_memcpy", "Memcpy DtoH", t + 70, 20, corr=c + 2)]
        end = t + (400 if late == k else 58)
        records += [("yolo.stem", _ns(t + 3), _ns(t + 20), "yolo.serve", k),
                    ("yolo.nms", _ns(t + 30), _ns(t + 50), "yolo.serve", k),
                    ("yolo.serve", _ns(t + 2), _ns(end), None, k)]
    tr = devtrace.Trace(events)
    return tr, records


def _run(trace):
    return Run(True, 1, 0, {}, [], 0, {}, trace=trace,
               trace_window=trace.window("bench.call"))


def test_the_whole_second_base_is_found():
    tr, records = _serving()
    line = P.line_up(tr, tr.window("bench.call"), records, P.SERVE)
    assert line is not None
    assert line.base_s == BASE_S
    assert [s for s, _ in line.of("yolo.serve")] == pytest.approx(
        [10002e-6, 11002e-6], abs=1e-9)
    assert line.of("yolo.stem")[1] == pytest.approx((11003e-6, 11020e-6),
                                                    abs=1e-9)


def test_spans_outside_the_slice_are_left_out():
    """A call recorded before the slice (an earlier session) is dropped,
    and the base is still found."""
    tr, records = _serving()
    old = [(n, s - 5 * 10 ** 9, e - 5 * 10 ** 9, p, c + 10)
           for n, s, e, p, c in records]
    line = P.line_up(tr, tr.window("bench.call"), old + records, P.SERVE)
    assert line.base_s == BASE_S
    assert sorted(line.call_ids("yolo.serve")) == [0, 1]


def test_ops_go_to_the_span_they_were_launched_in(monkeypatch):
    tr, records = _serving()
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(records))
    run = _run(tr)
    assert P.device_ms(run, P.SERVE, "yolo.stem", "yolo.serve") == \
        pytest.approx(30e-3)
    assert P.device_ms(run, P.SERVE, "yolo.nms", "yolo.serve") == \
        pytest.approx(15e-3)
    assert P.device_ms(run, P.SERVE, "yolo.decode", "yolo.serve") is None
    assert P.host_ms(run, P.SERVE, "yolo.nms", "yolo.serve") == \
        pytest.approx(20e-3)
    names = ("stem_device_ms.serve", "nms_device_ms.serve")
    assert [R.read_metric(n, run) for n in names] == [
        pytest.approx(30e-3), pytest.approx(15e-3)]


def test_a_root_that_does_not_nest_reads_none(monkeypatch):
    tr, records = _serving(late=0)
    assert P.line_up(tr, tr.window("bench.call"), records, P.SERVE) is None
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(records))
    run = _run(tr)
    for name in ("stem_device_ms.serve", "nms_device_ms.serve",
                 "idle_in_program_pct.serve", "nms_kept_pct.serve"):
        assert R.read_metric(name, run) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    tr, _ = _serving()
    monkeypatch.setattr(P, "recorder", lambda: None)
    run = _run(tr)
    for name in ("stem_device_ms.serve", "idle_in_program_pct.serve",
                 "nms_kept_pct.serve", "forward_host_ms.train",
                 "idle_in_program_pct.train"):
        assert R.read_metric(name, run) is None
    assert R.read_metric("stem_device_ms.serve", Run(
        True, 1, 0, {}, [], 0, {})) is None


def test_idle_in_program_on_hand_made_gaps(monkeypatch):
    """Each call's window [t, t+1000] (the last call's ends at t+100) is
    idle over [t, t+10], [t+55, t+70] and [t+90, next]; `yolo.serve`
    [t+2, t+58] covers 8 + 3 us of them."""
    tr, records = _serving()
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(records))
    run = _run(tr)
    gaps = P.idle_gaps(tr, run.trace_window)
    assert [(round(s * 1e6), round(e * 1e6)) for s, e in gaps] == [
        (10000, 10010), (10055, 10070), (10090, 11010), (11055, 11070),
        (11090, 11100)]
    idle = 10 + 15 + 920 + 15 + 10
    assert R.read_metric("idle_in_program_pct.serve", run) == \
        pytest.approx(100.0 * (8 + 3 + 8 + 3) / idle)
    assert P.overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)


def test_kept_share_counts_each_distinct_call_once(monkeypatch):
    """Three calls of which two served the same batch (equal counts): the
    share is over the two distinct ones; a call outside the slice is not
    read."""
    tr, records = _serving(calls=3)
    by_call = {0: {"nms.candidates": 10.0, "nms.kept": 4.0},
               1: {"nms.candidates": 30.0, "nms.kept": 6.0},
               2: {"nms.candidates": 10.0, "nms.kept": 4.0},
               7: {"nms.candidates": 1000.0, "nms.kept": 1000.0}}
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(records, by_call))
    assert R.read_metric("nms_kept_pct.serve", _run(tr)) == \
        pytest.approx(100.0 * 10 / 40)


def test_training_spans_nest_in_step_and_feed(monkeypatch):
    """`yolo.step` must nest in `bench.step` and `yolo.feed` in
    `bench.feed`; the phases read per step, the optimizer's two spans
    summed."""
    events, records = [], []
    for k in range(2):
        t = 1000 * k
        events += [
            _ev("user_annotation", "bench.step_all", t, 500),
            _ev("user_annotation", "bench.feed", t, 100),
            _ev("user_annotation", "bench.step", t + 100, 400),
            _ev("cuda_runtime", "cudaLaunchKernel", t + 120, 1, corr=k),
            _ev("kernel", "fwd", t + 130, 50, corr=k)]
        records += [
            ("yolo.feed", _ns(t + 5), _ns(t + 95), None, 10 * k),
            ("yolo.step.forward", _ns(t + 110), _ns(t + 150), "yolo.step",
             10 * k + 1),
            ("yolo.step.optimizer", _ns(t + 160), _ns(t + 170), "yolo.step",
             10 * k + 1),
            ("yolo.step.optimizer", _ns(t + 300), _ns(t + 330), "yolo.step",
             10 * k + 1),
            ("yolo.step", _ns(t + 105), _ns(t + 400), None, 10 * k + 1)]
    tr = devtrace.Trace(events)
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(records))
    run = Run(True, 1, 0, {}, [], 0, {}, trace=tr,
              trace_window=tr.window("bench.step_all"))
    assert R.read_metric("forward_device_ms.train", run) == \
        pytest.approx(50e-3)
    assert R.read_metric("optimizer_host_ms.train", run) == \
        pytest.approx(40e-3)
    assert R.read_metric("backward_host_ms.train", run) is None
    bad = [r if r[0] != "yolo.feed" else (r[0], r[1], r[2] + 400 * US,
                                          r[3], r[4]) for r in records]
    monkeypatch.setattr(P, "recorder", lambda: FakeRecorder(bad))
    assert R.read_metric("forward_device_ms.train", run) is None


NEW = ("stem_device_ms.serve", "backbone_device_ms.serve",
       "neck_device_ms.serve", "heads_device_ms.serve",
       "decode_device_ms.serve", "nms_device_ms.serve", "nms_kept_pct.serve",
       "idle_in_program_pct.serve", "forward_host_ms.train",
       "loss_host_ms.train", "backward_host_ms.train",
       "optimizer_host_ms.train", "forward_device_ms.train",
       "loss_device_ms.train", "backward_device_ms.train",
       "optimizer_device_ms.train", "idle_in_program_pct.train")


@pytest.mark.parametrize("cell,reads", [
    ("bf16-serve-b32", ["nms_kept_pct.serve"]),
    ("bf16-train-b16", ["backward_host_ms.train", "forward_host_ms.train",
                        "loss_host_ms.train", "optimizer_host_ms.train"])])
def test_a_traced_cpu_run_reads_the_programs_spans(cell, reads):
    """A traced CPU run of the cell: the program's spans line up with the
    benchmark's, so the readers that need no device op read a number; the
    device readers find no device op and read nothing."""
    out = R.measure(_spec(cell), SEED, 0.6, True, device="cpu",
                    t_start=time.perf_counter())
    assert sorted(m for m in out["metrics"] if m in NEW) == reads
    for name in reads:
        assert out["metrics"][name]["value"] > 0
