"""The program's spans and counters (`yolov3_tpu_torch/utils/tracing.py`),
on the CPU: off by default and silent, nesting and call ids per thread,
the recorder's clock against the profiler's exported trace, the spans of
a serving call in bf16 and int8 and of a train step with the device
feed, and the NMS counters against the serving function's outputs."""

import json
import threading

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.config import (AugmentConfig, InferenceConfig,
                                     ModelConfig, TrainConfig)
from yolov3_tpu_torch.data.device_pipeline import preprocess_batch
from yolov3_tpu_torch.inference import make_serving_fn
from yolov3_tpu_torch.models.quantized import make_quantized_serving_fn
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils import checkpoint as ckpt
from yolov3_tpu_torch.utils import tracing

CFG = dict(img_size=(64, 64, 3), number_classes=2,
           anchors=((16, 16), (32, 32)), block_count=1, filter_count=32)
STAGES = ("yolo.stem", "yolo.backbone", "yolo.neck", "yolo.heads")
STEP = ("yolo.step", "yolo.step.forward", "yolo.step.loss",
        "yolo.step.backward", "yolo.step.optimizer") + STAGES


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    cfg = ModelConfig(compute_dtype="float32", **CFG)
    params, stats = ckpt.init_params(cfg, 3)
    return ckpt.export_model(str(tmp_path_factory.mktemp("model")), params,
                             stats, cfg)


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, 64, 64, 3))
                            .astype(np.float32))


def _by_call(records):
    out = {}
    for name, s, e, parent, call_id in records:
        out.setdefault(call_id, []).append(name)
    return out


def test_off_records_nothing(export):
    """Neither a profiler nor `recording()`: `span` hands out one shared
    no-op, and neither spans, counts nor a serving call leave a record."""
    assert not tracing.is_on()
    a, b = tracing.span("yolo.serve"), tracing.span("yolo.nms")
    assert a is b
    with a:
        tracing.count("nms.kept", torch.ones(3, dtype=torch.bool))
    serve, _ = make_serving_fn(export, device="cpu")
    serve(_images())
    assert tracing.spans() == []
    assert tracing.counters() == {}
    assert tracing.counters(by_call=True) == {}


def test_nesting_and_call_ids_per_thread():
    """Parents and call ids follow each thread's own stack: a span that
    another thread opens while this thread's root is open belongs to no
    call, and a root on that thread opens a call of its own."""
    seen = {}

    def other():
        with tracing.span("yolo.stem"):
            pass
        with tracing.span("yolo.step"):
            with tracing.span("yolo.step.forward"):
                pass

    with tracing.recording():
        assert tracing.is_on()
        with tracing.span("yolo.serve"):
            with tracing.span("yolo.nms"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
            tracing.count("nms.kept", torch.tensor([True, False, True]))
        tracing.count("nms.kept", 4)
    assert not tracing.is_on()
    for name, s, e, parent, call_id in tracing.spans():
        assert s <= e
        seen[name] = (parent, call_id)
    serve_id = seen["yolo.serve"][1]
    step_id = seen["yolo.step"][1]
    assert serve_id is not None and step_id is not None
    assert serve_id != step_id
    assert seen["yolo.serve"] == (None, serve_id)
    assert seen["yolo.nms"] == ("yolo.serve", serve_id)
    assert seen["yolo.stem"] == (None, None)
    assert seen["yolo.step.forward"] == ("yolo.step", step_id)
    assert tracing.counters() == {"nms.kept": 6.0}
    assert tracing.counters(by_call=True) == {serve_id: {"nms.kept": 2.0},
                                               None: {"nms.kept": 4.0}}


def _clock_offsets(tmp_path):
    """One profiled session of 20 calls: {span: [(recorded start - event
    start, recorded end - event end) ns]}, the events' times put on the
    Unix clock by the exported trace's `baseTimeNanoseconds`."""
    from torch.profiler import ProfilerActivity, profile
    tracing.clear()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.is_on()
        for i in range(20):
            with tracing.span("yolo.serve"):
                with tracing.span("yolo.nms"):
                    x = x * 0.5 + 1.0
    assert not tracing.is_on()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc["baseTimeNanoseconds"])
    events = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("yolo."):
            events.setdefault(ev["name"], []).append(ev)
    recorded = {}
    for name, s, e, _, _ in tracing.spans():
        recorded.setdefault(name, []).append((s, e))
    assert sorted(recorded) == ["yolo.nms", "yolo.serve"]
    out = {}
    for name, spans in recorded.items():
        evs = sorted(events[name], key=lambda ev: ev["ts"])
        assert len(evs) == len(spans) == 20
        out[name] = []
        for (s, e), ev in zip(spans, evs):
            start = base + ev["ts"] * 1e3
            out[name].append((s - start, e - (start + ev["dur"] * 1e3)))
    return out


def test_recorder_clock_is_the_profilers(tmp_path):
    """Under `torch.profiler`, each recorded span's start and end, less the
    exported trace's `baseTimeNanoseconds`, lie within 50 us of the same
    span's `record_function` event. The recorder reads the clock just
    after the profiler does, and a busy host can deschedule the process
    between the two reads: a session so disturbed is taken again, up to
    three times."""
    with tracing.recording():  # the profiler's ops looked up once
        with tracing.span("yolo.serve"):
            pass
    worst = []
    for _ in range(3):
        offsets = _clock_offsets(tmp_path)
        worst.append(max(abs(d) for pairs in offsets.values()
                         for pair in pairs for d in pair))
        if worst[-1] < 50e3:
            break
    assert worst[-1] < 50e3, worst


def _serve_spans(serve, calls=2):
    with tracing.recording():
        outs = [serve(_images(seed=k)) for k in range(calls)]
    return outs, _by_call(tracing.spans())


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
def test_serving_call_opens_every_span(export, precision):
    """Each call opens `yolo.serve` and, inside it, each stage, decode and
    NMS: the bf16 model its neck and heads three times, int8 once."""
    icfg = InferenceConfig()
    if precision == "int8":
        serve, _, _ = make_quantized_serving_fn(export, _images(seed=9),
                                                icfg=icfg, device="cpu")
    else:
        serve, _ = make_serving_fn(export, icfg=icfg, device="cpu")
    _, calls = _serve_spans(serve)
    assert None not in calls
    assert len(calls) == 2
    per = 3 if precision == "bfloat16" else 1
    for names in calls.values():
        assert names.count("yolo.serve") == 1
        for stage in ("yolo.stem", "yolo.backbone", "yolo.decode",
                      "yolo.nms"):
            assert names.count(stage) == 1, (stage, names)
        assert names.count("yolo.neck") == per
        assert names.count("yolo.heads") == per


def test_nms_counters_are_the_outputs_sums(export):
    """`nms.candidates` and `nms.kept` are the sums of `scores >= the
    threshold` and of `keep` that the calls returned, per call too."""
    icfg = InferenceConfig()
    serve, _ = make_serving_fn(export, icfg=icfg, min_box_size=1,
                               device="cpu")
    outs, calls = _serve_spans(serve, calls=3)
    cands = [float((o[1] >= icfg.score_threshold).sum()) for o in outs]
    kept = [float(o[2].sum()) for o in outs]
    assert sum(kept) > 0
    assert tracing.counters() == {"nms.candidates": sum(cands),
                                  "nms.kept": sum(kept)}
    per_call = tracing.counters(by_call=True)
    assert sorted(per_call) == sorted(calls)
    got = [per_call[c] for c in sorted(per_call)]
    assert got == [{"nms.candidates": c, "nms.kept": k}
                   for c, k in zip(cands, kept)]


def test_train_step_and_feed_open_their_spans():
    """One batch of the device feed opens `yolo.feed`, one step `yolo.step`
    with forward, loss, backward and the optimizer (twice: zero_grad and
    the step) inside it, and the train-mode forward its stages; nothing
    recorded lies outside a root."""
    cfg = ModelConfig(compute_dtype="float32", **CFG)
    state = T.create_train_state(cfg, TrainConfig(), device="cpu")
    step = T.make_train_step(cfg, TrainConfig(), 2)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 255, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=gen)
    boxes = torch.tensor([[[8, 8, 20, 24, 0], [30, 10, 16, 16, 1]]] * 2,
                         dtype=torch.float32)
    valid = torch.ones(2, 2, dtype=torch.bool)
    with tracing.recording():
        batch = preprocess_batch(images, boxes, valid, gen, AugmentConfig(),
                                 CFG["img_size"], CFG["anchors"], 2)
        step(state, batch, 1e-4)
    calls = _by_call(tracing.spans())
    assert None not in calls
    assert sorted(map(sorted, calls.values())) == sorted([
        ["yolo.feed"], sorted(STEP + ("yolo.neck", "yolo.neck", "yolo.heads",
                                      "yolo.heads", "yolo.step.optimizer"))])
    parents = {(n, p) for n, _, _, p, _ in tracing.spans()}
    assert ("yolo.step.backward", "yolo.step") in parents
    assert ("yolo.stem", "yolo.step.forward") in parents
