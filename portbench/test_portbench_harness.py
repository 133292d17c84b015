"""CPU tests of the harness: its window arithmetic, the union of device
intervals, the plain reference against the port's CPU path at 64 px, the
controls and planted faults coming out not correct, and that nothing the
runner loads belongs to the JAX package.

Run with `python -m pytest portbench/test_portbench_harness.py -q` from
the root of the repository (a few minutes on the CPU). The cells' own
sizes run only on the card, through `portbench/run.py` and
`portbench/control.py`.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import devtrace  # noqa: E402
import run as R  # noqa: E402
from loops import serve_closed, train_feed  # noqa: E402
from loops.common import Run  # noqa: E402

SMALL = dict(img_size=[64, 64, 3], filter_count=64, block_count=2)
SEED = 2 ** 33 + 12345  # wider than 32 bits, as seeds may be


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def _ctx(cell_config, traffic, work, seconds=0.6, trace=False, **model):
    """A loop's context at the small size; `work` the cell's
    `workloads/<cell>.json` (limits, margins)."""
    config = _load("configs", cell_config + ".json")
    config["model"].update(SMALL, **model)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return dict(config=config, traffic=traffic, seed=SEED, seconds=seconds,
                trace=trace, device="cpu", t_start=time.perf_counter(),
                **(work or {}))


def _serve_traffic(**kw):
    traffic = _load("traffic", "serve-b64.json")
    traffic.update(dict(batch=4, pool=8, probe_images=2,
                        warmup_calls=1, trace_calls=2), **kw)
    return traffic


def _train_traffic():
    traffic = _load("traffic", "train-b16-device-feed.json")
    traffic.update(batch=4, pool=16, rect_px=[8, 30], warmup_steps=0,
                   trace_steps=2)
    return traffic


def _spec(cell, model=SMALL):
    """The cell's spec as `run.py` finds it, at a small size: every pool
    batch is compared."""
    spec = R.cell_spec(R.load_json(ROOT, "BENCHMARK.json"), cell)
    spec["config"]["model"].update(model)
    if spec["traffic"]["loop"] == "train_feed":
        spec["traffic"] = _train_traffic()
    else:
        batch = spec["traffic"]["batch"] // 16
        spec["traffic"] = _serve_traffic(batch=batch, pool=2 * batch)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    return spec


def _measure(cell, model=SMALL, **kw):
    """A whole run through `run.measure` on the CPU, past the look for a
    chip: its result line, which must serialise."""
    out = R.measure(_spec(cell, model), SEED, 0.6, False, device="cpu",
                    t_start=time.perf_counter(), **kw)
    json.dumps(out)
    assert list(out)[-1] == "checks"
    return out


def _serve_limits(cell):
    return _load("workloads", cell + ".json")


def _train_limits():
    return _load("workloads", "bf16-train-b16.json")


# --- window arithmetic -----------------------------------------------------------

def test_rate_covers_the_window_and_a_stall_moves_the_p95():
    """One call in four stalls 0.3 s: the rate is the images over the whole
    window, stalls included, and the p95 of all calls is a stalled one."""
    calls = [0]

    def stall(serve):
        def slow(raw):
            calls[0] += 1
            if calls[0] % 4 == 0:
                time.sleep(0.3)
            return serve(raw)
        return slow

    ctx = _ctx("nist-yolov3-512-int8", _serve_traffic(), _serve_limits(
        "int8-serve-b64"), seconds=2.0)
    run = serve_closed.run(ctx, fault=stall)
    e2e = run.end_to_end
    assert e2e["serve_images_per_s"] == pytest.approx(
        run.info["images"] / run.info["window_s"])
    assert run.info["window_s"] >= 2.0
    assert sum(run.info["latency_s"]) == pytest.approx(
        run.info["window_s"], rel=0.05)
    assert e2e["serve_p95_ms"] >= 300.0
    assert sorted(run.info["latency_s"])[len(run.info["latency_s"]) // 2] \
        < 0.3


# --- device intervals ---------------------------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_union_counts_overlaps_once():
    assert devtrace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.union_length([(0, 10), (2, 3)]) == 10
    assert devtrace.union_length([]) == 0
    assert devtrace.merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_trace_assigns_ops_to_spans_and_finds_gaps():
    """Two kernels launched in `bench.serve` overlap on the device, a copy
    launched in `bench.d2h` follows a gap; times in microseconds."""
    events = [
        _ev("user_annotation", "bench.call", 0, 100),
        _ev("user_annotation", "bench.serve", 0, 20),
        _ev("user_annotation", "bench.d2h", 20, 80),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 21, 1, corr=3),
        _ev("cpu_op", "aten::copy_", 20, 80),
        _ev("kernel", "conv_gemm_q_kernel<128>", 10, 30, corr=1),
        _ev("kernel", "nms", 20, 30, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 70, 10, corr=3),
    ]
    tr = devtrace.Trace(events)
    win = tr.window("bench.call")
    assert win == pytest.approx((0.0, 100e-6))
    serve = tr.ops_in("bench.serve")
    assert len(serve) == 2
    assert devtrace.union_length(serve) == pytest.approx(40e-6)
    assert tr.ops_in("bench.serve", names=("conv_gemm_q_kernel",)) == [
        pytest.approx((10e-6, 40e-6))]
    assert tr.ops_in("bench.d2h") == []  # a copy is not a kernel
    assert tr.busy_s(win) == pytest.approx(50e-6)
    gaps = tr.idle_gaps(win)
    assert gaps[0][1] == pytest.approx(20e-6)
    assert gaps[0][0].startswith("bench.d2h / aten::copy_")
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 20e-6, 10e-6])


@pytest.mark.parametrize("name,span,unit", [
    ("idle_pct.serve", "bench.call", "calls"),
    ("idle_pct.train", "bench.step_all", "steps")])
def test_idle_share_is_of_the_unprofiled_window(name, span, unit):
    """Two traced spans of 100 us, each with 60 us of overlapping device
    ops: 60 us busy a span, so 10 of them in a 1 ms window leave it 40%
    idle, however long the traced slice's own wall was."""
    events = []
    for k, t in enumerate((0, 1000)):
        events += [_ev("user_annotation", span, t, 100),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 1, 1,
                       corr=2 * k),
                   _ev("cuda_runtime", "cudaLaunchKernel", t + 2, 1,
                       corr=2 * k + 1),
                   _ev("kernel", "a", t + 10, 50, corr=2 * k),
                   _ev("kernel", "b", t + 30, 40, corr=2 * k + 1)]
    tr = devtrace.Trace(events)
    assert tr.busy_per(span) == pytest.approx(60e-6)
    run = Run(True, 10, 0, {}, [], 0,
              {unit: 10, "window_s": 1e-3}, trace=tr)
    assert R.read_metric(name, run) == pytest.approx(40.0)
    run.trace = devtrace.Trace([])
    assert R.read_metric(name, run) is None


# --- the reference against the port's CPU path ------------------------------------

@pytest.mark.parametrize("cell,config", [
    ("int8-serve-b64", "nist-yolov3-512-int8"),
    ("bf16-serve-b32", "nist-yolov3-512-bf16")])
def test_serving_matches_the_reference(cell, config):
    run = serve_closed.run(_ctx(config, _serve_traffic(), _serve_limits(cell)))
    assert run.correct, run.checks
    assert run.info["candidates_per_image"] > 0


def test_training_in_float32_matches_the_reference_closely():
    """With the program in float32 the first steps agree to round-off: the
    reference's arithmetic is the program's."""
    ctx = _ctx("nist-yolov3-512-bf16", _train_traffic(), _train_limits(),
               compute_dtype="float32")
    run = train_feed.run(ctx)
    n = run.info["numbers"]
    assert n["loss_gap"] < 1e-5
    assert n["grad_gap"] < 1e-3 and n["change_gap"] < 2e-2
    assert n["feed_gap"] == 0 and n["label_diff"] == 0
    assert run.correct, run.checks


def test_training_matches_the_reference():
    run = train_feed.run(_ctx("nist-yolov3-512-bf16", _train_traffic(),
                              _train_limits()))
    assert run.correct, run.checks


# --- controls and faults --------------------------------------------------------------

def test_int4_control_fails():
    """The 4-bit reference in the program's place breaks a limit of the
    int8 cell (at 256 px, 4 blocks, width 128)."""
    import control
    work = _serve_limits("int8-serve-b64")
    spec = {"config": _ctx("nist-yolov3-512-int8", None, None, img_size=[
        256, 256, 3], filter_count=128, block_count=4)["config"],
            "traffic": _serve_traffic(), **work}
    worst = control.int4_control(spec, SEED, "cpu")
    limits = work["limits"]
    assert any(worst[k] > limits[k] for k in limits), worst


def test_int8_control_of_bf16_serving_fails():
    """The program's int8 path in the bf16 cell's place, at the cell's own
    width and depth (512 px, two images a call; a few minutes): its
    boxes drift from the bf16 reference's about as far as the 8-bit
    reference's, past the limit of `box_gap_rel`."""
    out = _measure("bf16-serve-b32", model={}, precision="int8")
    assert not out["correct"], out["checks"]


def test_int8_training_control_fails():
    out = _measure("bf16-train-b16", int8_train=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["int8-serve-b64", "bf16-serve-b32"])
def test_an_answer_altered_where_it_is_produced_fails(cell):
    """The serving function's scores moved by 0.05 where it returns them."""
    def altered(serve):
        def wrong(raw):
            boxes, scores, keep = serve(raw)
            return boxes, scores + 0.05, keep
        return wrong

    out = _measure(cell, fault=altered)
    assert not out["correct"], out["checks"]


def test_a_step_that_leaves_the_state_unchanged_fails():
    def unchanged(step):
        def same(state, batch, lr):
            params = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = step(state, batch, lr)
            with torch.no_grad():
                for p, q in zip(state.model.parameters(), params):
                    p.copy_(q)
            return state, metrics
        return same

    out = _measure("bf16-train-b16", fault=unchanged)
    assert not out["correct"], out["checks"]


def test_half_the_batch_left_out_fails():
    out = _measure("bf16-train-b16", fault=train_feed.half_batch)
    assert not out["correct"], out["checks"]


def test_sound_runs_are_correct():
    for cell in ("int8-serve-b64", "bf16-serve-b32", "bf16-train-b16"):
        out = _measure(cell)
        assert out["correct"], (cell, out["checks"])


# --- no JAX -------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["int8-serve-b64", "bf16-train-b16"])
def test_nothing_run_loads_belongs_to_the_jax_package(cell):
    """A traced CPU run of the cell through `run.measure` in a fresh
    process, every per-layer metric's reader with it (the two cells
    between them read all of them), leaves no module whose top-level name
    is `jax`, `jaxlib`, `flax` or `yolov3_tpu` (`yolov3_tpu_torch` is
    another name)."""
    code = f"""
import sys, json, time
sys.path.insert(0, {HERE!r}); sys.path.insert(1, {ROOT!r})
import run as R
import control
spec = json.loads(sys.argv[1])
out = R.measure(spec, {SEED}, 0.6, True, device="cpu",
                t_start=time.perf_counter())
print(json.dumps(sorted(out["metrics"])))
print(json.dumps(R.forbidden_modules()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    spec = _spec(cell)
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, json.dumps(spec)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    # the readers that find something to read on the CPU (no device ops)
    assert json.loads(lines[-3])
    assert json.loads(lines[-2]) == []
    loaded = json.loads(lines[-1])
    assert "yolov3_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "yolov3_tpu"} & set(loaded)


def test_a_jax_module_loaded_after_the_window_refuses_the_run(
        monkeypatch, capsys):
    """A module of the JAX package that appears once the window has closed
    (here, as a metric reader would load it, inside `measure`'s return)
    ends the run with no result line."""
    import types

    def measure(*args, **kw):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "device": {}, "checks": {}}

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(R, "measure", measure)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(R.Refused, match="flax"):
        R.main(["--workload", "int8-serve-b64", "--seed", "1",
                "--seconds", "1"])
    assert capsys.readouterr().out == ""
