"""The harness's own checks of the YOLOv4 cell (`loops/serve_yolov4.py`):
sound runs are correct, the 8-bit control in the program's place and
planted faults are not, nothing run loads the JAX package, the loop
stops where a class fills `max_boxes_per_class`, and the rows it keeps of
each call compare as the whole outputs would.

    python -m pytest portbench/test_portbench_yolov4.py -q

from the root of the repository. On a card the cell runs at its own 608
px (four images a call, a pool of eight; a few minutes), elsewhere at 64
px on the CPU.
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

import run as R  # noqa: E402

CELL = "yolov4-608-serve-b32"
SEED = 2 ** 33 + 4099
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
SMALL = {} if DEVICE == "cuda" else {"img_size": [64, 64, 3]}


def _spec(**inference):
    spec = R.cell_spec(R.load_json(ROOT, "BENCHMARK.json"), CELL)
    spec["config"]["model"].update(SMALL)
    spec["config"]["inference"].update(inference)
    spec["traffic"].update(batch=4, pool=8, probe_images=4, warmup_calls=1,
                           trace_calls=2)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    return spec


def _measure(trace=False, spec=None, **kw):
    out = R.measure(spec or _spec(), SEED, 0.6, trace, device=DEVICE,
                    t_start=time.perf_counter(), **kw)
    json.dumps(out)
    assert list(out)[-1] == "checks"
    return out


def test_sound_runs_are_correct():
    out = _measure()
    assert out["correct"], out["checks"]


def test_the_8bit_control_fails():
    """The 8-bit fake-quantized reference's candidates in the program's
    place (`precision="int8"`, as `control.py` runs it) break a limit."""
    out = _measure(precision="int8")
    assert not out["correct"], out["checks"]


def _scores_moved(serve):
    def wrong(raw):
        boxes, scores, keep = serve(raw)
        return boxes, scores + 0.05, keep
    return wrong


def _anchors_of_the_wrong_scale(serve):
    """The program's decode handed the scales' anchor sets in reverse
    order (stride 8 decoding with stride 32's), where the detector calls
    it."""
    from yolov3_tpu_torch.models import yolov4
    decode = yolov4.decode_detections

    def reversed_anchors(*args, **kw):
        return decode(*args, **dict(kw, scale_anchors=kw["scale_anchors"][
            ::-1]))

    def wrong(raw):
        yolov4.decode_detections = reversed_anchors
        try:
            return serve(raw)
        finally:
            yolov4.decode_detections = decode
    return wrong


@pytest.mark.parametrize("fault", [_scores_moved,
                                   _anchors_of_the_wrong_scale])
def test_an_answer_altered_where_it_is_produced_fails(fault):
    out = _measure(fault=fault)
    assert not out["correct"], out["checks"]


def test_the_loop_stops_if_a_class_fills_max_boxes():
    with pytest.raises(RuntimeError, match="max_boxes_per_class"):
        _measure(spec=_spec(max_boxes_per_class=1))


def test_compact_outputs_compare_as_the_whole_outputs():
    """The loop keeps only each call's rows above the threshold
    (`compact`): its `compare` reads from them what `serve_closed.compare`
    reads from the whole outputs, a keep flag set below the threshold
    included."""
    import judge
    from loops import serve_closed as S
    from loops import serve_yolov4 as L
    icfg = {"score_threshold": 0.5, "iou_threshold": 0.45,
            "max_boxes_per_class": 8}
    gen = torch.Generator().manual_seed(SEED)
    batch, classes, k = 2, 3, 8
    xy = torch.rand(batch, classes, k, 2, generator=gen) * 50
    boxes = torch.cat([xy, xy + 5 + 20 * torch.rand(
        batch, classes, k, 2, generator=gen)], -1)
    scores = torch.rand(batch, classes, k, generator=gen).sort(
        dim=-1, descending=True).values
    scores = torch.where(scores >= 0.5, scores, torch.tensor(-1.0))
    keep = torch.zeros(batch, classes, k, dtype=torch.bool)
    for b_ in range(batch):
        for c in range(classes):
            keep[b_, c] = torch.from_numpy(judge.greedy_keep(
                boxes[b_, c].numpy(), scores[b_, c].numpy() >= 0.5, 0.45))
    ref = {}
    for img in range(4):
        j = img % batch
        ref[img] = [(boxes[j, c][scores[j, c] >= 0.5].numpy() + 0.5 * img,
                     scores[j, c][scores[j, c] >= 0.5].numpy())
                    for c in range(classes)]
    stray = keep.clone()
    stray[1, 2, -1] = True
    for got in ((boxes, scores, keep), (boxes, scores, stray)):
        outs = [(0, got), (1, got), (2, got)]
        want = S.compare(outs, ref, batch, 4, icfg, 0.004)
        have = L.compare([(i, L.compact(g, 0.5)) for i, g in outs], ref,
                         batch, 4, icfg, 0.004)
        assert have == want
        assert have["compared"] == 6 and 0 < have["box_gap_mean"] < 1
    assert have["keep_diff"] == 1


def test_nothing_run_loads_belongs_to_the_jax_package():
    """A traced run through `run.measure` in a fresh process, every
    per-layer metric's reader with it, leaves no module whose top-level
    name is `jax`, `jaxlib`, `flax` or `yolov3_tpu`."""
    code = f"""
import sys, json, time
sys.path.insert(0, {HERE!r}); sys.path.insert(1, {ROOT!r})
import run as R
spec = json.loads(sys.argv[1])
out = R.measure(spec, {SEED}, 0.6, True, device={DEVICE!r},
                t_start=time.perf_counter())
print(json.dumps(sorted(out["metrics"])))
print(json.dumps(R.forbidden_modules()))
"""
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code, json.dumps(_spec())],
                         capture_output=True, text=True, env=env,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    metrics = json.loads(lines[-2])
    assert "fused_pointwise_pct.serve" in metrics
    if DEVICE == "cuda":
        assert {"yolov4_serve_mfu", "mish_pointwise_roofline",
                "spp_device_ms.serve"} <= set(metrics)
    assert json.loads(lines[-1]) == []
