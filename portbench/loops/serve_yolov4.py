"""Closed-loop YOLOv4 serving, one client: each call takes the next batch
of a seeded pool of pinned 8-bit RGB images (cycled), copies it to the
card, runs the program's serving function on RGB / 255 (forward, decode,
clip, the small-box filter, per-class NMS over the configuration's
classes) and copies boxes, scores and keep masks back to the host. The
next call starts when the last one's outputs are on the host. Of each
call's outputs the loop keeps, for the comparison after the window, only
the rows scoring at or above the threshold (`compact`): the whole
outputs, ~7 MB a call at b32, would pile up in host memory over a window
and slow the later calls. It compacts the last call's outputs
while the card runs the next call, between handing the batch in and
waiting for its outputs, so the host's bookkeeping adds no time between
calls.

The program is built as a user builds it: the weights exported by
`utils/checkpoint.export_model`, served by `inference.make_serving_fn`
on `inference.input_transform`'s preprocessing.

Weights come from the seed (`make_weights`, from the reference's conv
spec). Each BatchNorm's mean and variance are the statistics of its
conv's output over the probe images (`reference/yolov4.set_statistics`),
as a trained model's are its data's: with random kernels and made-up
statistics the activations of a 110-conv network would vanish or blow up.
Its scales U(0.15, 0.25) and offsets N(0.5, 0.1^2) keep most inputs of
Mish and LeakyReLU on their near-linear side, where a rounding difference
is carried to the heads without being amplified: with scales near 1 and
offsets near 0 a random network normalised by its own statistics is
chaotic (each layer multiplies a perturbation by ~1.2 against the signal,
so bf16's rounding alone left the heads' logits uncorrelated with
float32's), and at U(0.3, 0.5) a second summation order of the same bf16
arithmetic still moved the boxes by a third as much as the 8-bit control
did; at U(0.15, 0.25) by a fifteenth or less.
Random heads then put a box over the threshold in most of the 80 classes
or in none, and favour some classes over the rest, so each class
channel's bias is first centred on its logits' mean over the probe
images (`centre_classes`), then the heads' class biases, then their
objectness biases, are shifted (`head_shifts`, by bisection on the
float32 reference's logits of the probe images) until the traffic's
`score_share` of raw boxes score at or above the threshold for some
class, in `classes_per_candidate` classes on average, as a trained
detector's peaked class scores do.

`correct`: the reference's NMS candidates of every pool image
(`reference/yolov4.py::Bf16Serve`, each pool batch computed as it is
served) against the program's candidates and keep masks in every call of
the window (`judge.compare_image`); `box_gap_rel` is the program's
`box_gap_mean` over that of the 8-bit control (`Quant8`) against the
same reference. A candidate whose score moved by more than
`score_margin` finds no partner and counts 1, so `box_gap_rel` holds the
scores too; `score_gap`, the widest single score difference, stays among
the run's numbers (`info["numbers"]`) and is held to no limit: sound runs
read up to half the control's there. With `precision="int8"` the
control's candidates stand in for the program's outputs
(`portbench/control.py`'s control). The run stops with an error where a class fills `max_boxes_per_class`, in the
program's outputs or the reference's: the comparison would then miss
what the cap cut.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

import devtrace
import judge
from loops import serve_closed as S
from loops.common import Run, model_dict, program_config, report_setup
from reference import yolov4 as R4
from reference.model import no_tf32

F32 = torch.float32


def v4_model(config: dict) -> dict:
    """The configuration's model settings, with `number_anchors` a scale."""
    m = model_dict(config)
    m["number_anchors"] = len(m["anchors"]) // len(R4.STRIDES)
    m["scale_x_y"] = tuple(m["scale_x_y"])
    return m


def make_weights(model: dict, seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{conv_<L>: {kernel OIHW, scale, offset, mean, var} or {kernel,
    bias}} in float32 on `device`, from `seed`: kernels N(0, 1/fan_in),
    scales U(0.15, 0.25), offsets N(0.5, 0.1^2), head biases N(0, 0.1^2);
    means 0 and variances 1 until `set_statistics`."""
    specs = R4.conv_specs(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    ksizes = [co * ci * k * k for _, ci, co, k, _, _ in specs]
    flat = torch.randn(sum(ksizes), generator=gen, device=device)
    total = sum(co for _, _, co, _, _, _ in specs)
    normals = torch.randn(total, generator=gen, device=device) * 0.1
    uni = torch.rand(total, generator=gen, device=device)
    weights, at, vec = {}, 0, 0
    for (name, ci, co, k, _, act), n in zip(specs, ksizes):
        p = {"kernel": (flat[at:at + n] * (ci * k * k) ** -0.5).reshape(
            co, ci, k, k)}
        at += n
        sl = slice(vec, vec + co)
        vec += co
        if act == "linear":
            p["bias"] = normals[sl]
        else:
            p["scale"] = 0.15 + 0.1 * uni[sl]
            p["offset"] = 0.5 + normals[sl]
            p["mean"] = torch.zeros(co, device=device)
            p["var"] = torch.ones(co, device=device)
        weights[name] = {key: v.contiguous() for key, v in p.items()}
    return weights


def flax_trees(weights: dict) -> Tuple[dict, dict]:
    """(params, batch_stats) as the program's export takes them:
    `conv_<L>/Conv_0/kernel` (HWIO; a head's `bias` beside it),
    `conv_<L>/BatchNorm_0/{scale,bias}` and `{mean,var}`."""
    params, stats = {}, {}

    def host(t):
        return np.ascontiguousarray(t.detach().to("cpu", F32).numpy())

    for name, p in weights.items():
        conv = {"kernel": host(p["kernel"].permute(2, 3, 1, 0))}
        if "bias" in p:
            conv["bias"] = host(p["bias"])
        params[name] = {"Conv_0": conv}
        if "scale" in p:
            params[name]["BatchNorm_0"] = {"scale": host(p["scale"]),
                                           "bias": host(p["offset"])}
            stats[name] = {"BatchNorm_0": {"mean": host(p["mean"]),
                                           "var": host(p["var"])}}
    return params, stats


def head_shifts(fms: List[torch.Tensor], model: dict, share: float,
                per_candidate: float, threshold: float,
                iters: int = 40) -> Tuple[float, float]:
    """(class shift, objectness shift) of the heads' logits, from the raw
    logits of `fms`: for a class shift dc, the objectness shift do(dc) at
    which `share` of the boxes score >= the threshold for some class
    (sqrt(p_c * o) >= t, as p_c * o >= t^2); dc bisected so that such a box
    does so in `per_candidate` classes on average (more as dc rises)."""
    per = 5 + model["number_classes"]
    lo = torch.cat([f.reshape(-1, per) for f in fms]).double()
    to, tc = lo[:, 4], lo[:, 5:]
    best = tc.max(dim=1).values
    t2 = threshold * threshold

    def obj_shift(dc):
        pm = torch.sigmoid(best + dc)
        a, b = -40.0, 40.0
        for _ in range(iters):
            mid = 0.5 * (a + b)
            frac = float((pm * torch.sigmoid(to + mid) >= t2).double().mean())
            a, b = (mid, b) if frac < share else (a, mid)
        return 0.5 * (a + b)

    def classes(dc):
        do = obj_shift(dc)
        passing = torch.sigmoid(tc + dc) * torch.sigmoid(to + do)[:, None] \
            >= t2
        cand = passing.any(dim=1)
        mean = float(passing[cand].sum(dim=1).double().mean()) \
            if cand.any() else 0.0
        return mean, do

    a, b = -20.0, 20.0
    for _ in range(iters):
        mid = 0.5 * (a + b)
        a, b = (mid, b) if classes(mid)[0] < per_candidate else (a, mid)
    dc = 0.5 * (a + b)
    return dc, classes(dc)[1]


def centre_classes(fms: List[torch.Tensor], weights: dict, model: dict
                   ) -> None:
    """Shift each class channel's head bias, and its logits in `fms`, by
    minus the mean of its logits over `fms`: on noise images a random
    head's class channels differ in mean by more than their logits vary,
    so without this one class took nearly every box over the threshold
    (and filled `max_boxes_per_class`)."""
    per = 5 + model["number_classes"]
    for fm, name in zip(fms, R4.HEADS):
        centre = fm.reshape(-1, fm.shape[-1]).mean(dim=0).reshape(-1, per)
        centre[:, :5] = 0.0
        centre = centre.reshape(-1)
        fm -= centre
        weights[name]["bias"] -= centre


def apply_shifts(weights: dict, model: dict, dc: float, do: float) -> None:
    per = 5 + model["number_classes"]
    for name in R4.HEADS:
        bias = weights[name]["bias"]
        for a in range(model["number_anchors"]):
            bias[a * per + 4] += do
            bias[a * per + 5:(a + 1) * per] += dc


@torch.no_grad()
def seeded_weights(model: dict, seed: int, device, traffic: dict,
                   icfg: dict, probe: torch.Tensor):
    """The seed's weights with the probe images' statistics, the class
    channels centred and the heads' shifts; and the shifts."""
    wts = make_weights(model, seed, device)
    x = R4.preprocess(probe)
    R4.set_statistics(wts, model, x)
    with no_tf32():
        fms = R4.forward(R4.Float(wts, model), model, x)
    centre_classes(fms, wts, model)
    dc, do = head_shifts(fms, model, traffic["score_share"],
                         traffic["classes_per_candidate"],
                         icfg["score_threshold"])
    apply_shifts(wts, model, dc, do)
    return wts, (dc, do)


def build_program(config: dict, wts: dict, workdir: str, device):
    """The program's serving function on raw uint8 batches, from an export
    of `wts` under `workdir`."""
    from yolov3_tpu_torch.config import InferenceConfig
    from yolov3_tpu_torch.inference import input_transform, make_serving_fn
    from yolov3_tpu_torch.utils.checkpoint import export_model
    params, stats = flax_trees(wts)
    path = export_model(workdir, params, stats, program_config(config))
    serve_f, cfg = make_serving_fn(
        path, icfg=InferenceConfig(**config["inference"]), device=device)
    prep = input_transform(cfg)

    def serve(raw):
        return serve_f(prep(raw))
    return serve


@torch.no_grad()
def reference_pool(ar, model: dict, icfg: dict, pool: torch.Tensor,
                   batch: int, device) -> Dict[int, list]:
    """{pool image: the arithmetic `ar`'s NMS candidates}, each pool batch
    computed as it is served."""
    out = {}
    with no_tf32():
        for b0 in range(0, pool.shape[0] - batch + 1, batch):
            x = R4.preprocess(pool[b0:b0 + batch].to(device))
            det = R4.decode(R4.forward(ar, model, x), model)
            out.update(zip(range(b0, b0 + batch),
                           R4.candidates(det, model, icfg)))
    return out


def compact(got, threshold: float):
    """A call's outputs (boxes [B, C, K, 4], scores [B, C, K], keep [B, C,
    K]) as what the comparison reads: the (image, class, slot) of every
    entry scoring >= `threshold`, its box, score and keep flag, and per
    image the keep flags set elsewhere (greedy NMS keeps none there)."""
    boxes, scores, keep = got
    valid = scores >= threshold
    return (valid.nonzero().numpy(), boxes[valid].numpy(),
            scores[valid].numpy(), keep[valid].numpy(),
            (keep & ~valid).sum(dim=(1, 2)).numpy())


def compare(outs, ref: Dict[int, list], batch: int, npool: int,
            icfg: dict, margin: float) -> Dict[str, float]:
    """`serve_closed.compare` over `compact` outputs [(call, compacted)]:
    each image's arrays are rebuilt (scores -1 where no row is kept) and
    compared once for each distinct output."""
    t, k = icfg["score_threshold"], icfg["max_boxes_per_class"]
    classes = len(next(iter(ref.values())))
    worst: Dict[str, float] = {"compared": 0.0}
    total = count = 0.0
    seen = {}
    for i, (idx, boxes, scores, keep, stray) in outs:
        base = (i * batch) % npool
        ends = np.searchsorted(idx[:, 0], np.arange(batch + 1))
        for j in range(batch):
            img = (base + j) % npool
            sl = slice(ends[j], ends[j + 1])
            key = (img, idx[sl].tobytes(), boxes[sl].tobytes(),
                   scores[sl].tobytes(), keep[sl].tobytes(), int(stray[j]))
            if key not in seen:
                b = np.zeros((classes, k, 4), np.float32)
                s = np.full((classes, k), -1.0, np.float32)
                kp = np.zeros((classes, k), bool)
                c, slot = idx[sl, 1], idx[sl, 2]
                b[c, slot], s[c, slot], kp[c, slot] = (boxes[sl], scores[sl],
                                                      keep[sl])
                nums = judge.compare_image(b, s, kp, ref[img], t,
                                           icfg["iou_threshold"], margin)
                nums["keep_diff"] += float(stray[j])
                seen[key] = nums
            nums = seen[key]
            for name in ("score_gap", "box_gap", "keep_diff"):
                worst[name] = max(worst.get(name, 0.0), nums[name])
            total += nums["box_gap_sum"]
            count += nums["box_gap_count"]
            worst["compared"] += 1
    worst["box_gap_mean"] = total / count if count else 0.0
    return worst


def saturated(outs, ref: Dict[int, list], icfg: dict) -> bool:
    """Whether a class filled `max_boxes_per_class` anywhere."""
    k = icfg["max_boxes_per_class"]
    if any(len(s) >= k for cands in ref.values() for _, s in cands):
        return True
    return any(bool((got[0][:, 2] == k - 1).any()) for _, got in outs)


def run(ctx: dict, fault=None, precision: str = None) -> Run:
    """One run of the cell; `fault(serve)` may wrap the program's serving
    function (the harness's own tests); `precision="int8"` puts the 8-bit
    control's candidates in the program's place."""
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    # first, so that a program without YOLOv4 refuses at once
    program_config(config)
    model = v4_model(config)
    icfg = config["inference"]
    batch, npool = traffic["batch"], traffic["pool"]
    marks = [("start", time.perf_counter())]
    pool = S.make_pool(model, npool, seed, device)
    marks.append(("pool", time.perf_counter()))
    wts, shifts = seeded_weights(model, seed, device, traffic, icfg,
                                 pool[:traffic["probe_images"]].to(device))
    marks.append(("weights, statistics and shifts", time.perf_counter()))
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        serve = build_program(config, wts, workdir, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    marks.append(("export and load", time.perf_counter()))
    gc.collect()
    if fault is not None:
        serve = fault(serve)
    nbatch = npool // batch
    rf = torch.profiler.record_function

    def call(i, meanwhile=None):
        host = pool[(i % nbatch) * batch:(i % nbatch + 1) * batch]
        with rf("bench.call"):
            with rf("bench.h2d"):
                dev = host.to(device, non_blocking=True)
            with rf("bench.serve"):
                t = time.perf_counter()
                outs = serve(dev)
                dispatch = time.perf_counter() - t
            if meanwhile is not None:
                meanwhile()
            with rf("bench.d2h"):
                got = tuple(o.cpu() for o in outs)
        return got, dispatch

    for i in range(traffic["warmup_calls"]):
        call(i)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    lat, outs, disp = [], [], []
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    i, last = 0, None

    def keep_last():
        outs.append((i - 1, compact(last, icfg["score_threshold"])))
    while True:
        s = time.perf_counter()
        got, d = call(i, keep_last if last is not None else None)
        e = time.perf_counter()
        lat.append(e - s)
        disp.append(d)
        last = got
        i += 1
        if e - t0 >= ctx["seconds"]:
            break
    window_s = e - t0
    keep_last()
    del last, got
    report_setup(ctx["t_start"], marks)
    trace = window = None
    if ctx["trace"]:
        start = i
        trace = devtrace.profile(lambda k: call(start + k),
                                 traffic["trace_calls"])
        window = trace.window("bench.call")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del serve
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref = reference_pool(R4.Bf16Serve(wts, model), model, icfg, pool, batch,
                         device)
    scales = R4.calibrate(wts, model, R4.preprocess(pool[:batch].to(device)))
    ctl = reference_pool(R4.Quant8(wts, model, scales), model, icfg, pool,
                         batch, device)
    del wts
    if saturated(outs, ref, icfg):
        raise RuntimeError(f"a class filled max_boxes_per_class "
                           f"({icfg['max_boxes_per_class']}): raise it or "
                           "lower the traffic's score_share")
    margin = ctx["score_margin"]
    t = icfg["score_threshold"]
    control = compare([(i, compact(got, t)) for i, got in
                       S.candidate_outputs(ctl, icfg)], ref, 1, npool, icfg,
                      margin)
    if precision == "int8":
        worst = control
    else:
        worst = compare(outs, ref, batch, npool, icfg, margin)
    drift, mean = control["box_gap_mean"], worst["box_gap_mean"]
    worst["box_gap_rel"] = mean / drift if drift > 0 else (
        0.0 if mean == 0 else float("inf"))
    limits = ctx["limits"]
    checks = [(k, worst.get(k, float("inf")), limits[k]) for k in limits]
    calls = len(lat)
    cands = sum(len(s) for v in ref.values() for _, s in v)
    return Run(
        correct=judge.held(checks) and worst["compared"] > 0,
        attempted=calls, failed=0,
        end_to_end={"serve_images_per_s": calls * batch / window_s,
                    "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak),
        info={"window_s": window_s, "images": calls * batch, "batch": batch,
              "calls": calls, "dispatch_s": disp, "latency_s": lat,
              "model": model, "precision": config["precision"],
              "peak": config["peak"], "shift": shifts,
              "trace_calls": traffic["trace_calls"],
              "candidates_per_image": cands / len(ref),
              "control": control, "numbers": worst},
        trace=trace, trace_window=window)
