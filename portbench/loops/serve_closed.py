"""Closed-loop serving, one client: each call takes the next batch of a
seeded pool of pinned host images (cycled), copies it to the card, runs
the program's serving function (z-score, forward, decode, clip, the
small-box filter, per-class NMS) and copies boxes, scores and keep masks
back to the host. The next call starts when the last one's outputs are
on the host.

The configuration's `precision` selects the program's entry:
- `int8`: `models/quantized.make_quantized_serving_fn(..., raw_pixels=
  True)` with its default kernel set, calibrated (absmax) on the pool's
  first batch, z-scored by the program, as the CLI calibrates on its
  first batch;
- `bfloat16`: `zscore_images`, then `inference.make_serving_fn`'s serve.

Random weights put every box near the score threshold; the heads'
objectness biases are shifted, by the reference, so that the traffic's
`score_share` of raw boxes score at or above it, as a trained
detector's do.

`correct`: the reference's NMS candidates of every pool image, each
batch computed as it is served, against the program's candidates and
keep masks in every call of the window (`judge.compare_image`). Where
the cell's limits hold `box_gap_rel` (a bf16 cell), the program's
`box_gap_mean` is also taken as a share of the 8-bit reference's against
the same bf16 reference (`eight_bit_drift`): the drift that bf16 itself
leaves differs from seed to seed as much as the int8 path's exceeds it,
while their ratio is steady.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

import devtrace
import judge
import weights as W
from loops.common import Run, generator, model_dict, program_config, \
    report_setup
from reference import detect as RD
from reference import model as RM


def make_pool(model: dict, n: int, seed: int, device) -> torch.Tensor:
    """`n` seeded uint8 images [n, H, W, C] in pinned host memory."""
    h, w, c = model["img_size"]
    gen = generator(seed, device, stream=1)
    imgs = torch.randint(0, 256, (n, h, w, c), generator=gen, device=device,
                         dtype=torch.uint8)
    host = imgs.cpu()
    return host.pin_memory() if torch.device(device).type == "cuda" else host


@torch.no_grad()
def reference_dets(ar, model: dict, raw: torch.Tensor, block: int = 4
                   ) -> np.ndarray:
    """Decoded rows [N, boxes, 5+C] of raw uint8 images under the
    reference arithmetic `ar`."""
    out = []
    with RM.no_tf32():
        for i in range(0, raw.shape[0], block):
            fms = RM.forward(ar, model, RM.zscore(raw[i:i + block]))
            out.append(RD.decode(fms, model["anchors"],
                                 model["number_classes"]).cpu().numpy())
    return np.concatenate(out)


def reference_candidates(dets: np.ndarray, model: dict, icfg: dict
                         ) -> List[list]:
    """Per image, per class: the reference's NMS candidates."""
    h, w = model["img_size"][:2]
    out = []
    for det in dets:
        boxes, sc = RD.scores(det, (h, w), icfg["min_box_size"])
        out.append(RD.candidates(boxes, sc, icfg["score_threshold"],
                                 icfg["max_boxes_per_class"]))
    return out


def shifted_weights(model: dict, seed: int, device, share: float,
                    icfg: dict, probe: torch.Tensor):
    """The seed's weights with every head's objectness bias moved by the
    shift at which `share` of the probe images' raw boxes score at or
    above the threshold (the float32 reference's decode); and the
    shift."""
    wts = W.make_weights(model, seed, "serve", device)
    dets = reference_dets(RM.Float(wts, model), model, probe)
    shift = RD.objectness_shift(dets, share, icfg["score_threshold"])
    apply_shift(wts, model, shift)
    return wts, shift


def apply_shift(wts: dict, model: dict, shift: float) -> None:
    per = 5 + model["number_classes"]
    for h in range(3):
        wts[f"DetectionHead_{h}"]["bias"][4::per] += shift


def build_program(config: dict, wts: dict, calib_raw: torch.Tensor,
                  workdir: str, device, precision: str = None):
    """The program's serving function on raw uint8 batches, from an
    export of `wts` under `workdir`, on the configuration's precision or
    on `precision`."""
    from yolov3_tpu_torch.config import InferenceConfig
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    from yolov3_tpu_torch.utils.checkpoint import export_model
    params, stats = W.flax_trees(wts)
    path = export_model(workdir, params, stats, program_config(config))
    icfg = InferenceConfig(**config["inference"])
    if (precision or config["precision"]) == "int8":
        from yolov3_tpu_torch.models.quantized import \
            make_quantized_serving_fn
        serve, _, _ = make_quantized_serving_fn(
            path, zscore_images(calib_raw.to(device)), icfg=icfg,
            raw_pixels=True, device=device)
        return serve
    from yolov3_tpu_torch.inference import make_serving_fn
    serve_f, _ = make_serving_fn(path, icfg=icfg, device=device)

    def serve(raw):
        return serve_f(zscore_images(raw))
    return serve


def reference_for(config: dict, model: dict, wts: dict,
                  calib_raw: torch.Tensor, bits: int = 8):
    """The plain reference arithmetic in the configuration's precision:
    the quantized one for `int8` (`bits` < 8: at that width), the bf16
    serving one for `bfloat16`."""
    if config["precision"] == "int8":
        levels = 2 ** (bits - 1) - 1
        scales = RM.calibrate(wts, model, RM.zscore(calib_raw),
                              levels=levels)
        return RM.Quant(wts, model, scales, bits=bits)
    return RM.Bf16Serve(wts, model)


def reference_pool(config: dict, traffic: dict, seed: int, device,
                   pool: torch.Tensor, shift: float, bits: int = 8
                   ) -> Dict[int, list]:
    """{pool image: the reference's NMS candidates}, each pool batch
    computed as it is served (`bits`: the quantized reference's width)."""
    model = model_dict(config)
    batch = traffic["batch"]
    wts = W.make_weights(model, seed, "serve", device)
    apply_shift(wts, model, shift)
    ar = reference_for(config, model, wts, pool[:batch].to(device), bits)
    out = {}
    for b in range(traffic["pool"] // batch):
        dets = reference_dets(ar, model, pool[b * batch:(b + 1) * batch]
                              .to(device), block=batch)
        out.update(zip(range(b * batch, (b + 1) * batch),
                       reference_candidates(dets, model,
                                            config["inference"])))
    return out


def candidate_outputs(cands: Dict[int, list], icfg: dict) -> list:
    """Per-image candidates of a reference arithmetic in the program's
    output form, one image a call: [(image, (boxes [1, C, K, 4], scores
    [1, C, K], keep [1, C, K]))], keep by the reference's greedy NMS."""
    k = icfg["max_boxes_per_class"]
    outs = []
    for img in sorted(cands):
        c = len(cands[img])
        boxes = np.zeros((c, k, 4), np.float32)
        scores = np.full((c, k), -1.0, np.float32)
        keep = np.zeros((c, k), bool)
        for cls, (b, s) in enumerate(cands[img]):
            boxes[cls, :len(s)], scores[cls, :len(s)] = b, s
            keep[cls] = judge.greedy_keep(boxes[cls], scores[cls] >= icfg[
                "score_threshold"], icfg["iou_threshold"])
        outs.append((img, tuple(torch.from_numpy(a[None]) for a in (
            boxes, scores, keep))))
    return outs


def eight_bit_drift(config: dict, traffic: dict, seed: int, device,
                    pool: torch.Tensor, shift: float, ref: Dict[int, list],
                    margin: float) -> float:
    """`box_gap_mean` of the 8-bit reference (`reference/model.py::Quant`,
    calibrated as the int8 configuration is) against `ref`, the bf16
    reference's candidates of every pool image: the drift that the
    precision step below bf16 gives on these weights and images."""
    q = reference_pool(dict(config, precision="int8"), traffic, seed,
                       device, pool, shift)
    return compare(candidate_outputs(q, config["inference"]), ref, 1,
                   traffic["pool"], config["inference"],
                   margin)["box_gap_mean"]


def compare(outs, ref: Dict[int, list], batch: int, npool: int,
            icfg: dict, margin: float) -> Dict[str, float]:
    """The worst of each number over every call's outputs
    (`judge.compare_image` against `ref`, the reference's candidates of
    every pool image), and `box_gap_mean` over all of them."""
    worst: Dict[str, float] = {"compared": 0.0}
    total = count = 0.0
    seen = {}
    for i, got in outs:
        base = (i * batch) % npool
        for j in range(batch):
            img = (base + j) % npool
            arrays = tuple(t[j].numpy() for t in got)
            key = (img, b"".join(a.tobytes() for a in arrays))
            if key not in seen:
                seen[key] = judge.compare_image(
                    *arrays, ref[img], icfg["score_threshold"],
                    icfg["iou_threshold"], margin)
            nums = seen[key]
            for name in ("score_gap", "box_gap", "keep_diff"):
                worst[name] = max(worst.get(name, 0.0), nums[name])
            total += nums["box_gap_sum"]
            count += nums["box_gap_count"]
            worst["compared"] += 1
    worst["box_gap_mean"] = total / count if count else 0.0
    return worst


def run(ctx: dict, fault=None, precision: str = None) -> Run:
    """One run of the cell; `fault(serve)` may wrap the program's serving
    function (the harness's own tests), `precision` run the program's path
    of another precision (the control)."""
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    model = model_dict(config)
    icfg = config["inference"]
    batch, npool = traffic["batch"], traffic["pool"]
    marks = [("start", time.perf_counter())]
    pool = make_pool(model, npool, seed, device)
    marks.append(("pool", time.perf_counter()))
    wts, shift = shifted_weights(model, seed, device, traffic["score_share"],
                                 icfg, pool[:traffic["probe_images"]]
                                 .to(device))
    marks.append(("weights and shift", time.perf_counter()))
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        serve = build_program(config, wts, pool[:batch], workdir, device,
                              precision)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    marks.append(("export, load, calibrate", time.perf_counter()))
    del wts
    gc.collect()
    if fault is not None:
        serve = fault(serve)
    nbatch = npool // batch
    rf = torch.profiler.record_function

    def call(i):
        host = pool[(i % nbatch) * batch:(i % nbatch + 1) * batch]
        with rf("bench.call"):
            with rf("bench.h2d"):
                dev = host.to(device, non_blocking=True)
            with rf("bench.serve"):
                t = time.perf_counter()
                outs = serve(dev)
                dispatch = time.perf_counter() - t
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
    i = 0
    while True:
        s = time.perf_counter()
        got, d = call(i)
        e = time.perf_counter()
        lat.append(e - s)
        disp.append(d)
        outs.append((i, got))
        i += 1
        if e - t0 >= ctx["seconds"]:
            break
    window_s = e - t0
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

    ref = reference_pool(config, traffic, seed, device, pool, shift)
    limits = ctx["limits"]
    worst = compare(outs, ref, batch, npool, icfg, ctx["score_margin"])
    if "box_gap_rel" in limits:
        drift = eight_bit_drift(config, traffic, seed, device, pool, shift,
                                ref, ctx["score_margin"])
        mean = worst["box_gap_mean"]
        worst["box_gap_rel"] = mean / drift if drift > 0 else (
            0.0 if mean == 0 else float("inf"))
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
              "peak": config["peak"], "shift": shift,
              "trace_calls": traffic["trace_calls"],
              "candidates_per_image": cands / len(ref),
              "numbers": worst},
        trace=trace, trace_window=window)
