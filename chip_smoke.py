#!/usr/bin/env python3
"""Drive the PyTorch port (`yolov3_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, in order; any failure exits non-zero:
  1. Print the card's name and power limit; build the CUDA kernels from
     `yolov3_tpu_torch/csrc/` with nvcc, all at once.
  2. Reference check at 64 px, full width, f32: the port on the card
     (plain path, and 1x1 blocks through the kernel) against the port's
     plain path on the CPU.
  3. Full-width bf16 serving (512 px, batch 8, 1024 filters, 8 blocks,
     `use_pallas_pointwise`), weights from `init_params` (a seed) through
     the exported artifact and `params_from_jax`. The launch counters are
     set to 0 just before one `make_serving_fn` call and read just after:
     the 1x1 kernel must launch 34 times and the NMS kernel once. Then
     images/s over repeated calls, and device time by kernel over three
     calls under torch.profiler.
  4. Each kernel against its plain version on the inputs the serving call
     handed it (recorded on a warm-up call), plus the NMS kernel at the
     batch-64 shapes (C = 128, K = 512), saturated and sparse: NMS keep
     masks bit-equal, the 1x1 block within rtol = atol = 2e-2 in bf16.
     Times from CUDA events after warm-up, beside each call's bound.
  5. The CLI's per-batch function on 4 uint8 images; CSVs in both layouts.
  6. One JSON line of kernel results, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 non-tensor operations/s
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
F32_OPS_S = 67e12
# f32 operations of one IoU test in the NMS recurrence: 4 min/max, 2 sub,
# 2 clamp, 1 mul, 1 add, 1 sub, 1 div, 1 compare. The function tests each
# valid candidate i only against the kept j < i.
IOU_OPS = 13

FULL = dict(img_size=(512, 512, 3), number_classes=2,
            anchors=((64, 384), (384, 64)), filter_count=1024, block_count=8,
            compute_dtype="bfloat16", use_pallas_pointwise=True)
BATCH = 8
SEED = 0
DEVICE = "cuda"
# launches of one serving call at FULL: FeatureBlocks 1+2+8+8+4 1x1s,
# three YoloBlocks of three 1x1s and two neck 1x1s; one NMS launch
EXPECTED_LAUNCHES = {"pointwise_conv_block": 34, "nms_suppress": 1}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def record(module, name, store):
    """Wrap `module.name` so every call's arguments land in `store`;
    returns the function to put back."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        store.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    return orig


def phase_reference(torch, ckpt, ModelConfig):
    """64 px, full width, f32: card vs CPU, kernel path vs plain path."""
    import numpy as np
    out = {}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3), dtype=np.float32))
    for flag in (False, True):
        cfg = ModelConfig(**dict(FULL, img_size=(64, 64, 3),
                                 compute_dtype="float32",
                                 use_pallas_pointwise=flag))
        params, stats = ckpt.init_params(cfg, SEED)
        with torch.inference_mode():
            cpu = ckpt.build_model(params, stats, cfg, "cpu").backbone(x)
            gpu = ckpt.build_model(params, stats, cfg, DEVICE).backbone(
                x.to(DEVICE))
        err = max(float(((g.cpu() - c).abs() / c.abs().clamp_min(1.0)).max())
                  for g, c in zip(gpu, cpu))
        out["kernel" if flag else "plain"] = err
        log(f"reference 64px f32 full width, use_pallas_pointwise={flag}: "
            f"max |card - cpu| / max(|cpu|, 1) = {err:.3e}")
    # plain f32 on both sides: only the summation order differs; with the
    # kernel, both sides round the 1x1 operands to bf16 (the JAX kernel's
    # bound, tests/test_pallas_conv_block.py::test_full_model_flag)
    if not (out["plain"] < 1e-3 and out["kernel"] < 5e-2):
        raise AssertionError(f"card disagrees with the CPU reference: {out}")
    return out


def phase_serving(torch, ckpt, inf, build, ModelConfig, InferenceConfig,
                  workdir, card):
    import numpy as np
    from yolov3_tpu_torch.ops.kernels import conv_block, nms_suppress

    cfg = ModelConfig(**FULL)
    params, stats = ckpt.init_params(cfg, SEED)
    path = ckpt.export_model(workdir, params, stats, cfg)
    serve, _ = inf.make_serving_fn(path, device=DEVICE)
    images = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, *cfg.img_size), dtype=np.float32)).to(DEVICE)

    # warm-up call that records what the path hands each kernel
    calls = {"pw": [], "nms": []}
    orig_pw = record(conv_block, "pointwise_conv_block", calls["pw"])
    orig_nms = record(nms_suppress, "suppress_boxes_t", calls["nms"])
    try:
        serve(images)
    finally:
        conv_block.pointwise_conv_block = orig_pw
        nms_suppress.suppress_boxes_t = orig_nms
    torch.cuda.synchronize()
    recorded = {"pointwise_conv_block": len(calls["pw"]),
                "nms_suppress": len(calls["nms"])}
    if recorded != EXPECTED_LAUNCHES:
        raise AssertionError(f"recorded kernel calls {recorded} != "
                             f"{EXPECTED_LAUNCHES}")

    build.launch_counts.clear()
    boxes, scores, keep = serve(images)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"serving b{BATCH} 512px bf16 launches: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"expected launches {EXPECTED_LAUNCHES}, got "
                             f"{launches}")
    k = min(InferenceConfig().max_boxes_per_class, cfg.number_output_boxes)
    for t, shape in ((boxes, (BATCH, 2, k, 4)), (scores, (BATCH, 2, k)),
                     (keep, (BATCH, 2, k))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"output shape {tuple(t.shape)} != {shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("serving output is not finite")
    kept = int(keep.sum())
    if kept == 0:
        raise AssertionError("serving kept no detection")

    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve(images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    log(f"serving b{BATCH} 512px bf16 (kernels on): {dt * 1e3:.3f} ms/batch, "
        f"{BATCH / dt:.2f} images/s, {kept} boxes kept, on {card}")
    serving = {"batch": BATCH, "ms_per_batch": dt * 1e3,
               "images_per_s": BATCH / dt, "kept": kept,
               "profile": phase_profile(torch, serve, images)}
    return path, calls, launches, serving


def phase_profile(torch, serve, images, reps=3, top=15):
    """Device time by kernel over `reps` serving calls (torch.profiler),
    and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            serve(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events) / reps
    log(f"profile {reps} serving calls: wall {wall_ms:.3f} ms, device busy "
        f"{total:.3f} ms ({100 * total / wall_ms:.1f}%), {ops:.0f} device "
        f"ops per call")
    rows = []
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / reps
        rows.append({"name": e.key, "ms_per_call": ms, "count": e.count / reps})
        log(f"profile  {ms:9.4f} ms/call  x{e.count / reps:6.1f}  {e.key[:90]}")
    return {"wall_ms": wall_ms / reps, "device_ms": total / reps,
            "device_ops_per_call": ops, "top": rows}


def phase_pointwise(torch, calls):
    """Kernel 2 vs its plain version and the library yardstick on every
    recorded call; per-forward sums."""
    import torch.nn.functional as F
    from yolov3_tpu_torch.ops.kernels import conv_block as K

    rows, max_err = [], 0.0
    for args, _ in calls:
        x, w, b, mul, add, alpha, out_dtype = args
        m, ci = x.shape
        co = w.shape[1]
        got = K.pointwise_conv_block(x, w, b, mul, add, alpha, out_dtype)
        want = K.pointwise_conv_block_plain(x, w, b, mul, add, alpha,
                                            out_dtype)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))

        def library():
            y = torch.matmul(x, w).float() + b
            return (F.leaky_relu(y, alpha) * mul + add).to(out_dtype)

        ms = cuda_ms(lambda: K.pointwise_conv_block(x, w, b, mul, add, alpha,
                                                    out_dtype), 20)
        plain = cuda_ms(lambda: K.pointwise_conv_block_plain(
            x, w, b, mul, add, alpha, out_dtype), 5)
        lib = cuda_ms(library, 20)
        out_bytes = torch.finfo(out_dtype).bits // 8
        nbytes = (m * ci + ci * co) * 2 + 3 * co * 4 + m * co * out_bytes
        ops = 2 * m * ci * co + 5 * m * co
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_S)
        rows.append(dict(m=m, ci=ci, co=co, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=ops))
        log(f"pointwise_conv_block M={m} Ci={ci} Co={co}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {ops / ms / 1e9:.1f} TFLOP/s")
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_S
    t_ops = sum(r["ops"] for r in rows) / BF16_OPS_S
    summary = dict(ms=sum(r["ms"] for r in rows),
                   plain_ms=sum(r["plain_ms"] for r in rows),
                   library_ms=sum(r["library_ms"] for r in rows),
                   bound_ms=sum(r["bound_ms"] for r in rows),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max_err)
    log(f"pointwise_conv_block per forward ({len(rows)} launches): "
        f"kernel {summary['ms']:.3f} ms, plain {summary['plain_ms']:.3f} ms, "
        f"library {summary['library_ms']:.3f} ms, bound "
        f"{summary['bound_ms']:.3f} ms")
    return summary, rows


def nms_case(torch, cand, valid, label):
    from yolov3_tpu_torch.ops.kernels import nms_suppress as K
    got = K.suppress_boxes_t(cand, valid, 0.3)
    want = K.suppress_boxes_plain(cand, valid, 0.3)
    err = float((got.int() - want.int()).abs().max())
    if err != 0:
        raise AssertionError(f"NMS kernel keep mask differs ({label}): "
                             f"{int((got != want).sum())} slots")
    ms = cuda_ms(lambda: K.suppress_boxes_t(cand, valid, 0.3), 20)
    plain = cuda_ms(lambda: K.suppress_boxes_plain(cand, valid, 0.3), 2, 1)
    c, k = valid.shape
    kept = want.to(torch.float64)
    pairs = float(((kept.cumsum(dim=1) - kept) * valid).sum())
    b_ms, b_by = bound(c * k * (16 + 1 + 1), pairs * IOU_OPS, F32_OPS_S)
    log(f"nms_suppress {label} C={c} K={k} valid={int(valid.sum())}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}, "
        f"{pairs:.0f} IoU tests), keep bit-equal ({int(got.sum())} kept)")
    return dict(label=label, c=c, k=k, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, iou_tests=pairs, max_abs_err=err)


def phase_nms(torch, calls):
    import numpy as np
    (cand, valid, _), _ = calls[0]
    rows = [nms_case(torch, cand, valid, f"serving b{BATCH}")]
    rng = np.random.default_rng(3)
    c, k = 128, 512
    xy = rng.random((c, k, 2), np.float32) * 400
    wh = rng.random((c, k, 2), np.float32) * 100 + 5
    cand = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(DEVICE)
    counts = torch.from_numpy(rng.integers(0, k + 1, c)).to(DEVICE)
    sparse = torch.arange(k, device=DEVICE)[None, :] < counts[:, None]
    rows.append(nms_case(torch, cand, torch.ones_like(sparse),
                         "b64 saturated"))
    rows.append(nms_case(torch, cand, sparse.contiguous(), "b64 sparse"))
    return rows


def phase_cli(torch, inf, InferenceConfig, path, workdir):
    import numpy as np
    detect, cfg = inf.make_detector_fn(path, device=DEVICE)
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, cfg.img_size, dtype=np.uint8)
              for _ in range(4)]
    rows, scores = inf.detect_images(images, detect, cfg.number_classes,
                                     InferenceConfig(), 32, device=DEVICE)
    for i, (r, s) in enumerate(zip(rows, scores)):
        for save_scores, header in ((False, "X,Y,W,H,C"),
                                    (True, "X,Y,W,H,P,C")):
            out = os.path.join(workdir, f"im{i}_{int(save_scores)}.csv")
            inf.write_detections_csv(r, s, out, save_scores)
            with open(out) as fh:
                lines = fh.read().splitlines()
            if lines[0] != header or len(lines) != r.shape[0] + 1:
                raise AssertionError(f"bad CSV {out}: {lines[:2]}")
    n = [r.shape[0] for r in rows]
    log(f"CLI per-batch function: 4 images, rows per image {n}, CSVs ok")
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the detailed results to this JSON")
    args = parser.parse_args(argv)

    sys.path.insert(0, HERE)
    import torch
    if not os.path.isdir(os.path.join(HERE, "yolov3_tpu_torch")):
        print("chip_smoke: the yolov3_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yolov3_tpu_torch import inference as inf
    from yolov3_tpu_torch.config import InferenceConfig, ModelConfig
    from yolov3_tpu_torch.ops.kernels import _build as build
    from yolov3_tpu_torch.utils import checkpoint as ckpt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    result = {"card": smi, "reference": phase_reference(torch, ckpt,
                                                         ModelConfig)}
    with tempfile.TemporaryDirectory() as workdir:
        path, calls, launches, serving = phase_serving(
            torch, ckpt, inf, build, ModelConfig, InferenceConfig, workdir,
            smi)
        result["serving"] = serving
        with torch.inference_mode():
            pw, pw_rows = phase_pointwise(torch, calls["pw"])
            nms_rows = phase_nms(torch, calls["nms"])
        del calls
        result["cli_rows"] = phase_cli(torch, inf, InferenceConfig, path,
                                       workdir)
    result["pointwise_calls"] = pw_rows
    result["nms_cases"] = nms_rows

    nms = nms_rows[0]
    kernels = [
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/nms_suppress.cu",
         "replaces": "yolov3_tpu/ops/pallas/nms_kernel.py:191",
         "launches": launches["nms_suppress"],
         "max_abs_err": max(r["max_abs_err"] for r in nms_rows),
         "ms": nms["ms"], "plain_ms": nms["plain_ms"],
         "bound_ms": nms["bound_ms"], "bound_by": nms["bound_by"],
         "library_ms": None},
        {"name": "pointwise_conv_block", "route": "cuda",
         "source": "yolov3_tpu_torch/csrc/pointwise_conv_block.cu",
         "replaces": "yolov3_tpu/ops/pallas/conv_block_kernel.py:68",
         "launches": launches["pointwise_conv_block"],
         "max_abs_err": pw["max_abs_err"], "ms": pw["ms"],
         "plain_ms": pw["plain_ms"], "bound_ms": pw["bound_ms"],
         "bound_by": pw["bound_by"], "library_ms": pw["library_ms"]},
    ]
    for kern in kernels:
        for key, v in kern.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{kern['name']} {key} = {v}")
    result["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
