"""The training loop with the feed on the card, as `train.py
--device_augment 1` runs it: each step draws `batch` images of a seeded
pool held on the card by a seeded permutation, runs the program's
`data/device_pipeline.preprocess_batch` (augmentation on the benchmark's
draws, z-score, label grids) and `parallel/train_step.make_train_step`'s
step (train-mode forward, loss, backward, Adam) at the warm-up learning
rate, and reads the step's metrics on the host, as the trainer does.

The pool: `pool` uint8 images of dark noise, each with 1-4 rectangles of
the two classes (red, green), `rect_px` a side, all from the seed. The
state starts from the training initialisation (`weights.make_weights
'train'`). Set-up drives that one state through the first
`checked_steps` steps of the window's own call, on disjoint batches,
then `warmup_steps` more; the window continues it.

`correct`: the float32 reference follows the checked steps from the same
weights, images, boxes and draws (`judge`'s loss, gradient, change,
feed and label numbers).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Tuple

import numpy as np
import torch

import devtrace
import judge
import weights as W
from loops.common import Run, generator, host_rng, model_dict, \
    program_config, report_setup
from reference import feed as RF
from reference import train as RT

MAX_BOXES = 4
_MODULES = {"darknet": "Darknet53_0", "yolo_blocks": "YoloBlock_{}",
            "necks": "ConvBlock_{}", "heads": "DetectionHead_{}",
            "blocks": "FeatureBlock_{}", "convs": "ConvBlock_{}"}
_LEAVES = {("conv", "weight"): "kernel", ("conv", "bias"): "bias",
           ("bn", "weight"): "scale", ("bn", "bias"): "offset"}


def leaf_key(name: str) -> Tuple[str, str]:
    """The program's parameter name -> (block path, leaf)."""
    parts = name.split(".")
    path, it = [], iter(parts[:-2])
    for p in it:
        fmt = _MODULES[p]
        path.append(fmt.format(next(it)) if "{}" in fmt else fmt)
    return "/".join(path), _LEAVES[(parts[-2], parts[-1])]


def make_pool(model: dict, traffic: dict, seed: int, device):
    """(images uint8 [n, H, W, C], boxes [n, M, 5] (x, y, w, h, class),
    valid [n, M]) on the device, from the seed."""
    n = traffic["pool"]
    h, w, c = model["img_size"]
    gen = generator(seed, device, stream=3)
    imgs = torch.randint(0, 96, (n, h, w, c), generator=gen, device=device,
                         dtype=torch.uint8)
    rng = host_rng(seed, stream=3)
    lo, hi = traffic["rect_px"]
    boxes = np.zeros((n, MAX_BOXES, 5), np.float32)
    valid = np.zeros((n, MAX_BOXES), bool)
    colour = torch.tensor([[220, 40, 40], [40, 220, 40]], dtype=torch.uint8,
                          device=device)
    for i in range(n):
        for k in range(int(rng.integers(1, MAX_BOXES + 1))):
            bw, bh = (int(v) for v in rng.integers(lo, min(hi, w, h) + 1, 2))
            x = int(rng.integers(0, w - bw + 1))
            y = int(rng.integers(0, h - bh + 1))
            cls = int(rng.integers(0, 2))
            imgs[i, y:y + bh, x:x + bw] = colour[cls, :c]
            boxes[i, k] = (x, y, bw, bh, cls)
            valid[i, k] = True
    return (imgs, torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def batch_order(n: int, batch: int, seed: int):
    """Endless batches of pool indices: each epoch a seeded permutation."""
    rng = host_rng(seed, stream=4)
    while True:
        perm = rng.permutation(n)
        for k in range(0, n - batch + 1, batch):
            yield torch.from_numpy(np.sort(perm[k:k + batch]))


def norms(tensors: Dict[Tuple[str, str], torch.Tensor]) -> Dict[str, float]:
    return {"/".join(k): float(t.float().norm()) for k, t in tensors.items()}


def half_batch(step):
    """A planted fault (the harness's tests and `control.py`): each step
    runs on the first half of its batch, its loss the mean over that
    half."""
    def part(state, batch, lr):
        n = batch[0].shape[0] // 2
        return step(state, tuple(t[:n] for t in batch), lr)
    return part


def run(ctx: dict, fault=None, int8_train: bool = False) -> Run:
    """One run of the cell; `fault(step)` may wrap the program's step (the
    harness's own tests), `int8_train` serves the control."""
    from yolov3_tpu_torch.config import AugmentConfig, TrainConfig
    from yolov3_tpu_torch.data.device_pipeline import (AugmentDraws,
                                                       preprocess_batch)
    from yolov3_tpu_torch.parallel.train_step import (create_train_state,
                                                      make_train_step)
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    model = model_dict(config)
    tc = config["train"]
    acfg = tc["augment"]
    batch = traffic["batch"]
    cfg = program_config(config, int8_train=int8_train)
    tcfg = TrainConfig(batch_size=batch, learning_rate=tc["learning_rate"],
                       warmup_lr_divisor=tc["warmup_lr_divisor"],
                       adam_b1=tc["adam_b1"], adam_b2=tc["adam_b2"],
                       adam_eps=tc["adam_eps"])
    lr = tc["learning_rate"] / tc["warmup_lr_divisor"]
    marks = [("start", time.perf_counter())]
    imgs, boxes, valid = make_pool(model, traffic, seed, device)
    marks.append(("pool", time.perf_counter()))
    wts = W.make_weights(model, seed, "train", device)
    params, stats = W.flax_trees(wts)
    del wts
    state = create_train_state(cfg, tcfg, params=params, batch_stats=stats,
                               device=device)
    del params, stats
    step = make_train_step(cfg, tcfg, batch)
    marks.append(("weights and state", time.perf_counter()))
    if fault is not None:
        step = fault(step)
    order = batch_order(traffic["pool"], batch, seed)
    gen = generator(seed, device, stream=5)
    aug = AugmentConfig(**acfg)
    rf = torch.profiler.record_function

    def call(keep=None):
        idx = next(order).to(device)
        with rf("bench.step_all"):
            with rf("bench.feed"):
                d = RF.make_draws(gen, batch, model["img_size"], MAX_BOXES,
                                  acfg)
                fed = preprocess_batch(
                    imgs[idx], boxes[idx], valid[idx], None, aug,
                    model["img_size"], model["anchors"],
                    model["number_classes"], True, draws=AugmentDraws(**d))
            if keep is not None:
                keep.append((idx.cpu(), {k: t.cpu() for k, t in d.items()},
                             tuple(t.cpu() for t in fed)))
            with rf("bench.step"):
                _, metrics = step(state, fed, lr)
                metrics = {k: float(v) for k, v in metrics.items()}
        return metrics

    checked, losses = [], []
    grad_norms = None
    for t in range(traffic["checked_steps"]):
        losses.append(call(checked)["loss"])
        if t == 0:
            b1 = tc["adam_b1"]
            opt = state.optimizer
            grad_norms = {}
            for name, p in state.model.named_parameters():
                st = opt.state.get(p, {})
                g = st["exp_avg"] / (1 - b1) if "exp_avg" in st else \
                    torch.zeros_like(p)
                grad_norms["/".join(leaf_key(name))] = float(g.norm())
    after = {leaf_key(n): p.detach().to("cpu", torch.float32).clone()
             for n, p in state.model.named_parameters()}
    marks.append(("checked steps", time.perf_counter()))
    for _ in range(traffic["warmup_steps"]):
        call()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    if device == "cuda":
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    steps = 0
    nan = False
    while True:
        m = call()
        nan |= not np.isfinite(m["loss"])
        steps += 1
        e = time.perf_counter()
        if e - t0 >= ctx["seconds"]:
            break
    window_s = e - t0
    report_setup(ctx["t_start"], marks)
    peak_window = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    trace = window = None
    if ctx["trace"]:
        trace = devtrace.profile(lambda k: call(), traffic["trace_steps"])
        window = trace.window("bench.step_all")
    peak = max(peak_setup, torch.cuda.max_memory_allocated()) \
        if device == "cuda" else 0
    del state, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the checked steps
    wts = W.make_weights(model, seed, "train", device)
    start = {k: t.detach().to("cpu", torch.float32).clone()
             for k, t in RT.leaves(wts).items()}
    ref_batches, feed_gap, label_diff = [], 0.0, 0
    for idx, d, fed in checked:
        idx = idx.to(device)
        d = {k: t.to(device) for k, t in d.items()}
        with torch.no_grad():
            ref = RF.preprocess(imgs[idx], boxes[idx], valid[idx], d, acfg,
                                model["img_size"], model["anchors"],
                                model["number_classes"])
        feed_gap = max(feed_gap, float((ref[0].cpu() - fed[0]).abs().max()))
        label_diff += sum(int((r.cpu() != f).sum())
                          for r, f in zip(ref[1:], fed[1:]))
        ref_batches.append(ref)
    ref_losses, ref_grads, ref_end = RT.train_steps(
        wts, model, ref_batches, lr, tc["adam_b1"], tc["adam_b2"],
        tc["adam_eps"])
    ref_change = norms({k: ref_end[k].cpu() - start[k] for k in start})
    prog_change = norms({k: after[k] - start[k] for k in start})
    ref_grads = {"/".join(k): v for k, v in ref_grads.items()}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if not all(np.isfinite(losses)):
        loss_gap = float("inf")
    grad_gap, grad_at = judge.norm_gaps(grad_norms, ref_grads)
    change_gap, change_at = judge.norm_gaps(
        prog_change, ref_change, judge.moved_leaves(ref_grads))
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap,
               "change_gap": change_gap, "feed_gap": feed_gap,
               "label_diff": float(label_diff)}
    limits = ctx["limits"]
    checks = [(k, numbers[k], limits[k]) for k in limits]
    return Run(
        correct=judge.held(checks) and not nan, attempted=steps, failed=0,
        end_to_end={"train_images_per_s": steps * batch / window_s,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak),
        info={"window_s": window_s, "images": steps * batch, "batch": batch,
              "steps": steps, "model": model, "peak": config["peak"],
              "peak_window_bytes": int(peak_window),
              "losses": losses, "ref_losses": ref_losses,
              "grad_at": grad_at, "change_at": change_at,
              "numbers": numbers},
        trace=trace, trace_window=window)
