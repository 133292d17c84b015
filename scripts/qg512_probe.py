#!/usr/bin/env python3
"""The 512 px quality gate (`python -m yolov3_tpu_torch.quality_gate_512`)
with a probe on every train step, on the card. The gate's own `main` runs
as it is; each step also records the largest |wh logit| and |objectness
logit| of the step's feature maps, the largest |gradient|, the smallest
BatchNorm running variance and the parameters whose gradient is not
finite, and the largest |wh logit| of the cells with an object.

    python3 scripts/qg512_probe.py [--steps 8000] [--every 50] \
        [--plain_region 1] [--f32_chain 1] [--mxu 1] [--seed 0] [--tf32 1] [--cut_after 1000] [--log FILE] \
        [gate arguments]

`--plain_region 1` trains the space-to-depth region's blocks in the
plain arithmetic (the conv with its bias, `F.leaky_relu`, the Flax-form
BatchNorm) instead of `_s2d_conv_block`'s (`ConvBlock.affine_bn`).

The other options are experiments on ROADMAP G1 (the port's bf16
training, every op in bf16, fails the gate), not the port's arithmetic:
- `--f32_chain 1`: one bf16 rounding a block: the conv's bf16 output
  goes to f32, and the bias, LeakyReLU and BatchNorm run in f32 before
  the block's output is rounded, as a fused XLA program may keep f32
  between the ops it fuses.
- `--mxu 1`: the TPU's arithmetic at its most precise: each conv as the
  MXU computes it (`mxu_conv`: the input and the kernel rounded to bf16,
  f32 sums, an f32 result; its VJP rounds the cotangent to bf16, the
  MXU's operand, and returns f32 gradients), and everything else in f32:
  the bias, Flax's LeakyReLU (`where(y >= 0, y, a * y)`), BatchNorm
  (`forward_affine` in the region's blocks), the residual sums and the
  heads. The QAT blocks keep their STE arithmetic.
`--seed` is the init seed of `init_train_params`; `--tf32 0` turns TF32
off in cuDNN's convolutions and in matmuls (for `--compute_dtype
float32`, a gate argument). Every step is one JSON line in `--log`;
every `--every`-th is printed, and at the end a summary line with the
lowest loss and the step of the first spike (a loss above twice the
lowest before it, once that lowest is under half the first loss).
`--cut_after N` stops a run whose loss has spiked and then stayed above
10 for N steps (0: never): it is recorded as failed (`error` "cut").
Other arguments (`--out`, `--device`, `--compute_dtype`) go to the gate;
the exit code is the gate's.

On the card `mxu_conv` is a TF32 convolution of bf16-valued f32 tensors:
TF32 holds a bf16 value without rounding, the product of two is exact in
f32, and the tensor cores accumulate in f32. That holds for cuDNN
algorithms that convolve the operands as given, not for one that
transforms them first (Winograd, FFT), so each shape's first call also
runs f64 and TF32 off (`route_errors`), and a shape where TF32 is less
exact than f32 (`tf32_is_exact`) runs TF32 off, with a warning. On the
CPU it is an f32 conv of the rounded values.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from yolov3_tpu_torch.models import yolo  # noqa: E402

BF16 = torch.bfloat16
# the card's route per (kind, device, x shape, w shape, stride): True
# where TF32 is as exact as f32
TF32_OK: dict = {}
MXU_TOL = 1e-5  # of the largest |value|: summation order alone


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 setting for the calls inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def route_errors(fn):
    """fn(dtype) -> convolutions of bf16-valued operands cast to dtype.
    Runs it in f64 (the exact sums, near enough) and in f32 with TF32 on
    and off; returns ({tf32: outputs}, {tf32: the largest |error| of an
    output against f64, over that output's largest |value|})."""
    exact = fn(torch.float64)
    outs, errs = {}, {}
    for tf32 in (True, False):
        with cudnn_tf32(tf32):
            outs[tf32] = fn(torch.float32)
        errs[tf32] = max(float((o.double() - e).abs().max()
                               / e.abs().max().clamp_min(1e-300))
                         for o, e in zip(outs[tf32], exact))
    return outs, errs


def tf32_is_exact(errs) -> bool:
    """TF32 is as close to the exact sums as the f32 conv is (within
    MXU_TOL, or twice the f32 conv's own error)."""
    return errs[True] <= max(MXU_TOL, 2 * errs[False])


def mxu_route(key, fn):
    """fn(torch.float32) under TF32 on the card, where `TF32_OK` allows
    (each shape checked at its first call, `route_errors`), else TF32
    off; in f32 on the CPU."""
    if key[1].type != "cuda":
        return fn(torch.float32)
    ok = TF32_OK.get(key)
    if ok is None:
        outs, errs = route_errors(fn)
        ok = TF32_OK[key] = tf32_is_exact(errs)
        if not ok:
            import warnings
            warnings.warn(f"mxu_conv: TF32 is not exact at {key} (errors "
                          f"{errs}); this shape runs TF32 off")
        return outs[ok]
    with cudnn_tf32(ok):
        return fn(torch.float32)


class MxuConv(torch.autograd.Function):
    """The MXU's conv: bf16 operands, f32 sums, an f32 result; the
    backward rounds the cotangent to bf16 and returns f32 gradients in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, w, stride):
        xb, wb = x.to(BF16), w.to(BF16)
        ctx.save_for_backward(xb, wb)
        ctx.stride = stride
        ctx.dtypes = (x.dtype, w.dtype)
        key = ("fwd", x.device, tuple(x.shape), tuple(w.shape), stride)
        return mxu_route(key, lambda dt: (yolo.conv2d_same(
            xb.to(dt), wb.to(dt), None, stride),))[0]

    @staticmethod
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        dyb = dy.to(BF16)
        key = ("bwd", dy.device, tuple(xb.shape), tuple(wb.shape),
               ctx.stride)
        dx, dw = mxu_route(key, lambda dt: yolo._conv_vjp(
            xb.to(dt), wb.to(dt), dyb.to(dt), ctx.stride))
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None


def mxu_conv(x, w, stride: int):
    """SAME conv (x NHWC, w OIHW, no bias) as a TPU computes a bf16
    `nn.Conv` with XLA's excess precision (see `MxuConv`)."""
    return MxuConv.apply(x, w, stride)


def arithmetic_patches(f32_chain=False, mxu=False):
    """The experiments' bf16 train arithmetic as (class, attribute,
    function) patches of `models/yolo.py` (see the docstring)."""
    conv_forward = yolo.ConvBlock.forward
    head_forward = yolo.DetectionHead.forward

    def plain(block):
        return (not block.training or block.int8_ste
                or block.dtype != BF16)

    def f32_chain_forward(self, x):
        if plain(self) or self.affine_bn:
            return conv_forward(self, x)
        conv = self.conv
        y = yolo.conv2d_same(x.to(BF16), conv.weight.to(BF16), None,
                             self.stride).float() + conv.bias.to(BF16).float()
        y = F.leaky_relu(y, self.alpha)
        return self.bn.forward_train(y).to(BF16)

    def mxu_forward(self, x):
        if plain(self):
            return conv_forward(self, x)
        y = mxu_conv(x, self.conv.weight, self.stride) + self.conv.bias
        y = torch.where(y >= 0, y, self.alpha * y)
        bn = self.bn.forward_affine if self.affine_bn else self.bn.forward_train
        return bn(y)

    def mxu_head_forward(self, x):
        if not self.training or self.dtype != BF16:
            return head_forward(self, x)
        return mxu_conv(x, self.conv.weight, 1) + self.conv.bias

    patches = []
    if f32_chain:
        patches.append((yolo.ConvBlock, "forward", f32_chain_forward))
    if mxu:
        patches += [(yolo.ConvBlock, "forward", mxu_forward),
                    (yolo.DetectionHead, "forward", mxu_head_forward)]
    return patches


@contextlib.contextmanager
def patched(patches):
    """`patches` applied inside, the classes restored after."""
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    for cls, name, fn in patches:
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for cls, name, fn in reversed(saved):
            setattr(cls, name, fn)


class Cut(Exception):
    """A run stopped by `--cut_after`."""


def first_spike(rows):
    """The step of the first loss above twice the lowest before it, once
    that lowest is under half the first loss; None if there is none."""
    lowest = float("inf")
    for r in rows:
        if lowest < 0.5 * rows[0]["loss"] and not r["loss"] <= 2 * lowest:
            return r["step"]
        lowest = min(lowest, r["loss"])
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--every", type=int, default=50)
    p.add_argument("--plain_region", type=int, default=0)
    p.add_argument("--f32_chain", type=int, default=0)
    p.add_argument("--mxu", type=int, default=0)
    p.add_argument("--cut_after", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tf32", type=int, default=1)
    p.add_argument("--log", default="chiprun_out/qg512_probe.jsonl")
    args, gate_args = p.parse_known_args(argv)

    if not args.tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    from yolov3_tpu_torch import quality_gate_512 as gate
    from yolov3_tpu_torch.models.yolo import BatchNorm, ConvBlock
    from yolov3_tpu_torch.parallel import train_step as T

    for cls, name, fn in arithmetic_patches(f32_chain=args.f32_chain,
                                            mxu=args.mxu):
        setattr(cls, name, fn)

    make_state, make_step = T.create_train_state, T.make_train_step
    fms, rows = [], []

    def create_train_state(cfg, *a, **kw):
        state = make_state(cfg, *a, **kw)
        if args.plain_region:
            for m in state.model.modules():
                if isinstance(m, ConvBlock):
                    m.affine_bn = False
        state.model.register_forward_hook(
            lambda m, inputs, out: fms.__setitem__(slice(None), out))
        return state

    def make_train_step(cfg, *a, **kw):
        step = make_step(cfg, *a, **kw)
        per_anchor = 5 + cfg.number_classes

        def probed(state, batch, lr):
            state, metrics = step(state, batch, lr)
            model = state.model
            names, grads = zip(*[(n, q.grad) for n, q in
                                 model.named_parameters()
                                 if q.grad is not None])
            maps = [f.detach().float().reshape(
                *f.shape[:3], cfg.number_anchors, per_anchor) for f in fms]
            var = torch.cat([m.running_var.reshape(-1)
                             for m in model.modules()
                             if isinstance(m, BatchNorm)])
            g = torch.stack(torch._foreach_norm(grads, float("inf")))
            # the object cells' wh logits: past ln(1e9 / anchor) ~ 16.2
            # the loss's clip fixes exp(t) * anchor and zeroes its gradient
            wh_obj = torch.stack([torch.where(
                grid[..., 4] > 0, f[..., 2:4].abs().amax(-1), 0.0).max()
                for f, grid in zip(maps, batch[1:])]).max()
            head = torch.stack([
                metrics["loss"].float(),
                torch.stack([f[..., 2:4].abs().max() for f in maps]).max(),
                torch.stack([f[..., 4].abs().max() for f in maps]).max(),
                var.min(), wh_obj]).float()
            values = torch.cat([head, g.float()]).tolist()
            loss, wh, obj, var_min, wh_obj = values[:5]
            g = values[5:]
            bad = [n for n, v in zip(names, g) if not v == v or v == float(
                "inf")]
            row = {"step": len(rows), "lr": lr, "loss": loss,
                   "wh_logit": wh, "wh_logit_objects": wh_obj,
                   "obj_logit": obj,
                   "grad": max(v for v in g if v == v), "min_running_var":
                   var_min, "nonfinite_grads": bad[:3]}
            rows.append(row)
            log.write(json.dumps(row) + "\n")
            if row["step"] % args.every == 0 or bad:
                print("probe " + json.dumps(row), flush=True)
            if (args.cut_after and len(rows) % 50 == 0
                    and first_spike(rows) is not None
                    and len(rows) >= args.cut_after and all(
                        r["loss"] > 10 for r in rows[-args.cut_after:])):
                raise Cut(f"cut at step {row['step']}: loss above 10 for "
                          f"{args.cut_after} steps after its spike")
            return state, metrics
        return probed

    T.create_train_state, T.make_train_step = create_train_state, \
        make_train_step
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    error = None
    with open(args.log, "w") as log:
        try:
            rc = gate.main(["--steps", str(args.steps), "--seed",
                            str(args.seed)] + gate_args)
        except (RuntimeError, Cut) as e:  # the gate's non-finite loss
            rc, error = 1, str(e)
        finally:
            T.create_train_state, T.make_train_step = make_state, make_step
    first_80 = next((r["step"] for r in rows if r["wh_logit"] > 80), None)
    lowest = min((r["loss"] for r in rows), default=float("inf"))
    spike = first_spike(rows)
    worst = max(rows[len(rows) // 2:], key=lambda r: r["loss"],
                default=None)
    print("probe summary " + json.dumps({
        "plain_region": bool(args.plain_region),
        "f32_chain": bool(args.f32_chain), "mxu": bool(args.mxu),
        "seed": args.seed,
        "tf32": bool(args.tf32), "steps": len(rows), "lowest_loss": lowest,
        "first_spike_step": spike, "error": error,
        "first_step_wh_logit_over_80": first_80,
        "at": {s: rows[s] for s in (100, 250, 500, 1000, 2500, 5000)
               if s < len(rows)},
        "worst_loss_in_second_half": worst}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
