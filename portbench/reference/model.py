"""Plain PyTorch reference of the YOLOv3 detector the benchmark serves
and trains: Darknet-53 backbone and three-scale FPN heads
(usnistgov/object-detection-yolov3 `model.py`), written from the
architecture alone and importing nothing of the program.

Weights are a flat dict keyed by block path (`Darknet53_0/ConvBlock_0`,
`YoloBlock_2/ConvBlock_5`, `DetectionHead_1`): a conv block holds
`kernel` (OIHW), `bias`, `scale`, `offset`, `mean`, `var`; a head
`kernel` and `bias`. Activations are NHWC.

The block is Conv(SAME, bias) -> LeakyReLU(0.2) -> BatchNorm(eps 1e-3); a
FeatureBlock adds its ORIGINAL input at every repetition; a stride-2 conv
pads one row and column at the bottom and right only (XLA's SAME); the
FPN concatenates [upsample(y), route].

Four arithmetics run over one wiring (`forward`):
- `Float`: every conv, bias, activation and normalisation in float32,
  on the bf16 image the model takes;
- `Bf16Serve`: bf16 serving, at the precision's own rounding points;
- `Bf16Mode`: the int8 serving program's calibration arithmetic, the bf16
  conv rounded to bf16, the folded epilogue in float32 and its output
  rounded to bf16; it records each quantized conv's input absmax;
- `Quant`: post-training quantization at `bits` (8, or 4 for the
  control): per-tensor activation scales from `Bf16Mode`'s absmax,
  per-output-channel weight scales, integer sums, the epilogue
  leaky(acc + b/dq) * (mul*dq) + add in float32, bf16 outputs; a
  feature block's residual is the dequantized code of its input; stem1
  and the heads stay bf16.
Every float32 conv runs with TF32 off (`no_tf32`): integer codes and
their products are exact there, and the sums stay below 2^24.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
BF16 = torch.bfloat16
STEM1 = "Darknet53_0/ConvBlock_0"


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convs at float32, restored afterwards."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# --- the architecture ---------------------------------------------------------

def conv_specs(model: dict) -> List[Tuple[str, int, int, int, int]]:
    """(block path, in channels, out channels, kernel, stride) of every conv
    block, then every head (path `DetectionHead_k`), in forward order."""
    fc, bc, k = model["filter_count"], model["block_count"], model["kernel_size"]
    ci = model["img_size"][2]
    out = model["number_anchors"] * (5 + model["number_classes"])
    widths = [fc // 32, fc // 16, fc // 8, fc // 4, fc // 2, fc]
    chans = [ci] + widths
    reps = [1, 2, bc, bc, bc // 2]
    d = "Darknet53_0"
    specs = [(f"{d}/ConvBlock_0", chans[0], chans[1], k, 1)]
    for i, (r, wd) in enumerate(zip(reps, widths[1:])):
        specs.append((f"{d}/ConvBlock_{i + 1}", chans[i + 1], wd, k, 2))
        for j in range(r):
            fb = f"{d}/FeatureBlock_{i}"
            specs.append((f"{fb}/ConvBlock_{2 * j}", wd, wd // 2, 1, 1))
            specs.append((f"{fb}/ConvBlock_{2 * j + 1}", wd // 2, wd, k, 1))
    f8, f16, f32 = fc // 4, fc // 2, fc
    for y, (cin, feat) in enumerate(((f32, f32), (2 * f16, f16),
                                     (2 * f8, f8))):
        chs = [cin, feat // 2, feat, feat // 2, feat, feat // 2, feat]
        for i in range(6):
            specs.append((f"YoloBlock_{y}/ConvBlock_{i}", chs[i], chs[i + 1],
                          1 if i % 2 == 0 else k, 1))
        if y < 2:
            specs.append((f"ConvBlock_{y}", feat // 2, feat // 2, 1, 1))
    for h, f in enumerate((f32, f16, f8)):
        specs.append((f"DetectionHead_{h}", f, out, 1, 1))
    return specs


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA/TF SAME padding (the end gets the odd pixel)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC x, OIHW w -> NHWC float32 SAME conv, no bias."""
    k = w.shape[-1]
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], k, stride))
    xn = F.pad(x.permute(0, 3, 1, 2).to(F32), (pl, pr, pt, pb))
    return F.conv2d(xn, w.to(F32), None, stride).permute(0, 2, 3, 1)


def leaky(y: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(y >= 0, y, alpha * y)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def bn_affine(p: dict, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    mul = p["scale"].to(F32) * torch.rsqrt(p["var"].to(F32) + eps)
    return mul, p["offset"].to(F32) - p["mean"].to(F32) * mul


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to float32."""
    return t.to(BF16).to(F32)


# --- arithmetics ----------------------------------------------------------------

class Float:
    """Every step in float32, from the image as a bf16 model takes it
    (its z-scored pixels rounded to bf16)."""

    def __init__(self, weights: dict, model: dict):
        self.w, self.alpha, self.eps = (weights, model["leaky_relu_alpha"],
                                        model["bn_epsilon"])

    def image(self, x):
        return bf16(x)

    def block(self, name, x, stride):
        p = self.w[name]
        y = leaky(conv_same(x, p["kernel"], stride) + p["bias"].to(F32),
                  self.alpha)
        mul, add = bn_affine(p, self.eps)
        return y * mul + add

    def block_cat(self, name, a, b):
        return self.block(name, torch.cat([a, b], dim=-1), 1)

    def residual(self, name, x):
        """(the feature block's input as convs see it, its residual)."""
        return x, x

    def add(self, a, b):
        return a + b

    def head(self, name, x):
        p = self.w[name]
        return conv_same(x, p["kernel"], 1) + p["bias"].to(F32)


class Bf16Mode(Float):
    """The calibration arithmetic: bf16 convs, float32 epilogue, bf16
    outputs; records each quantized block's input absmax in `absmax`."""

    def __init__(self, weights: dict, model: dict, skip=(STEM1,)):
        super().__init__(weights, model)
        self.skip = frozenset(skip)
        self.absmax: Dict[str, float] = {}

    def image(self, x):
        return bf16(x)

    def _record(self, name, *ts):
        if name in self.skip:
            return
        m = max(float(t.abs().max()) for t in ts)
        self.absmax[name] = max(self.absmax.get(name, 0.0), m)

    def block(self, name, x, stride):
        self._record(name, x)
        p = self.w[name]
        y = bf16(conv_same(x, bf16(p["kernel"]), stride))
        y = leaky(y + p["bias"].to(F32), self.alpha)
        mul, add = bn_affine(p, self.eps)
        return bf16(y * mul + add)

    def block_cat(self, name, a, b):
        """Two bf16 convs over the split kernel, summed in float32."""
        self._record(name, a, b)
        p = self.w[name]
        ca = a.shape[-1]
        k = bf16(p["kernel"])
        y = (bf16(conv_same(a, k[:, :ca], 1))
             + bf16(conv_same(b, k[:, ca:], 1)))
        y = leaky(y + p["bias"].to(F32), self.alpha)
        mul, add = bn_affine(p, self.eps)
        return bf16(y * mul + add)

    def add(self, a, b):
        return bf16(a + b)

    def head(self, name, x):
        p = self.w[name]
        return bf16(conv_same(x, bf16(p["kernel"]), 1)
                    + bf16(p["bias"]))


class Bf16Serve(Float):
    """The bf16 serving arithmetic: activations, residuals and heads in
    bf16; a 3x3 or stride-2 block's conv and bias in bf16 (float32 sums),
    LeakyReLU in bf16, BatchNorm in float32 as (x - mean) * mul + offset,
    mul = scale * rsqrt(var + eps), cast to bf16; with
    `use_pallas_pointwise` a 1x1 block as one float32 product of its bf16
    operands, then leaky(acc + b) * mul + add in float32, mul = scale /
    sqrt(var + eps), cast to bf16."""

    def __init__(self, weights: dict, model: dict):
        super().__init__(weights, model)
        self.fused = model["use_pallas_pointwise"]

    def image(self, x):
        return x.to(BF16)

    def block(self, name, x, stride):
        p = self.w[name]
        x = x.to(BF16)
        k = p["kernel"].shape[-1]
        if self.fused and k == 1 and stride == 1:
            n, h, w, ci = x.shape
            acc = x.reshape(-1, ci).to(F32) @ bf16(p["kernel"][:, :, 0, 0]).t()
            y = leaky(acc + p["bias"].to(F32), self.alpha)
            mul = p["scale"].to(F32) / torch.sqrt(p["var"].to(F32) + self.eps)
            add = p["offset"].to(F32) - p["mean"].to(F32) * mul
            return (y * mul + add).to(BF16).reshape(n, h, w, -1)
        y = F.leaky_relu(_conv_bf16(x, p["kernel"], p["bias"], stride),
                         self.alpha)
        mul, add = bn_affine(p, self.eps)
        return ((y.to(F32) - p["mean"].to(F32)) * mul
                + p["offset"].to(F32)).to(BF16)

    def block_cat(self, name, a, b):
        return self.block(name, torch.cat([a, b], dim=-1), 1)

    def add(self, a, b):
        return a.to(BF16) + b.to(BF16)

    def head(self, name, x):
        p = self.w[name]
        return _conv_bf16(x.to(BF16), p["kernel"], p["bias"], 1)


def _conv_bf16(x, w, b, stride):
    """NHWC SAME conv of bf16 operands, bias included, in bf16."""
    k = w.shape[-1]
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], k, stride))
    xn = x.permute(0, 3, 1, 2)
    w, b = w.to(BF16), b.to(BF16)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, b, stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, b, stride)
    return y.permute(0, 2, 3, 1)


def f32_scale(absmax: float, levels: int) -> float:
    """An activation scale as float32: max(absmax, 1e-12) / levels."""
    return float(np.float32(max(absmax, 1e-12) / levels))


class Quant(Bf16Mode):
    """Post-training quantization at `bits` with the activation scales
    `scales` {block: float32 scale} (from `calibrate`)."""

    def __init__(self, weights: dict, model: dict, scales: Dict[str, float],
                 bits: int = 8, skip=(STEM1,)):
        super().__init__(weights, model, skip)
        self.levels = 2 ** (bits - 1) - 1
        self.scales = scales
        self._folded: Dict[str, tuple] = {}

    def _record(self, name, *ts):
        pass

    def quantize(self, x, name):
        inv = float(np.float32(1.0) / np.float32(self.scales[name]))
        return torch.clamp(torch.round(x.to(F32) * inv), -self.levels,
                           self.levels)

    def fold(self, name):
        """(integer weight codes OIHW, b/dq, mul*dq, add) of a block."""
        if name not in self._folded:
            p = self.w[name]
            w = p["kernel"].to(F32)
            absmax = w.abs().amax(dim=(1, 2, 3))
            sw = torch.where(absmax > 0, absmax,
                             torch.full_like(absmax, float(self.levels))
                             ) / self.levels
            wq = torch.clamp(torch.round(w / sw[:, None, None, None]),
                             -self.levels, self.levels)
            dq = sw * float(np.float32(self.scales[name]))
            mul, add = bn_affine(p, self.eps)
            self._folded[name] = (wq, p["bias"].to(F32) / dq, mul * dq, add)
        return self._folded[name]

    def _int_block(self, name, q, stride):
        wq, b, m, a = self.fold(name)
        acc = conv_same(q, wq, stride)
        if float(acc.abs().max()) >= 2 ** 24:
            raise ArithmeticError(f"{name}: a sum passed 2^24, float32 is "
                                  "no longer exact")
        return bf16(leaky(acc + b, self.alpha) * m + a)

    def block(self, name, x, stride):
        if name in self.skip:
            return super().block(name, x, stride)
        return self._int_block(name, self.quantize(x, name), stride)

    def block_cat(self, name, a, b):
        q = torch.cat([self.quantize(a, name), self.quantize(b, name)], -1)
        return self._int_block(name, q, 1)

    def residual(self, name, x):
        q = self.quantize(x, name)
        return q, bf16(q * np.float32(self.scales[name]))

    def block_codes(self, name, q, stride):
        """A block on its input's codes (the feature block's first 1x1)."""
        return self._int_block(name, q, stride)


# --- the wiring -------------------------------------------------------------------

def _feature_block(ar, fb: str, reps: int, x):
    """Each repetition adds the block's ORIGINAL input (its dequantized
    codes under `Quant`)."""
    if isinstance(ar, Quant):
        q, inputs = ar.residual(f"{fb}/ConvBlock_0", x)
        y = ar.block_codes(f"{fb}/ConvBlock_0", q, 1)
        x = ar.add(inputs, ar.block(f"{fb}/ConvBlock_1", y, 1))
        start = 1
    else:
        inputs, start = x, 0
    for j in range(start, reps):
        y = ar.block(f"{fb}/ConvBlock_{2 * j}", x, 1)
        x = ar.add(inputs, ar.block(f"{fb}/ConvBlock_{2 * j + 1}", y, 1))
    return x


def _yolo_block(ar, yb: str, x, skip=None):
    if skip is None:
        x = ar.block(f"{yb}/ConvBlock_0", x, 1)
    else:
        x = ar.block_cat(f"{yb}/ConvBlock_0", x, skip)
    for i in range(1, 5):
        x = ar.block(f"{yb}/ConvBlock_{i}", x, 1)
    return x, ar.block(f"{yb}/ConvBlock_5", x, 1)


def forward(ar, model: dict, images: torch.Tensor) -> List[torch.Tensor]:
    """z-scored NHWC images -> the three heads' feature maps (strides 32,
    16, 8) in float32, under the arithmetic `ar`."""
    bc = model["block_count"]
    reps = [1, 2, bc, bc, bc // 2]
    d = "Darknet53_0"
    x = ar.block(f"{d}/ConvBlock_0", ar.image(images), 1)
    routes = []
    for i, r in enumerate(reps):
        x = ar.block(f"{d}/ConvBlock_{i + 1}", x, 2)
        x = _feature_block(ar, f"{d}/FeatureBlock_{i}", r, x)
        routes.append(x)
    route_s8, route_s16, route_s32 = routes[2:]
    route, y = _yolo_block(ar, "YoloBlock_0", route_s32)
    fms = [ar.head("DetectionHead_0", y)]
    for i, skip in enumerate((route_s16, route_s8)):
        y = upsample_2x(ar.block(f"ConvBlock_{i}", route, 1))
        route, y = _yolo_block(ar, f"YoloBlock_{i + 1}", y, skip)
        fms.append(ar.head(f"DetectionHead_{i + 1}", y))
    return fms


def zscore(raw: torch.Tensor) -> torch.Tensor:
    """Per-image z-score of NHWC pixels in float32 (population std over
    the whole image; std <= 1 only subtracts the mean)."""
    x = raw.to(F32)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True))
    return torch.where(std <= 1.0, x - mean, (x - mean) / std)


@torch.no_grad()
def calibrate(weights: dict, model: dict, images: torch.Tensor,
              block: int = 8, levels: int = 127) -> Dict[str, float]:
    """Activation scales {block: float32 scale} of `Bf16Mode`'s absmax over
    the z-scored `images`, run `block` images at a time."""
    ar = Bf16Mode(weights, model)
    with no_tf32():
        for i in range(0, images.shape[0], block):
            forward(ar, model, images[i:i + block])
    return {k: f32_scale(v, levels) for k, v in ar.absmax.items()}
