"""Plain PyTorch reference of YOLOv4 at serving: CSPDarknet53, SPP, the PAN
neck, three YOLO heads and their decode (Bochkovskiy, Wang and Liao,
arXiv:2004.10934; darknet's `cfg/yolov4.cfg`, github.com/AlexeyAB/darknet),
written from the cfg's layer table alone and importing nothing of the
program.

Weights are a flat dict keyed by cfg layer (`conv_0` .. `conv_160`): a
conv block holds `kernel` (OIHW), `scale`, `offset`, `mean`, `var`; a head
`kernel` and `bias`. Activations are NHWC.

A block is Conv(no bias) -> BatchNorm -> activation, Mish
(y * tanh(softplus(y)), softplus's threshold 20) through layer 104 and
LeakyReLU(0.1) from 105 on; every k x k conv pads k // 2 on all four
sides (darknet's `pad=1`: a stride-2 3x3 pads a row and a column on each
side). The CSP stage, SPP (max pools 13, 9, 5 at stride 1 over a -inf
border, concatenated before x), the top-down and bottom-up paths and the
heads follow `forward`, layer by layer; a route's concatenation is in the
cfg's order.

Where this departs from darknet:
- BatchNorm's epsilon 1e-5 sits inside the square root, as PyTorch ports
  of YOLOv4 have it (darknet adds .000001 to the square root);
- no letterbox: the images are already 608 x 608, RGB / 255.

Arithmetics over one wiring (`forward`):
- `Float`: every step in float32 (convs with TF32 off, `no_tf32`), on the
  image as the configuration's compute dtype holds it: the truth;
- `Bf16Serve`: bf16 serving at the precision's own rounding points: each
  block's BatchNorm folded into its weight and bias in float32 (W * mul,
  offset - mean * mul) and cast; a 3x3 or stride-2 conv (and, without
  `use_pallas_pointwise`, a 1x1) of bf16 operands with its bf16 bias,
  rounded to bf16, then the activation computed in float32 and rounded;
  with `use_pallas_pointwise` a 1x1 block as one float32 product of its
  bf16 operands plus the float32 bias, the activation, rounded once;
  residual sums, concatenations, pools and upsampling in bf16; heads a
  bf16 conv with bias;
- `Quant8`: the 8-bit control, a fake quantization with float32 sums:
  each block's input codes round(x / s) clipped to +-127 at a per-tensor
  scale (`calibrate`: the float32 absmax over the calibration images /
  127), the folded weight at per-output-channel scales, the sums exact
  (integers in float32 with TF32 off), then sums * s * s_w + bias, the
  activation, rounded to bf16; layer 0 (on the image) and the heads stay
  bf16, as `Bf16Serve` runs them;
- `Stats`: `Float`, setting each block's BatchNorm mean and variance to
  the statistics of its conv's output over the images it runs (biased
  variance), as a trained model's are its data's (`set_statistics`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import bf16, no_tf32

F32 = torch.float32
BF16 = torch.bfloat16
# (first layer, width, residual blocks) of the CSP stages
STAGES = ((1, 64, 1), (11, 128, 2), (24, 256, 8), (55, 512, 8),
          (86, 1024, 4))
HEADS = ("conv_138", "conv_149", "conv_160")
STRIDES = (8, 16, 32)
SOFTPLUS_THRESHOLD = 20.0
LEVELS = 127


# --- the architecture --------------------------------------------------------

def conv_specs(model: dict) -> List[Tuple[str, int, int, int, int, str]]:
    """(name, in channels, out channels, kernel, stride, activation) of
    every conv in layer order; a head's activation is `linear` (bias, no
    BatchNorm)."""
    head = model["number_anchors"] * (5 + model["number_classes"])
    specs = []

    def conv(layer, ci, co, k, s=1, act="mish"):
        specs.append((f"conv_{layer}", ci, co, k, s, act))

    def five(layer, ci, f):
        chans = [ci, f, 2 * f, f, 2 * f, f]
        for i in range(5):
            conv(layer + i, chans[i], chans[i + 1], 3 if i % 2 else 1,
                 act="leaky")

    conv(0, model["img_size"][2], 32, 3)
    ci = 32
    for s0, c, n in STAGES:
        split = c if s0 == 1 else c // 2       # stage 1 keeps 64 a branch
        inner = split // 2 if s0 == 1 else split
        conv(s0, ci, c, 3, 2)                   # downsample
        conv(s0 + 1, c, split, 1)               # branch a
        conv(s0 + 3, c, split, 1)               # branch b (route -2)
        for j in range(n):
            conv(s0 + 4 + 3 * j, split, inner, 1)
            conv(s0 + 5 + 3 * j, inner, split, 3)
        conv(s0 + 4 + 3 * n, split, split, 1)
        conv(s0 + 6 + 3 * n, 2 * split, c, 1)   # transition
        ci = c
    for layer, a, b, k in ((105, 1024, 512, 1), (106, 512, 1024, 3),
                           (107, 1024, 512, 1), (114, 2048, 512, 1),
                           (115, 512, 1024, 3), (116, 1024, 512, 1),
                           (117, 512, 256, 1), (120, 512, 256, 1)):
        conv(layer, a, b, k, act="leaky")
    five(122, 512, 256)
    conv(127, 256, 128, 1, act="leaky")
    conv(130, 256, 128, 1, act="leaky")
    five(132, 256, 128)
    conv(137, 128, 256, 3, act="leaky")
    conv(138, 256, head, 1, act="linear")
    conv(141, 128, 256, 3, 2, act="leaky")
    five(143, 512, 256)
    conv(148, 256, 512, 3, act="leaky")
    conv(149, 512, head, 1, act="linear")
    conv(152, 256, 512, 3, 2, act="leaky")
    five(154, 1024, 512)
    conv(159, 512, 1024, 3, act="leaky")
    conv(160, 1024, head, 1, act="linear")
    return specs


def conv_pad(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC x, OIHW w -> NHWC float32 conv padded k // 2 a side, no bias."""
    k = w.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).to(F32), w.to(F32), None, stride,
                 padding=k // 2)
    return y.permute(0, 2, 3, 1)


def mish(y: torch.Tensor) -> torch.Tensor:
    """y * tanh(softplus(y)), softplus = y above the threshold."""
    sp = torch.where(y > SOFTPLUS_THRESHOLD, y, torch.log1p(torch.exp(
        torch.clamp(y, max=SOFTPLUS_THRESHOLD))))
    return y * torch.tanh(sp)


def activation(y: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    if act == "mish":
        return mish(y)
    if act == "leaky":
        return torch.where(y >= 0, y, alpha * y)
    return y


def maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 k x k max pool over a -inf border (NHWC)."""
    p = k // 2
    xn = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), value=float("-inf"))
    return F.max_pool2d(xn, k, 1).permute(0, 2, 3, 1)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def bn_affine(p: dict, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    mul = p["scale"].to(F32) / torch.sqrt(p["var"].to(F32) + eps)
    return mul, p["offset"].to(F32) - p["mean"].to(F32) * mul


def folded(p: dict, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's BatchNorm folded into its conv: (W * mul, add), f32."""
    mul, add = bn_affine(p, eps)
    return p["kernel"].to(F32) * mul[:, None, None, None], add


# --- arithmetics -------------------------------------------------------------

class Float:
    """Every step in float32, from the image in the configuration's
    compute dtype."""

    def __init__(self, weights: dict, model: dict):
        self.w, self.model = weights, model
        self.alpha, self.eps = model["leaky_relu_alpha"], model["bn_epsilon"]
        self.acts = {name: act for name, *_, act in conv_specs(model)}

    def image(self, x):
        if self.model["compute_dtype"] == "float32":
            return x.to(F32)
        return bf16(x)

    def block(self, name, x, stride):
        p = self.w[name]
        mul, add = bn_affine(p, self.eps)
        y = conv_pad(x, p["kernel"], stride) * mul + add
        return activation(y, self.acts[name], self.alpha)

    def head(self, name, x):
        p = self.w[name]
        return conv_pad(x, p["kernel"], 1) + p["bias"].to(F32)

    def add(self, a, b):
        return a + b

    def cat(self, ts):
        return torch.cat(ts, dim=-1)


class Stats(Float):
    """`Float` that sets each block's BatchNorm mean and variance (in the
    weights it holds) to its conv output's statistics first."""

    def block(self, name, x, stride):
        p = self.w[name]
        y = conv_pad(x, p["kernel"], stride)
        p["mean"] = y.mean(dim=(0, 1, 2))
        p["var"] = ((y - p["mean"]) ** 2).mean(dim=(0, 1, 2))
        return super().block(name, x, stride)


class Bf16Serve(Float):
    """The bf16 serving arithmetic (module docstring)."""

    def __init__(self, weights: dict, model: dict):
        super().__init__(weights, model)
        self.fused = model["use_pallas_pointwise"]

    def image(self, x):
        return x.to(BF16)

    def block(self, name, x, stride):
        w, b = folded(self.w[name], self.eps)
        x = x.to(BF16)
        k = w.shape[-1]
        if self.fused and k == 1 and stride == 1:
            n, h, wd, ci = x.shape
            acc = x.reshape(-1, ci).to(F32) @ bf16(w[:, :, 0, 0]).t()
            y = activation(acc + b, self.acts[name], self.alpha)
            return y.to(BF16).reshape(n, h, wd, -1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(BF16), b.to(BF16), stride,
                     padding=k // 2).permute(0, 2, 3, 1)
        return activation(y.to(F32), self.acts[name], self.alpha).to(BF16)

    def head(self, name, x):
        p = self.w[name]
        y = F.conv2d(x.to(BF16).permute(0, 3, 1, 2), p["kernel"].to(BF16),
                     p["bias"].to(BF16))
        return y.permute(0, 2, 3, 1)

    def add(self, a, b):
        return a.to(BF16) + b.to(BF16)


class Quant8(Bf16Serve):
    """The 8-bit control (module docstring); `scales` {block: float32
    activation scale} from `calibrate`."""

    SKIP = ("conv_0",)

    def __init__(self, weights: dict, model: dict, scales: Dict[str, float]):
        super().__init__(weights, model)
        self.scales = scales
        self._folded: Dict[str, tuple] = {}

    def fold(self, name):
        """(weight codes OIHW, per-output-channel scale, bias), f32."""
        if name not in self._folded:
            w, b = folded(self.w[name], self.eps)
            absmax = w.abs().amax(dim=(1, 2, 3))
            sw = torch.clamp_min(absmax, 1e-12) / LEVELS
            wq = torch.clamp(torch.round(w / sw[:, None, None, None]),
                             -LEVELS, LEVELS)
            self._folded[name] = (wq, sw, b)
        return self._folded[name]

    def block(self, name, x, stride):
        if name in self.SKIP:
            return super().block(name, x, stride)
        s = self.scales[name]
        q = torch.clamp(torch.round(x.to(F32) / s), -LEVELS, LEVELS)
        wq, sw, b = self.fold(name)
        acc = conv_pad(q, wq, stride)
        if float(acc.abs().max()) >= 2 ** 24:
            raise ArithmeticError(f"{name}: a sum passed 2^24, float32 is "
                                  "no longer exact")
        y = acc * (s * sw) + b
        return activation(y, self.acts[name], self.alpha).to(BF16)


class _Absmax(Float):
    """`Float` recording each block's input absmax."""

    def __init__(self, weights: dict, model: dict):
        super().__init__(weights, model)
        self.absmax: Dict[str, float] = {}

    def block(self, name, x, stride):
        m = float(x.abs().max())
        self.absmax[name] = max(self.absmax.get(name, 0.0), m)
        return super().block(name, x, stride)


# --- the wiring --------------------------------------------------------------

def _stage(ar, s0: int, n: int, x):
    """A CSP stage from layer s0: downsample, branches a and b, n residual
    blocks on b, b's 1x1, the transition over [b, a]."""
    p = ar.block(f"conv_{s0}", x, 2)
    a = ar.block(f"conv_{s0 + 1}", p, 1)
    b = ar.block(f"conv_{s0 + 3}", p, 1)
    for j in range(n):
        y = ar.block(f"conv_{s0 + 4 + 3 * j}", b, 1)
        b = ar.add(b, ar.block(f"conv_{s0 + 5 + 3 * j}", y, 1))
    b = ar.block(f"conv_{s0 + 4 + 3 * n}", b, 1)
    return ar.block(f"conv_{s0 + 6 + 3 * n}", ar.cat([b, a]), 1)


def _five(ar, layer: int, x):
    for i in range(5):
        x = ar.block(f"conv_{layer + i}", x, 1)
    return x


def forward(ar, model: dict, images: torch.Tensor) -> List[torch.Tensor]:
    """RGB / 255 NHWC images -> the heads' feature maps (strides 8, 16,
    32) in float32, under the arithmetic `ar`."""
    x = ar.block("conv_0", ar.image(images), 1)
    routes = []
    for s0, _, n in STAGES:
        x = _stage(ar, s0, n, x)
        routes.append(x)
    r54, r85, r104 = routes[2:]
    x = ar.block("conv_107", ar.block("conv_106",
                                      ar.block("conv_105", r104, 1), 1), 1)
    x = ar.cat([maxpool(x, 13), maxpool(x, 9), maxpool(x, 5), x])
    n5 = ar.block("conv_116", ar.block("conv_115",
                                       ar.block("conv_114", x, 1), 1), 1)
    u = upsample_2x(ar.block("conv_117", n5, 1))
    n4 = _five(ar, 122, ar.cat([ar.block("conv_120", r85, 1), u]))
    u = upsample_2x(ar.block("conv_127", n4, 1))
    n3 = _five(ar, 132, ar.cat([ar.block("conv_130", r54, 1), u]))
    fms = [ar.head("conv_138", ar.block("conv_137", n3, 1))]
    p4 = _five(ar, 143, ar.cat([ar.block("conv_141", n3, 2), n4]))
    fms.append(ar.head("conv_149", ar.block("conv_148", p4, 1)))
    p5 = _five(ar, 154, ar.cat([ar.block("conv_152", p4, 2), n5]))
    fms.append(ar.head("conv_160", ar.block("conv_159", p5, 1)))
    return [f.to(F32) for f in fms]


def preprocess(raw: torch.Tensor) -> torch.Tensor:
    """8-bit RGB NHWC pixels -> float32 / 255."""
    return raw.to(F32) / 255.0


@torch.no_grad()
def set_statistics(weights: dict, model: dict, images: torch.Tensor) -> None:
    """Each block's BatchNorm mean and variance from `images` (`Stats`)."""
    with no_tf32():
        forward(Stats(weights, model), model, images)


@torch.no_grad()
def calibrate(weights: dict, model: dict, images: torch.Tensor,
              block: int = 8) -> Dict[str, float]:
    """`Quant8`'s activation scales: {block: float32 absmax / 127} of each
    block's input under `Float` over `images`."""
    ar = _Absmax(weights, model)
    with no_tf32():
        for i in range(0, images.shape[0], block):
            forward(ar, model, images[i:i + block])
    return {k: float(np.float32(max(v, 1e-12) / LEVELS))
            for k, v in ar.absmax.items()}


# --- the decode --------------------------------------------------------------

def scale_anchors(model: dict) -> List[list]:
    a = model["number_anchors"]
    return [model["anchors"][i * a:(i + 1) * a] for i in range(len(STRIDES))]


def decode(fms, model: dict) -> torch.Tensor:
    """Feature maps (strides 8, 16, 32) -> rows [N, boxes, 4+1+C] of
    (x0, y0, x1, y1, sigmoid objectness, sigmoid classes), ordered (scale,
    cell, anchor), in float32: darknet's yolo layer,
    b_xy = (c_xy + sigmoid(t_xy) * s - (s - 1) / 2) * stride,
    b_wh = anchor_wh * exp(t_wh)."""
    classes = model["number_classes"]
    out = []
    for fm, stride, anc, s in zip(fms, STRIDES, scale_anchors(model),
                                  model["scale_x_y"]):
        n, gh, gw, _ = fm.shape
        f = fm.to(F32).reshape(n, gh, gw, len(anc), 5 + classes)
        row, col = torch.meshgrid(
            torch.arange(gh, dtype=F32, device=fm.device),
            torch.arange(gw, dtype=F32, device=fm.device), indexing="ij")
        off = torch.stack([col, row], -1).reshape(gh, gw, 1, 2)
        xy = (off + torch.sigmoid(f[..., 0:2]) * s - (s - 1) / 2) * stride
        wh = torch.exp(f[..., 2:4]) * torch.tensor(anc, dtype=F32,
                                                   device=fm.device)
        rows = torch.cat([xy - 0.5 * wh, xy + 0.5 * wh,
                          torch.sigmoid(f[..., 4:5]),
                          torch.sigmoid(f[..., 5:])], -1)
        out.append(rows.reshape(n, -1, 5 + classes))
    return torch.cat(out, 1)


def candidates(det: torch.Tensor, model: dict, icfg: dict
               ) -> List[List[Tuple[np.ndarray, np.ndarray]]]:
    """Per image, per class: the NMS candidates of decoded rows det [N,
    boxes, 5+C] (on any device): corners clipped to the image, objectness
    zeroed where the box is not wider AND taller than `min_box_size`,
    score sqrt(p_class * objectness) (float64, rounded to float32), the
    boxes scoring >= the threshold in descending order (ties: lower index
    first), the first `max_boxes_per_class`."""
    h, w = model["img_size"][:2]
    b = torch.stack([det[..., 0].clamp(0, w), det[..., 1].clamp(0, h),
                     det[..., 2].clamp(0, w), det[..., 3].clamp(0, h)], -1)
    m = icfg["min_box_size"]
    big = ((b[..., 2] - b[..., 0]) > m) & ((b[..., 3] - b[..., 1]) > m)
    obj = torch.where(big, det[..., 4], torch.zeros_like(det[..., 4]))
    prod = det[..., 5:].transpose(1, 2) * obj[:, None, :]
    sc = torch.sqrt(prod.double()).float()                   # [N, C, boxes]
    t = icfg["score_threshold"]
    order = torch.sort(torch.where(sc >= t, sc, -1.0), dim=-1,
                       descending=True, stable=True)
    k = icfg["max_boxes_per_class"]
    top_s = order.values[..., :k].cpu().numpy()
    top_i = order.indices[..., :k].cpu().numpy()
    boxes = b.cpu().numpy()
    out = []
    for i in range(det.shape[0]):
        per = []
        for c in range(top_s.shape[1]):
            keep = top_s[i, c] >= t
            per.append((boxes[i][top_i[i, c][keep]].reshape(-1, 4),
                        top_s[i, c][keep]))
        out.append(per)
    return out
