"""YOLOv4 in PyTorch: CSPDarknet53, SPP, a PAN neck and three YOLO heads.

Bochkovskiy, Wang and Liao, "YOLOv4: Optimal Speed and Accuracy of
Object Detection" (arXiv:2004.10934), as darknet's `cfg/yolov4.cfg`
(github.com/AlexeyAB/darknet) wires it: 162 layers, 110 of them convs.
`layer_table` lists every conv under its 0-indexed cfg layer, and the
forward follows the cfg's routes by those numbers. Selected by
`ModelConfig.architecture == "yolov4"`; it serves (eval) only.

What differs from the NIST YOLOv3 of `models/yolo.py`:
- the block is Conv(no bias) -> BatchNorm -> activation, Mish
  (y * tanh(softplus(y))) in the backbone and LeakyReLU
  (`leaky_relu_alpha`, 0.1) from layer 105 on;
- darknet pads a k x k conv by k // 2 on all four sides, so a stride-2
  3x3 pads a row and a column on each side (TF-SAME pads the bottom and
  right only);
- a cross-stage-partial stage splits its downsampled input into two 1x1
  branches, runs the residual blocks on one and concatenates
  [that branch, the other] before a 1x1 transition;
- SPP concatenates [maxpool 13, maxpool 9, maxpool 5, x] (stride 1, the
  border padded with -inf); the neck's top-down path concatenates
  [the route's 1x1, the upsample], its bottom-up path [the stride-2 3x3,
  the top-down output];
- each head (a 1x1 conv with bias, linear) has its own three anchors and
  the decode its `scale_x_y` (`ops/decode.py`); heads come out at
  strides 8, 16, 32 (`ModelConfig.strides`).

In eval, BatchNorm folds into the conv (`prepare`): W * mul and
add = offset - mean * mul in float32, then cast, so a block launches
conv + bias and its activation. With `use_pallas_pointwise` every 1x1
stride-1 block but the heads runs as the fused 1x1 kernel
(`ops/kernels/conv_block.py`, "mish" or "leaky", with mul 1 and add 0).

The stage spans are the NIST model's names where the stage is the same:
`yolo.stem` (layers 0-10), `yolo.backbone` (11-104), `yolo.neck` (the
convs of SPP, top-down and bottom-up), `yolo.spp` (108-113, opened
between neck spans, so the stage sums stay disjoint) and `yolo.heads`
(137-138, 148-149, 159-160). While recording, every 1x1 stride-1 block
but the heads counts `pointwise.fused` or `pointwise.plain` (host
integers), as it does or does not take the fused kernel.

The parameters are `layers.conv_<L>` (`checkpoint.flax_path`:
`params/conv_<L>/Conv_0/kernel`, `.../BatchNorm_0/...`), a head's conv
with its bias.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models.yolo import (BatchNorm, Conv, DetectionHead,
                                          Prepared, upsample_2x)
from yolov3_tpu_torch.ops.decode import decode_detections
from yolov3_tpu_torch.ops.kernels import conv_block
from yolov3_tpu_torch.utils import tracing

F32 = torch.float32
BF16 = torch.bfloat16
# (first layer, width, residual blocks) of the five CSP stages
STAGES = ((1, 64, 1), (11, 128, 2), (24, 256, 8), (55, 512, 8),
          (86, 1024, 4))
HEADS = (138, 149, 160)

# (layer, in channels, out channels, kernel, stride, activation)
Layer = Tuple[int, int, int, int, int, str]


def layer_table(in_channels: int, head_channels: int) -> List[Layer]:
    """Every conv of `cfg/yolov4.cfg` in layer order; a head's activation
    is "linear" (bias, no BatchNorm)."""
    out: List[Layer] = []

    def conv(layer, ci, co, k, s=1, act="mish"):
        out.append((layer, ci, co, k, s, act))

    def five(layer, ci, f):
        for i, (a, b, k) in enumerate(((ci, f, 1), (f, 2 * f, 3),
                                       (2 * f, f, 1), (f, 2 * f, 3),
                                       (2 * f, f, 1))):
            conv(layer + i, a, b, k, act="leaky")

    conv(0, in_channels, 32, 3)
    ci = 32
    for s0, c, n in STAGES:
        half = c if s0 == 1 else c // 2
        inner = c // 2 if s0 == 1 else half
        conv(s0, ci, c, 3, 2)
        conv(s0 + 1, c, half, 1)
        conv(s0 + 3, c, half, 1)
        for j in range(n):
            conv(s0 + 4 + 3 * j, half, inner, 1)
            conv(s0 + 5 + 3 * j, inner, half, 3)
        conv(s0 + 4 + 3 * n, half, half, 1)
        conv(s0 + 6 + 3 * n, 2 * half, c, 1)
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
    conv(138, 256, head_channels, 1, act="linear")
    conv(141, 128, 256, 3, 2, act="leaky")
    five(143, 512, 256)
    conv(148, 256, 512, 3, act="leaky")
    conv(149, 512, head_channels, 1, act="linear")
    conv(152, 256, 512, 3, 2, act="leaky")
    five(154, 1024, 512)
    conv(159, 512, 1024, 3, act="leaky")
    conv(160, 1024, head_channels, 1, act="linear")
    return out


def conv2d_darknet(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC conv padded by k // 2 on every side (darknet's `pad=1`);
    weight OIHW."""
    k = weight.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC k x k max pool at stride 1, the border padded with -inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, 1, k // 2).permute(
        0, 2, 3, 1)


class ConvBNAct(Prepared):
    """Conv(no bias, pad k // 2) -> BatchNorm -> Mish or LeakyReLU, with
    the BatchNorm folded into the conv at `prepare`."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, act: str, cfg: ModelConfig):
        super().__init__()
        self.stride, self.act = stride, act
        self.alpha, self.eps, self.dtype = (cfg.leaky_relu_alpha,
                                            cfg.bn_epsilon, cfg.dtype)
        self.pointwise = kernel == 1 and stride == 1
        self.fused = cfg.use_pallas_pointwise and self.pointwise
        self.conv = Conv(in_features, features, kernel, bias=False)
        self.bn = BatchNorm(features, cfg.bn_epsilon, cfg.bn_momentum)
        self.prepare()

    @torch.no_grad()
    def prepare(self) -> None:
        """The folded weight and bias: [Co, Ci] bf16 and f32 with the
        kernel's mul = 1 and add = 0 when fused, else OIHW and [Co] in the
        compute dtype."""
        bn = self.bn
        mul, add = conv_block.fold_batchnorm(bn.weight, bn.bias,
                                             bn.running_mean, bn.running_var,
                                             self.eps)
        w = self.conv.weight.to(F32) * mul[:, None, None, None]
        if self.fused:
            self.constant("w", w[:, :, 0, 0].to(BF16).contiguous())
            self.constant("b", add)
            self.constant("one", torch.ones_like(add))
            self.constant("zero", torch.zeros_like(add))
        else:
            self.constant("w", w.to(self.dtype))
            self.constant("b", add.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("YOLOv4 serves only (eval mode)")
        if self.pointwise:
            tracing.count("pointwise.fused" if self.fused
                          else "pointwise.plain", 1)
        if self.fused:
            n, h, w, ci = x.shape
            y = conv_block.pointwise_conv_block(
                x.reshape(n * h * w, ci).to(BF16), self.w, self.b, self.one,
                self.zero, self.alpha, self.dtype, act=self.act)
            return y.reshape(n, h, w, -1)
        y = conv2d_darknet(x.to(self.dtype), self.w, self.b, self.stride)
        if self.act == "mish":
            return F.mish(y)
        return F.leaky_relu(y, self.alpha)


class YoloV4(nn.Module):
    """Feature-map model: NHWC image -> the heads' maps at strides 8, 16,
    32, each NHWC with A*(5+C) channels, in the compute dtype."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        head = cfg.number_anchors * (5 + cfg.number_classes)
        layers = {}
        for layer, ci, co, k, s, act in layer_table(cfg.img_size[2], head):
            layers[f"conv_{layer}"] = (
                DetectionHead(ci, cfg.number_anchors, cfg.number_classes,
                              cfg.dtype) if act == "linear"
                else ConvBNAct(ci, co, k, s, act, cfg))
        self.layers = nn.ModuleDict(layers)

    def _conv(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        return self.layers[f"conv_{layer}"](x)

    def _stage(self, s0: int, n: int, x: torch.Tensor) -> torch.Tensor:
        """A CSP stage from its layer s0: the stride-2 3x3, the branches
        a (s0+1) and b (s0+3), n residual blocks on b, b's 1x1 and the
        transition over [b, a]."""
        p = self._conv(s0, x)
        a, b = self._conv(s0 + 1, p), self._conv(s0 + 3, p)
        for j in range(n):
            b = b + self._conv(s0 + 5 + 3 * j, self._conv(s0 + 4 + 3 * j, b))
        b = self._conv(s0 + 4 + 3 * n, b)
        return self._conv(s0 + 6 + 3 * n, torch.cat([b, a], dim=-1))

    def _five(self, layer: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = self._conv(layer + i, x)
        return x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        conv = self._conv
        with tracing.span("yolo.stem"):
            x = self._stage(1, 1, conv(0, x.to(self.config.dtype)))
        routes = []
        with tracing.span("yolo.backbone"):
            for s0, _, n in STAGES[1:]:
                x = self._stage(s0, n, x)
                routes.append(x)
        r54, r85, r104 = routes[1:]
        with tracing.span("yolo.neck"):
            x = conv(107, conv(106, conv(105, r104)))
        with tracing.span("yolo.spp"):
            x = torch.cat([maxpool_same(x, 13), maxpool_same(x, 9),
                           maxpool_same(x, 5), x], dim=-1)
        with tracing.span("yolo.neck"):
            n5 = conv(116, conv(115, conv(114, x)))
            n4 = self._five(122, torch.cat(
                [conv(120, r85), upsample_2x(conv(117, n5))], dim=-1))
            n3 = self._five(132, torch.cat(
                [conv(130, r54), upsample_2x(conv(127, n4))], dim=-1))
        with tracing.span("yolo.heads"):
            fms = [conv(138, conv(137, n3))]
        with tracing.span("yolo.neck"):
            p4 = self._five(143, torch.cat([conv(141, n3), n4], dim=-1))
        with tracing.span("yolo.heads"):
            fms.append(conv(149, conv(148, p4)))
        with tracing.span("yolo.neck"):
            p5 = self._five(154, torch.cat([conv(152, p4), n5], dim=-1))
        with tracing.span("yolo.heads"):
            fms.append(conv(160, conv(159, p5)))
        return fms


class YoloV4Detector(nn.Module):
    """Inference model: NHWC image (RGB / 255) -> decoded detections
    [N, boxes, 4+1+C], ordered (scale 8, 16, 32; cell; anchor). The
    per-scale anchors are device tensors made once here, so a call's
    decode copies nothing from the host."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.backbone = YoloV4(config)
        for i, anchors in enumerate(config.scale_anchors):
            self.register_buffer(f"anchors_{i}",
                                 torch.tensor(anchors, dtype=F32),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        anchors = [getattr(self, f"anchors_{i}")
                   for i in range(len(cfg.strides))]
        return decode_detections(self.backbone(x), cfg.anchors,
                                 cfg.number_classes, cfg.strides,
                                 scale_anchors=anchors,
                                 scale_x_y=cfg.scale_x_y or None)
