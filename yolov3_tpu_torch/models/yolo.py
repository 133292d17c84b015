"""YOLOv3 in PyTorch: Darknet-53 backbone + 3-scale FPN heads.

Port of `yolov3_tpu/models/yolo.py`. Public functions take and return
NHWC tensors as the JAX package does; only the convolutions permute to
NCHW around `F.conv2d`. In eval mode BatchNorm uses the running
statistics; in train mode (`module.training`, Flax's `train=True`) the
batch's, and moves the running ones (see `BatchNorm`).

Reference quirks kept for output parity (reference/model.py:19-464):
- the block order is Conv -> LeakyReLU(0.2) -> BatchNorm(eps 1e-3);
- a FeatureBlock adds the ORIGINAL block input at every repetition;
- XLA/TF "SAME" padding: a stride-2 3x3 conv pads one row/column at the
  bottom/right only, not symmetrically;
- the FPN concat order is [upsample(y), route], and `upsample_channel_sum`
  reproduces the reference's all-ones Conv2DTranspose (every channel the
  sum over channels, accumulated in f32).

The JAX model's space-to-depth stem is the same math as the plain stem,
laid out for the TPU, over the same variable tree; this port runs the
plain stem whatever `stem_space_to_depth` says.

What the forward needs beyond the parameters (weights in the compute
dtype, the 1x1 kernel's [Ci, Co] bf16 layout, the folded BatchNorm) is
derived once, as non-persistent buffers, by each module's `prepare()`:
at construction and after every `load_state_dict`. The forward only
launches work on the activations. Call `prepare()` again after assigning
parameters directly, or `prepare_all` after an optimizer step.

The train-mode forward reads the parameters themselves, cast to the
compute dtype inside the graph, so autograd reaches the f32 parameters;
it never reads the derived constants, and never takes the fused 1x1
kernel (as yolo.py:89-90 takes it only when `not train`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.ops.decode import decode_detections
from yolov3_tpu_torch.ops.kernels import conv_block


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA/TF SAME padding (the end gets the odd pixel)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int) -> torch.Tensor:
    """NHWC conv with SAME padding; weight OIHW."""
    k = weight.shape[-1]
    (pt, pb), (pl, pr) = (_same_pads(x.shape[1], k, stride),
                          _same_pads(x.shape[2], k, stride))
    x = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(x, weight, bias, stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, bias, stride)
    return y.permute(0, 2, 3, 1)


class Prepared(nn.Module):
    """A module whose forward reads constants derived from its parameters;
    `prepare()` derives them, at construction and after every
    `load_state_dict`. Its inference forward is the default: it starts in
    eval mode, unlike `nn.Module`, so a model built without a mode
    serves; `.train()` selects the train-mode forward."""

    def __init__(self):
        super().__init__()
        self.train(False)
        self.register_load_state_dict_post_hook(lambda m, _: m.prepare())

    def constant(self, name: str, value: torch.Tensor) -> None:
        """Set (or register) a non-persistent buffer: it follows `.to()`
        but stays out of the state_dict."""
        self.register_buffer(name, value.detach(), persistent=False)

    def prepare(self) -> None:
        raise NotImplementedError


def prepare_all(model: nn.Module) -> None:
    """Derive every module's constants again from its current parameters
    and statistics (after an optimizer step or a direct assignment)."""
    for m in model.modules():
        if isinstance(m, Prepared):
            m.prepare()


class Conv(nn.Module):
    """Conv parameters (OIHW weight + bias); zeros until weights load."""

    def __init__(self, in_features: int, features: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))


class BatchNorm(Prepared):
    """BatchNorm over the channel (last) axis, computed in f32 and cast
    back, in Flax's op order.

    Train mode is Flax's arithmetic (flax/linen/normalization.py:60-145,
    395-404), which `F.batch_norm` is not: the statistics in f32 as
    E[x^2] - E[x]^2 clamped at 0, the running variance moved by the
    biased batch variance, running = momentum * running + (1 - momentum)
    * batch, and (x - mean) * (scale * rsqrt(var + eps)) + bias.
    Gradients flow through the batch statistics."""

    def __init__(self, features: int, eps: float, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.prepare()

    @torch.no_grad()
    def prepare(self) -> None:
        self.constant("mul", torch.rsqrt(self.running_var + self.eps)
                      * self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.forward_train(x)
        y = (x.to(torch.float32) - self.running_mean) * self.mul + self.bias
        return y.to(x.dtype)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        dims = tuple(range(xf.dim() - 1))
        mean = xf.mean(dims)
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        var = torch.maximum((xf * xf).mean(dims) - mean * mean,
                            xf.new_tensor(0.0))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class ConvBlock(Prepared):
    """Conv(SAME, bias) -> LeakyReLU -> BatchNorm (reference/model.py:28-39).

    With `use_pallas_pointwise`, a 1x1 stride-1 block runs as one fused
    kernel (matmul + bias + LeakyReLU + affine BatchNorm), as
    yolo.py:89-104 does.
    """

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, alpha: float = 0.2, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_pointwise: bool = False,
                 bn_momentum: float = 0.99):
        super().__init__()
        self.stride, self.alpha = stride, alpha
        self.bn_epsilon, self.dtype = bn_epsilon, dtype
        self.fused = use_pallas_pointwise and kernel == 1 and stride == 1
        self.conv = Conv(in_features, features, kernel)
        self.bn = BatchNorm(features, bn_epsilon, bn_momentum)
        self.prepare()

    @torch.no_grad()
    def prepare(self) -> None:
        """Fused: the kernel's [Co, Ci] bf16 weight (K-major, the OIHW
        weight without its taps), f32 bias and the folded BatchNorm (mul,
        add). Otherwise: weight and bias in the compute dtype, and the
        BatchNorm's own constant."""
        conv, bn = self.conv, self.bn
        if self.fused:
            self.constant("w", conv.weight[:, :, 0, 0].to(
                torch.bfloat16).contiguous())
            self.constant("b", conv.bias.to(torch.float32))
            mul, add = conv_block.fold_batchnorm(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, self.bn_epsilon)
            self.constant("mul", mul)
            self.constant("add", add)
        else:
            self.constant("w", conv.weight.to(self.dtype))
            self.constant("b", conv.bias.to(self.dtype))
            bn.prepare()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            conv = self.conv
            y = conv2d_same(x.to(self.dtype), conv.weight.to(self.dtype),
                            conv.bias.to(self.dtype), self.stride)
            return self.bn(F.leaky_relu(y, self.alpha))
        if self.fused:
            n, h, w, ci = x.shape
            y = conv_block.pointwise_conv_block(
                x.reshape(n * h * w, ci).to(torch.bfloat16), self.w, self.b,
                self.mul, self.add, self.alpha, self.dtype)
            return y.reshape(n, h, w, -1)
        y = conv2d_same(x.to(self.dtype), self.w, self.b, self.stride)
        return self.bn(F.leaky_relu(y, self.alpha))


class FeatureBlock(nn.Module):
    """Repeated 1x1 half-filter / k x k full-filter pairs; each repetition
    adds the ORIGINAL block input (reference/model.py:41-48)."""

    def __init__(self, reps: int, kernel: int, features: int, ck: dict):
        super().__init__()
        convs = []
        for _ in range(reps):
            convs.append(ConvBlock(features, features // 2, 1, **ck))
            convs.append(ConvBlock(features // 2, features, kernel, **ck))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(0, len(self.convs), 2):
            x = inputs + self.convs[i + 1](self.convs[i](x))
        return x


class YoloBlock(nn.Module):
    """Five-conv neck returning (route, output) (reference/model.py:50-59)."""

    def __init__(self, in_features: int, kernel: int, features: int,
                 ck: dict):
        super().__init__()
        half, full = features // 2, features
        chans = [in_features, half, full, half, full, half, full]
        self.convs = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], 1 if i % 2 == 0 else kernel,
                      **ck) for i in range(6))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for conv in self.convs[:5]:
            x = conv(x)
        return x, self.convs[5](x)


def upsample_2x(x: torch.Tensor, channel_sum: bool = False) -> torch.Tensor:
    """2x spatial upsample (NHWC): per-channel nearest neighbour, or with
    `channel_sum` the reference's all-ones transpose conv, where every
    output channel is the f32 sum over input channels."""
    n, h, w, c = x.shape
    if channel_sum:
        x = x.to(torch.float32).sum(dim=-1, keepdim=True).expand(
            n, h, w, c).to(x.dtype)
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


class DetectionHead(Prepared):
    """Linear 1x1 conv to A*(5+C) channels (reference/model.py:107-120)."""

    def __init__(self, in_features: int, num_anchors: int,
                 number_classes: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_features, num_anchors * (5 + number_classes), 1)
        self.prepare()

    @torch.no_grad()
    def prepare(self) -> None:
        self.constant("w", self.conv.weight.to(self.dtype))
        self.constant("b", self.conv.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            conv = self.conv
            return conv2d_same(x.to(self.dtype), conv.weight.to(self.dtype),
                               conv.bias.to(self.dtype), 1)
        return conv2d_same(x.to(self.dtype), self.w, self.b, 1)


class Darknet53(nn.Module):
    """Backbone producing routes at strides 8/16/32
    (reference/model.py:382-421)."""

    def __init__(self, in_channels: int, ck: dict, block_count: int,
                 filter_count: int, kernel: int):
        super().__init__()
        fc, k = filter_count, kernel
        widths = [fc // 32, fc // 16, fc // 8, fc // 4, fc // 2, fc]
        chans = [in_channels] + widths
        self.convs = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], k, stride=1 if i == 0 else 2,
                      **ck) for i in range(6))
        reps = [1, 2, block_count, block_count, block_count // 2]
        self.blocks = nn.ModuleList(
            FeatureBlock(r, k, wd, ck) for r, wd in zip(reps, widths[1:]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.convs[0](x)
        routes = []
        for down, block in zip(self.convs[1:], self.blocks):
            x = block(down(x))
            routes.append(x)
        return routes[2:]  # strides 8, 16, 32


class YoloV3(nn.Module):
    """Feature-map model: NHWC image -> (fm @ stride 32, 16, 8), each NHWC
    with A*(5+C) channels, in the compute dtype. Also the training model:
    `.train()` selects the train-mode forward of every block."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        ck = dict(alpha=cfg.leaky_relu_alpha, bn_epsilon=cfg.bn_epsilon,
                  bn_momentum=cfg.bn_momentum, dtype=cfg.dtype,
                  use_pallas_pointwise=cfg.use_pallas_pointwise)
        k, fc = cfg.kernel_size, cfg.filter_count
        self.darknet = Darknet53(cfg.img_size[2], ck, cfg.block_count, fc, k)
        f8, f16, f32 = fc // 4, fc // 2, fc
        self.yolo_blocks = nn.ModuleList([
            YoloBlock(f32, k, f32, ck), YoloBlock(2 * f16, k, f16, ck),
            YoloBlock(2 * f8, k, f8, ck)])
        self.necks = nn.ModuleList([ConvBlock(f32 // 2, f16, 1, **ck),
                                    ConvBlock(f16 // 2, f8, 1, **ck)])
        self.heads = nn.ModuleList(
            DetectionHead(f, cfg.number_anchors, cfg.number_classes,
                          cfg.dtype) for f in (f32, f16, f8))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.config
        route_s8, route_s16, route_s32 = self.darknet(x.to(cfg.dtype))
        route, y = self.yolo_blocks[0](route_s32)
        fms = [self.heads[0](y)]
        for neck, skip, block, head in zip(self.necks, (route_s16, route_s8),
                                           self.yolo_blocks[1:],
                                           self.heads[1:]):
            y = upsample_2x(neck(route), cfg.upsample_channel_sum)
            route, y = block(torch.cat([y, skip], dim=-1))
            fms.append(head(y))
        return fms


class YoloV3Detector(nn.Module):
    """Inference model: NHWC image -> decoded detections [N, boxes, 4+1+C]."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.backbone = YoloV3(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return decode_detections(self.backbone(x), cfg.anchors,
                                 cfg.number_classes, cfg.strides)
