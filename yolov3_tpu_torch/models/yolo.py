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
plain stem whatever `stem_space_to_depth` says. In train mode the
region's five blocks (stem1, stem2, FeatureBlock_0, ConvBlock_2) keep
the reference's `_s2d_conv_block` arithmetic under it
(`ConvBlock.forward_affine_train`).

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

Quantization-aware training (`ModelConfig.int8_train`, yolo.py:61-87,
446-550): in train mode each quantizing ConvBlock runs `int8_ste_conv`,
an int8 forward (per-batch absmax activation scale, per-output-channel
weight scales, exact int32 sums from `ops/quant.py::int8_conv_sums`)
whose backward is the plain conv's VJP in the compute dtype at the saved
operands (the straight-through estimator), and normalises through the
reference's `_s2d_batchnorm` arithmetic (`BatchNorm.forward_affine`).
With `int8_train_static` the activation scale is the block's frozen
`act_scale` buffer (`int8_ste_conv_static`), set by
`models/quantized.py::calibrate(train_mode=True)` and
`scales_to_buffers`. Every ConvBlock quantizes except stem1 under
`stem_space_to_depth` (the reference keeps it bf16 there); the detection
heads stay plain. The eval forward ignores both flags.

`ModelConfig.remat_blocks` wraps each FeatureBlock and YoloBlock of the
train forward in `torch.utils.checkpoint` (non-reentrant), as the
reference wraps them in `nn.remat` (yolo.py:814-822, 894-901): the
backward recomputes their activations instead of keeping them. The
recomputation moves no running statistic (`remat`), so the step's math
is the plain one.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.decode import decode_detections
from yolov3_tpu_torch.ops.kernels import conv_block
from yolov3_tpu_torch.utils import tracing

F32 = torch.float32


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


def _conv_vjp(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
              stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of `conv2d_same(x, w, None, stride)` for the cotangent dy
    (NHWC), in the operands' dtype."""
    k = w.shape[-1]
    (pt, pb), (pl, pr) = (_same_pads(x.shape[1], k, stride),
                          _same_pads(x.shape[2], k, stride))
    xn = x.permute(0, 3, 1, 2)
    even = pt == pb and pl == pr
    if not even:
        xn = F.pad(xn, (pl, pr, pt, pb))
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), xn, w, None, (stride, stride),
        (pt, pl) if even else (0, 0), (1, 1), False, (0, 0), 1,
        (True, True, False))
    if not even:
        dx = dx[:, :, pt:pt + x.shape[1], pl:pl + x.shape[2]]
    return dx.permute(0, 2, 3, 1), dw


# --- int8-forward training (straight-through estimator) -------------------

def _ste_quantize_act(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization with this batch's absmax scale
    (yolo.py:446-452): s = max(absmax, 1e-6) / 127, codes round(x / s)
    clipped to +-127. The scale stays a device tensor."""
    xf = x.to(F32)
    s = torch.clamp_min(xf.abs().amax(), 1e-6) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _ste_quantize_weight(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of an OIHW f32 kernel
    (yolo.py:455-459): s[o] = max(max|w[o]|, 1e-12) / 127."""
    s = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    q = torch.clamp(torch.round(w / s[:, None, None, None]), -127, 127)
    return q.to(torch.int8), s


class _Int8SteConv(torch.autograd.Function):
    """The int8 forward `(sums * (s_x * s_w)).to(dtype)` and the plain
    conv's VJP in `dtype` at the saved (x, w) as the backward; with a
    frozen `sx` (static mode) the codes saturate and `sx` gets a zero
    gradient (yolo.py:463-548)."""

    @staticmethod
    def forward(ctx, x, w, sx, stride, dtype):
        if sx is None:
            qx, s = _ste_quantize_act(x)
        else:
            s = torch.clamp_min(sx.to(F32), 1e-12)
            qx = torch.clamp(torch.round(x.to(F32) / s), -127,
                             127).to(torch.int8)
        qw, sw = _ste_quantize_weight(w)
        sums = quant.int8_conv_sums(qx, qw, stride)
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.dtype = stride, dtype
        return (sums.to(F32) * (s * sw)).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _conv_vjp(x, w.to(ctx.dtype), dy.to(ctx.dtype), ctx.stride)
        dsx = None
        if ctx.needs_input_grad[2]:
            dsx = torch.zeros((), dtype=F32, device=dy.device)
        return dx.to(x.dtype), dw.to(w.dtype), dsx, None, None


def int8_ste_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """SAME conv (x NHWC, w OIHW f32) with an int8 forward (dynamic
    per-batch activation scale) and the straight-through backward."""
    return _Int8SteConv.apply(x, w, None, stride, dtype)


def int8_ste_conv_static(x: torch.Tensor, w: torch.Tensor,
                         sx: torch.Tensor, stride: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """`int8_ste_conv` with the frozen activation scale `sx` (floor
    1e-12): out-of-range activations saturate at +-127; zero gradient to
    `sx`."""
    return _Int8SteConv.apply(x, w, sx, stride, dtype)


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
        self.frozen = False
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

    def _update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.frozen:  # a checkpointed block's recomputation (`remat`)
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        dims = tuple(range(xf.dim() - 1))
        mean = xf.mean(dims)
        # torch.maximum splits the gradient at a tie, as jnp.maximum does;
        # its zero is a device fill (a tensor made from host data would be
        # a copy that synchronises, and that a CUDA graph cannot capture)
        var = torch.maximum((xf * xf).mean(dims) - mean * mean,
                            xf.new_zeros(()))
        self._update_stats(mean, var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)

    def forward_affine(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode in `_s2d_batchnorm`'s arithmetic (yolo.py:639-661),
        the QAT blocks' normalisation: the statistics in f32 with no clamp
        of the variance, inv = rsqrt(var + eps) * scale, and x * mul + add
        in x's dtype with mul = inv and add = bias - mean * inv each cast
        to it."""
        xf = x.to(torch.float32)
        dims = tuple(range(xf.dim() - 1))
        mean = xf.mean(dims)
        var = (xf * xf).mean(dims) - mean * mean
        self._update_stats(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return x * inv.to(x.dtype) + (self.bias - mean * inv).to(x.dtype)


class ConvBlock(Prepared):
    """Conv(SAME, bias) -> LeakyReLU -> BatchNorm (reference/model.py:28-39).

    With `use_pallas_pointwise`, a 1x1 stride-1 block runs as one fused
    kernel (matmul + bias + LeakyReLU + affine BatchNorm), as
    yolo.py:89-104 does. With `affine_bn` (the space-to-depth region's
    blocks: stem1, stem2, FeatureBlock_0 and ConvBlock_2) the train
    forward is `_s2d_conv_block`'s arithmetic (yolo.py:711-715), as
    `forward_affine_train` says. With `int8_ste` its train-mode forward is
    the QAT one (yolo.py:67-87), in that arithmetic too; with
    `int8_static` as well, the block holds
    its frozen activation scale as the persistent buffer `act_scale`
    (1.0 until calibrated, as the reference's `quant_scales` collection
    starts), which the eval forward ignores.
    """

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, alpha: float = 0.2, bn_epsilon: float = 1e-3,
                 dtype: torch.dtype = torch.bfloat16,
                 use_pallas_pointwise: bool = False,
                 bn_momentum: float = 0.99, int8_ste: bool = False,
                 int8_static: bool = False, affine_bn: bool = False):
        super().__init__()
        self.stride, self.alpha = stride, alpha
        self.bn_epsilon, self.dtype = bn_epsilon, dtype
        self.fused = use_pallas_pointwise and kernel == 1 and stride == 1
        self.int8_ste, self.affine_bn = int8_ste, affine_bn
        self.conv = Conv(in_features, features, kernel)
        self.bn = BatchNorm(features, bn_epsilon, bn_momentum)
        if int8_ste and int8_static:
            self.register_buffer("act_scale", torch.ones(()))
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
        if self.training and (self.int8_ste or self.affine_bn):
            return self.forward_affine_train(x)
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

    def forward_affine_train(self, x: torch.Tensor) -> torch.Tensor:
        """The train forward of the QAT and space-to-depth blocks: the conv
        (the STE conv under `int8_ste`) without its bias, the bias added in
        the compute dtype after it, LeakyReLU and
        `BatchNorm.forward_affine`. LeakyReLU is Flax's
        `where(y >= 0, y, a * y)`, whose gradient at 0 is 1 (that of
        `F.leaky_relu` is a): the int32 sums are often exactly 0."""
        x, w = x.to(self.dtype), self.conv.weight
        if not self.int8_ste:
            y = conv2d_same(x, w.to(self.dtype), None, self.stride)
        elif hasattr(self, "act_scale"):
            y = int8_ste_conv_static(x, w, self.act_scale, self.stride,
                                     self.dtype)
        else:
            y = int8_ste_conv(x, w, self.stride, self.dtype)
        y = y + self.conv.bias.to(self.dtype)
        return self.bn.forward_affine(torch.where(y >= 0, y, self.alpha * y))


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """The running statistics of `module`'s BatchNorms stay as they are."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


def remat(module: nn.Module, x: torch.Tensor):
    """module(x) in train mode under `torch.utils.checkpoint`: the
    backward runs the forward again for the activations, with the
    BatchNorms' running statistics left as the first run moved them."""
    return torch.utils.checkpoint.checkpoint(
        module, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _frozen_stats(module)))


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
                 filter_count: int, kernel: int, region_ck: dict,
                 stem_ck: dict, remat_blocks: bool = False):
        super().__init__()
        self.remat_blocks = remat_blocks
        fc, k = filter_count, kernel
        widths = [fc // 32, fc // 16, fc // 8, fc // 4, fc // 2, fc]
        chans = [in_channels] + widths
        cks = [stem_ck, region_ck, region_ck, ck, ck, ck]
        self.convs = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], k, stride=1 if i == 0 else 2,
                      **cks[i]) for i in range(6))
        reps = [1, 2, block_count, block_count, block_count // 2]
        self.blocks = nn.ModuleList(
            FeatureBlock(r, k, wd, region_ck if i == 0 else ck)
            for i, (r, wd) in enumerate(zip(reps, widths[1:])))

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        block = self.blocks[i]
        if self.remat_blocks and self.training:
            return remat(block, x)
        return block(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        # the stem: what the int8 stem-region kernel replaces, with stem1
        with tracing.span("yolo.stem"):
            x = self._block(0, self.convs[1](self.convs[0](x)))
            x = self.convs[2](x)
        routes = []
        with tracing.span("yolo.backbone"):
            x = self._block(1, x)
            for i in range(2, len(self.blocks)):
                x = self._block(i, self.convs[i + 1](x))
                routes.append(x)
        return routes  # strides 8, 16, 32


class YoloV3(nn.Module):
    """Feature-map model: NHWC image -> (fm @ stride 32, 16, 8), each NHWC
    with A*(5+C) channels, in the compute dtype. Also the training model:
    `.train()` selects the train-mode forward of every block."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        ck = dict(alpha=cfg.leaky_relu_alpha, bn_epsilon=cfg.bn_epsilon,
                  bn_momentum=cfg.bn_momentum, dtype=cfg.dtype,
                  use_pallas_pointwise=cfg.use_pallas_pointwise,
                  int8_ste=cfg.int8_train,
                  int8_static=cfg.int8_train_static)
        # the reference's space-to-depth region trains in
        # `_s2d_conv_block`'s arithmetic, and keeps stem1 in bf16 under
        # QAT with no scale (yolo.py:826-830)
        region_ck = dict(ck, affine_bn=cfg.stem_space_to_depth)
        stem_ck = dict(region_ck, int8_ste=cfg.int8_train
                       and not cfg.stem_space_to_depth)
        k, fc = cfg.kernel_size, cfg.filter_count
        self.darknet = Darknet53(cfg.img_size[2], ck, cfg.block_count, fc, k,
                                 region_ck, stem_ck, cfg.remat_blocks)
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

        def yolo_block(block, x):
            if cfg.remat_blocks and self.training:
                return remat(block, x)
            return block(x)

        # the heads interleave with the neck: each span opens three times
        with tracing.span("yolo.neck"):
            route, y = yolo_block(self.yolo_blocks[0], route_s32)
        with tracing.span("yolo.heads"):
            fms = [self.heads[0](y)]
        for neck, skip, block, head in zip(self.necks, (route_s16, route_s8),
                                           self.yolo_blocks[1:],
                                           self.heads[1:]):
            with tracing.span("yolo.neck"):
                y = upsample_2x(neck(route), cfg.upsample_channel_sum)
                route, y = yolo_block(block, torch.cat([y, skip], dim=-1))
            with tracing.span("yolo.heads"):
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
