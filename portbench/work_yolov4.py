"""The yardstick's arithmetic for YOLOv4 (`reference/yolov4.py`): each
conv's operations and bytes at the configuration's shapes, counted from
the reference's conv spec with darknet's symmetric padding (k // 2 a side;
a tap on the padding is no work), never from the calls a run makes.

Operations are 2 per multiply-add. A roofline bound reads each input byte
once and writes each output byte once, whatever a kernel reads again; the
peaks are `work.py`'s.
"""

from __future__ import annotations

from typing import List, Tuple

from reference.yolov4 import conv_specs
from work import HBM_BYTES_S, PEAK_OPS_S


def conv_macs(n: int, h: int, w: int, ci: int, co: int, k: int,
              s: int) -> int:
    """Multiply-adds of an NHWC conv padded k // 2 a side: the taps inside
    the image."""
    p = k // 2
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1

    def inside(size, out, u):
        return sum(0 <= i * s - p + u < size for i in range(out))

    return n * ci * co * sum(inside(h, oh, u) * inside(w, ow, v)
                             for u in range(k) for v in range(k))


def neck_stride(layer: int) -> int:
    """The stride of a neck conv's input (layer 105 on): N5's convs and
    the last head at 32, N4's and the middle head at 16, N3's and the
    first head at 8."""
    if layer <= 117 or layer >= 154:
        return 32
    if layer <= 127 or layer >= 143:
        return 16
    return 8


def conv_layers(model: dict) -> List[Tuple[str, int, int, int, int, int,
                                           int, str]]:
    """(name, input h, input w, ci, co, k, stride, activation) of every
    conv of the forward at the configuration's image size."""
    h, w = model["img_size"][0], model["img_size"][1]
    out = []
    stride = 1  # the backbone's, down its chain
    for name, ci, co, k, s, act in conv_specs(model):
        layer = int(name.split("_")[1])
        at = stride if layer < 105 else neck_stride(layer)
        out.append((name, -(-h // at), -(-w // at), ci, co, k, s, act))
        if layer < 105:
            stride *= s
    return out


def forward_ops(model: dict) -> int:
    """Conv operations of one image's forward (heads included)."""
    return 2 * sum(conv_macs(1, h, w, ci, co, k, s)
                   for _, h, w, ci, co, k, s, _ in conv_layers(model))


def mish_pointwise(model: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, h, w, ci, co) of the 1x1 stride-1 Mish convs: the fused
    kernel's Mish launches."""
    return [(name, h, w, ci, co)
            for name, h, w, ci, co, k, s, act in conv_layers(model)
            if act == "mish" and k == 1 and s == 1]


def mish_pointwise_bound_s(model: dict, batch: int) -> float:
    """The least time, in seconds, of one call's Mish 1x1 convs at
    `batch`: for each, the larger of its operations at the bf16 peak and
    its bytes (bf16 input, bf16 weights, the three float32 epilogue rows,
    bf16 output) at the HBM rate."""
    total = 0.0
    for _, h, w, ci, co in mish_pointwise(model):
        m = batch * h * w
        nbytes = m * ci * 2 + co * ci * 2 + 3 * co * 4 + m * co * 2
        ops = 2 * m * ci * co
        total += max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S["bfloat16"])
    return total
