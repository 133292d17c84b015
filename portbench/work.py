"""The yardstick's arithmetic: operations and bytes of the detector's
convs, counted from the configuration's shapes (never from the calls a
run makes), and the H100's published peaks.

A conv's operations are 2 per multiply-add of the taps that fall inside
the image (XLA's SAME padding; a tap on the padding is no work). A
roofline bound reads each input byte once and writes each output byte
once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from reference.model import conv_specs, same_pads

# published H100 SXM peaks (dense): HBM bytes/s and tensor-core rates
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12}


def conv_macs(n: int, h: int, w: int, ci: int, co: int, k: int,
              s: int) -> int:
    """Multiply-adds of an NHWC SAME conv: the taps inside the image."""
    oh, ow = -(-h // s), -(-w // s)
    pt, pl = same_pads(h, k, s)[0], same_pads(w, k, s)[0]

    def inside(size, out, pad, u):
        return sum(0 <= i * s - pad + u < size for i in range(out))

    return n * ci * co * sum(inside(h, oh, pt, u) * inside(w, ow, pl, v)
                             for u in range(k) for v in range(k))


def conv_layers(model: dict) -> List[Tuple[str, int, int, int, int, int,
                                           int]]:
    """(block path, input h, input w, ci, co, k, stride) of every conv of
    the forward, heads included, at the configuration's image size."""
    h, w = model["img_size"][0], model["img_size"][1]
    size = {}
    d = "Darknet53_0"
    cur = (h, w)
    out = []
    for name, ci, co, k, s in conv_specs(model):
        if name.startswith(f"{d}/ConvBlock_"):
            size[name] = cur
            cur = (-(-cur[0] // s), -(-cur[1] // s))
        elif name.startswith(d):
            size[name] = cur
        else:
            stride = {"0": 32, "1": 16, "2": 8}[
                name.split("/")[0].rsplit("_", 1)[1]]
            if name.startswith("ConvBlock_"):
                stride = 32 if name.endswith("_0") else 16
            size[name] = (-(-h // stride), -(-w // stride))
        out.append((name, *size[name], ci, co, k, s))
    return out


def forward_ops(model: dict) -> int:
    """Conv operations of one image's forward (heads included)."""
    return 2 * sum(conv_macs(1, h, w, ci, co, k, s)
                   for _, h, w, ci, co, k, s in conv_layers(model))


# --- the int8 serving route's convs on the sm90 core ---------------------------
#
# The int8 wiring (post-training quantization, stem region in one launch):
# each conv's input and output element sizes in bytes. A feature block runs
# s8 in and s8 out, its 3x3 also reading the s8 residual and its last 3x3
# writing bf16; a stride-2 block quantizes its bf16 input and writes the next
# block's s8 codes; in a YoloBlock, ConvBlock_0 reads bf16 (YoloBlock_0) or
# s8 (the concatenation, quantized in one), ConvBlock_2 and _4 write the next
# 3x3's s8 codes (_4 its bf16 route too), ConvBlock_3 and _5 read s8; every
# other YoloBlock and neck conv reads and writes bf16.

REGION = ("Darknet53_0/ConvBlock_1", "Darknet53_0/FeatureBlock_0/ConvBlock_0",
          "Darknet53_0/FeatureBlock_0/ConvBlock_1", "Darknet53_0/ConvBlock_2")


def int8_core_io(model: dict) -> Dict[str, Tuple[int, int, int]]:
    """{block: (input bytes an element, residual bytes an output element,
    output bytes an output element)} of the convs the int8 route runs on
    the sm90 core: every conv but stem1, the stem region and the heads."""
    bc = model["block_count"]
    reps = {0: 1, 1: 2, 2: bc, 3: bc, 4: bc // 2}
    io = {}
    for name, *_ in conv_specs(model):
        parts = name.split("/")
        if (name in REGION or name == "Darknet53_0/ConvBlock_0"
                or name.startswith("DetectionHead")):
            continue
        if parts[0] == "Darknet53_0" and parts[1].startswith("ConvBlock_"):
            io[name] = (2, 0, 1)
        elif parts[0] == "Darknet53_0":
            j = int(parts[2].rsplit("_", 1)[1])
            last = j == 2 * reps[int(parts[1].rsplit("_", 1)[1])] - 1
            io[name] = (1, 0, 1) if j % 2 == 0 else (1, 1, 2 if last else 1)
        elif parts[0].startswith("YoloBlock"):
            i = int(parts[1].rsplit("_", 1)[1])
            first = parts[0] == "YoloBlock_0"
            io[name] = {0: (2 if first else 1, 0, 2), 1: (2, 0, 2),
                        2: (2, 0, 1), 3: (1, 0, 2), 4: (2, 0, 3),
                        5: (1, 0, 2)}[i]
        else:
            io[name] = (2, 0, 2)
    return io


def int8_core_bound_s(model: dict, batch: int) -> float:
    """The least time, in seconds, of one call's convs on the sm90 core at
    `batch`: for each, the larger of its int8 operations at the int8 peak
    and its bytes (input, residual, s8 weights, the float32 epilogue rows,
    outputs) at the HBM rate."""
    io = int8_core_io(model)
    total = 0.0
    for name, h, w, ci, co, k, s in conv_layers(model):
        if name not in io:
            continue
        xin, res, out = io[name]
        oh, ow = -(-h // s), -(-w // s)
        nbytes = (batch * h * w * ci * xin + k * k * co * ci + 3 * co * 4
                  + batch * oh * ow * co * (res + out))
        ops = 2 * conv_macs(batch, h, w, ci, co, k, s)
        total += max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S["int8"])
    return total
