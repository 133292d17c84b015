"""The int8 stem region (stem2 -> FeatureBlock_0 -> exit conv) as one
kernel: the CUDA kernel's wrapper and its plain version.

Replaces `yolov3_tpu/ops/pallas/s2d_region_kernel.py::s2d_region_block_q`
with its epilogue variants (exact, `fast`, `affine2`) and its inputs
(stem1's s8 or float output; with `rawimg`, the z-scored image, stem1
then running in the kernel). The TPU kernel runs on the space-to-depth
view of the stem; here the same function runs in the plain NHWC layout,
where each lifted convolution is the plain one with SAME padding. From
stem1's output x to FeatureBlock_1's s8 input:

    q1  = x, or clip(round(x * inv_in)) for a bf16/f32 x  ConvBlock_1's scale
    q2  = stage(conv3x3/2(q1, w_s2), epi rows 13-16)     stem2
    q3  = stage(conv1x1(q2, w_pw),   rows 0-3)           FB0 1x1
    q4  = fb0(conv3x3(q3, w_fb0), q2, rows 4-8)          FB0 3x3 + residual
    out = stage(conv3x3/2(q4, w_exit), rows 9-12)        exit conv

    exact stage: y = leaky(acc + b) * m + a; [cast_bf16] bf16(y);
                 q = clip(round(y * inv))
    exact fb0:   z as a stage's y; y = bf16(bf16(q2 * s2) + z) (casts with
                 cast_bf16); q = clip(round(y * 1/s4))
    fast stage:  y = max(y, alpha*y), 1/s folded into m and a;
                 q = clip(round(y * m + a))
    fast fb0:    q = clip(round(z * m + a + q2 * (s2/s4)))
    affine2:     stem2, pw: q = clip(round(max(acc*m1 + c1, acc*m2 + c2)));
                 fb0: the same max + q2 * r before the rounding; the exit
                 as `fast` (`ops/quant.py::region_epi_affine2`, whose
                 sign-flipped channels the caller's weights compensate)

With `w_s1` (`rawimg`), x is the z-scored image [N, H, W, ci] in the
model dtype and q1 is stem1 (3x3, SAME, weights [9, c1, ci]) computed in
the kernel: its sums in f32 over the taps (u, v, channel) in that order,
each product and add rounded on its own (a bf16 product is exact in f32),
rounded to bf16 with `cast_bf16`, then bias, LeakyReLU, BatchNorm and the
quantize to ConvBlock_1's scale with epi rows 17-20 (a stage's exact or
`fast` epilogue, by `fast`; `ops/quant.py::with_stem1`).

Off-image pixels of q3 are zero (FB0's zero padding) and so is the exit's
bottom/right pad of q4: in the plain layout both are the convolutions' own
zero padding. The epi table is `ops/quant.py::region_epi`. The kernel
quantizes a float x while it loads its tile, so stem1's output never goes
to device memory as s8; with `rawimg` stem1's output never goes to
device memory at all.

The kernel is `csrc/s2d_region_block_q.cu` (persistent blocks with the
weights resident in shared memory, wgmma for the four stages); a CUDA
tensor goes through it or the wrapper raises, a CPU tensor goes through
`s2d_region_block_q_plain`. `s2d_tail_q` is the same kernel entered at q2.
`s2d_region_block_q_mma` is the same contract on the first design (one
block a tile, mma.sync; the exact and `fast` epilogues on stem1's
output only), for A/B timing only: no serving path calls it. A launch is
counted under `variant(affine2, rawimg)`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops.kernels import _build, _conv_q

NAME = "s2d_region_block_q"
TWIN = "_mma"  # the first design's entries: NAME + TWIN, tail + TWIN
F32 = torch.float32
# shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
# bytes after each pixel's channels and each weight row in the first
# design's shared memory (csrc kPad)
_PAD = 16
TILES = (8, 4, 2, 1)
_fns = {}


def weight_bytes(taps: int, n: int, k: int) -> int:
    """A stage's resident weights: [taps][K in 32-byte steps][n][32]."""
    return taps * -(-k // 32) * n * 32


def smem_bytes(tile: int, c1: int, c: int, cm: int, co: int,
               region: bool, e: int = 0, twin: bool = False,
               ci: int = 0) -> int:
    """Shared memory of one block at output tile `tile` x `tile` (e: the
    epi table's width, default the widest stage; ci > 0: the image's
    channels of the `rawimg` kernel).

    The kernel (`csrc/s2d_region_block_q.cu::layout90`): 1 KB of
    alignment slack; the four stages' weights (stem2's for the region
    only), resident for all of the block's tiles; q2, the input tile with
    its halo (region only), q3 and q4, each pixel's channels unpadded; the
    epi table. With `ci`: stem1's f32 weights after the others, and one
    buffer that holds the x tile and the f32 image patch ((4T+9)^2 pixels)
    while stem1 and stem2 run, then q3 and q4; the table has 21 rows.
    With `twin`, the first design's (`layout`): one buffer that first
    holds the input tile and stem2's weights (region only), then FB0's
    3x3 and the exit's weights; the 1x1's weights; q2, q3 and q4 with 16
    bytes after each pixel's channels; the epi table."""
    xw, qw, q4w = 4 * tile + 7, 2 * tile + 3, 2 * tile + 1
    rows = (21 if ci else 17) if region else 13
    epi = rows * (e or max(c, cm, co, c1 if ci else 0)) * 4
    if twin:
        first = (xw * xw * (c1 + _PAD) + 9 * c * (c1 + _PAD) if region
                 else 0)
        second = 9 * c * (cm + _PAD) + 9 * co * (c + _PAD)
        return (max(first, second) + cm * (c + _PAD) + qw * qw * (c + _PAD)
                + qw * qw * (cm + _PAD) + q4w * q4w * (c + _PAD) + epi)
    weights = ((weight_bytes(9, c, c1) if region else 0)
               + weight_bytes(1, cm, c) + weight_bytes(9, c, cm)
               + weight_bytes(9, co, c))
    if ci:
        stem1 = 9 * ci * c1 * 4
        shared = max(xw * xw * c1 + (xw + 2) ** 2 * ci * 4,
                     qw * qw * cm + q4w * q4w * c)
        return 1024 + weights + stem1 + qw * qw * c + -(-shared // 16) * 16 \
            + epi
    acts = (qw * qw * c + (xw * xw * c1 if region else 0) + qw * qw * cm
            + q4w * q4w * c)
    return 1024 + weights + acts + epi


def plan_tile(c1: int, c: int, cm: int, co: int, region: bool = True,
              e: int = 0, twin: bool = False, ci: int = 0) -> int:
    """The largest output tile whose block fits in shared memory (the
    kernel's layout, the `rawimg` kernel's with `ci`, or the first
    design's with `twin`), or 0 when the channels are not what the kernel
    takes (multiples of 16; the image's 1 to 4)."""
    if any(ch <= 0 or ch % 16 for ch in (c1 if region else 16, c, cm, co)):
        return 0
    if ci and (twin or not region or ci > MAX_IMAGE_CHANNELS):
        return 0
    for tile in TILES:
        if smem_bytes(tile, c1, c, cm, co, region, e, twin, ci) <= SMEM_LIMIT:
            return tile
    return 0


def variant(affine2: bool = False, rawimg: bool = False) -> str:
    """The name a region launch is counted under: NAME, with `_rawimg`
    and `_affine2` for those modes."""
    return NAME + ("_rawimg" if rawimg else "") + ("_affine2" if affine2
                                                   else "")


def stage_plain(acc: torch.Tensor, rows: torch.Tensor, *, alpha: float,
                cast_bf16: bool, fast: bool,
                affine2: bool = False) -> torch.Tensor:
    """A conv stage's epilogue and requantize on exact sums `acc`; rows
    [4, >= Co] = (b, m, a, inv), or with `affine2` (m1, c1, m2, c2)."""
    co = acc.shape[-1]
    b, m, a, inv = (r[:co] for r in rows)
    if affine2:
        y = acc.to(F32)
        y = torch.maximum(y * b + m, y * a + inv)
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    if fast:
        y = acc.to(F32) + b
        y = torch.maximum(y, alpha * y)
        return torch.clamp(torch.round(y * m + a), -127, 127).to(torch.int8)
    return _conv_q.epilogue(acc, torch.stack([b, m, a]), inv_next=inv,
                            alpha=alpha, cast_bf16=cast_bf16)


def tail_plain(q2: torch.Tensor, w_pw: torch.Tensor, w_fb0: torch.Tensor,
               w_exit: torch.Tensor, epi: torch.Tensor, *, alpha: float,
               cast_bf16: bool, fast: bool, affine2: bool = False,
               sums=_conv_q.conv_sums) -> torch.Tensor:
    """pw -> FB0 3x3 + residual -> exit from q2 (stem2's s8 output);
    `sums(q, w_t, ksize, stride)` gives each stage's exact sums. With
    `affine2` the exit runs the fast epilogue."""
    kw = dict(alpha=alpha, cast_bf16=cast_bf16, fast=fast)
    q3 = stage_plain(sums(q2, w_pw, 1, 1), epi[0:4], affine2=affine2, **kw)
    acc = sums(q3, w_fb0, 3, 1)
    c = acc.shape[-1]
    b, m, a, r, inv = (row[:c] for row in epi[4:9])
    if affine2:
        # rows m1, c1, m2, c2, r
        y = acc.to(F32)
        y = torch.maximum(y * b + m, y * a + r) + q2.to(F32) * inv
        q4 = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    elif fast:
        z = acc.to(F32) + b
        z = torch.maximum(z, alpha * z)
        y = z * m + a + q2.to(F32) * r
        q4 = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    else:
        q4 = _conv_q.epilogue(acc, torch.stack([b, m, a]), inv_next=inv,
                              alpha=alpha, cast_bf16=cast_bf16,
                              residual_out=q2, res_scale=r)
    return stage_plain(sums(q4, w_exit, 3, 2), epi[9:13],
                       **dict(kw, fast=fast or affine2))


def stem1_plain(img: torch.Tensor, w_s1: torch.Tensor, rows: torch.Tensor,
                *, alpha: float, cast_bf16: bool,
                fast: bool) -> torch.Tensor:
    """stem1 as the `rawimg` kernel computes it: the 3x3 SAME conv of the
    image [N, H, W, ci] with w_s1 [9, c1, ci], summed in f32 over (u, v,
    channel) in that order, each product and add rounded on its own;
    [cast_bf16] bf16; then rows 17-20 (b, m, a, inv) as a stage's exact
    or fast epilogue. Returns s8 [N, H, W, c1]."""
    n, h, w, ci = img.shape
    x = F.pad(img.to(F32), (0, 0, 1, 1, 1, 1))
    wf = w_s1.to(F32)
    acc = torch.zeros((n, h, w, wf.shape[1]), dtype=F32, device=img.device)
    for u in range(3):
        for v in range(3):
            for k in range(ci):
                acc = acc + x[:, u:u + h, v:v + w, k:k + 1] * wf[3 * u + v,
                                                                 :, k]
    if cast_bf16:
        acc = _conv_q._bf16_round(acc)
    return stage_plain(acc, rows, alpha=alpha, cast_bf16=cast_bf16,
                       fast=fast)


def s2d_region_block_q_plain(x: torch.Tensor, w_s2: torch.Tensor,
                             w_pw: torch.Tensor, w_fb0: torch.Tensor,
                             w_exit: torch.Tensor, epi: torch.Tensor, *,
                             alpha: float, cast_bf16: bool,
                             fast: bool = False,
                             inv_in: Optional[float] = None,
                             affine2: bool = False,
                             w_s1: Optional[torch.Tensor] = None,
                             sums=_conv_q.conv_sums) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (exact int32 sums from
    `sums`, the four stages one after another; stem1 first with
    `w_s1`)."""
    check(x, (w_s2, w_pw, w_fb0, w_exit), epi, 17, inv_in, w_s1)
    kw = dict(alpha=alpha, cast_bf16=cast_bf16, fast=fast)
    if w_s1 is None:
        q1 = _conv_q.quantized_input(x, inv_in)
    else:
        q1 = stem1_plain(x, w_s1, epi[17:21], **kw)
    q2 = stage_plain(sums(q1, w_s2, 3, 2), epi[13:17], affine2=affine2,
                     **kw)
    return tail_plain(q2, w_pw, w_fb0, w_exit, epi, affine2=affine2,
                      sums=sums, **kw)


# the input types the region's kernel takes (csrc InKind); the image of
# the `rawimg` kernel is a kind of its own
X_KINDS = {torch.int8: 0, torch.bfloat16: 1, F32: 2}
IMAGE_KINDS = {torch.bfloat16: 3, F32: 4}
# the image channels the `rawimg` kernel takes (csrc kMaxImageChannels)
MAX_IMAGE_CHANNELS = 4


def check(x: torch.Tensor, weights, epi: torch.Tensor, rows: int,
          inv_in: Optional[float] = None,
          w_s1: Optional[torch.Tensor] = None) -> None:
    """The shapes and types the region's and the tail's contracts take:
    x NHWC, s8 (the region also takes bf16 or f32 with `inv_in`, or with
    `w_s1` the bf16 or f32 image), weights [taps, Co, Ci] s8 chained stage
    to stage, epi [rows (21 with w_s1), >= max Co] f32."""
    kinds = (torch.int8,) if rows == 13 else tuple(X_KINDS)
    if w_s1 is not None:
        kinds = tuple(IMAGE_KINDS)
        rows = 21
        if (w_s1.dtype != x.dtype or w_s1.dim() != 3 or w_s1.shape[0] != 9
                or w_s1.shape[2] != x.shape[-1]
                or w_s1.shape[1] != weights[0].shape[2]):
            raise ValueError(f"stem1's weights {tuple(w_s1.shape)} "
                             f"{w_s1.dtype} do not take the {x.dtype} "
                             f"image {tuple(x.shape)}")
        if inv_in is not None:
            raise ValueError("the image is not quantized: no inv_in")
    if x.dtype not in kinds or x.dim() != 4:
        raise TypeError(f"the stem region takes an NHWC x of {kinds}, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if w_s1 is None and x.dtype != torch.int8 and inv_in is None:
        raise ValueError(f"a {x.dtype} x needs inv_in, the 1/s it is "
                         f"quantized with")
    ci = x.shape[-1] if w_s1 is None else w_s1.shape[1]
    for w, taps in zip(weights, (9, 1, 9, 9)[-len(weights):]):
        if w.dtype != torch.int8 or w.dim() != 3 or w.shape[0] != taps \
                or w.shape[2] != ci:
            raise ValueError(f"weights {tuple(w.shape)} {w.dtype} do not "
                             f"take {ci} channels in {taps} taps")
        ci = w.shape[1]
    widest = max([w.shape[1] for w in weights]
                 + ([w_s1.shape[1]] if w_s1 is not None else []))
    if epi.dtype != F32 or epi.dim() != 2 or epi.shape[0] != rows \
            or epi.shape[1] < widest:
        raise ValueError(f"epi must be f32 [{rows}, >= {widest}], got "
                         f"{epi.dtype} {tuple(epi.shape)}")


def launch(name: str, x: torch.Tensor, weights, epi: torch.Tensor, *,
           alpha: float, cast_bf16: bool, fast: bool = False,
           inv_in: Optional[float] = None, twin: bool = False,
           affine2: bool = False, w_s1: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Launch the region (4 weights) or the tail (3) on CUDA tensors, on
    the first design's entry (name + TWIN, counted under it) with `twin`;
    raises on what the kernel does not take."""
    region = len(weights) == 4
    rawimg = w_s1 is not None
    if (affine2 or rawimg) and (twin or not region):
        raise ValueError(f"{name}: affine2 and rawimg are modes of the "
                         f"region's kernel only")
    tensors = (x, *weights, epi) + ((w_s1,) if rawimg else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                         f"aligned")
    n, h, w, cin = x.shape
    step = 4 if region else 2
    if h % step or w % step:
        raise ValueError(f"{name}: H = {h} and W = {w} must be multiples of "
                         f"{step}")
    c1 = (w_s1.shape[1] if rawimg else cin) if region else 0
    c = weights[0].shape[1] if region else cin
    cm, co = weights[-3].shape[1], weights[-1].shape[1]
    ci = cin if rawimg else 0
    tile = plan_tile(c1, c, cm, co, region, epi.shape[1], twin, ci)
    if tile == 0:
        raise ValueError(f"{name}: channels {c1, c, cm, co} (image {ci}) "
                         f"must be multiples of 16 (1 to "
                         f"{MAX_IMAGE_CHANNELS}) and fit in shared memory")
    out = torch.empty((n, h // step, w // step, co), dtype=torch.int8,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = name + TWIN if twin else name
    fn = _kernel_fn(entry, region)
    ptrs = [t.data_ptr() for t in (x, *weights, epi)]
    if region:
        kind = IMAGE_KINDS[x.dtype] if rawimg else X_KINDS[x.dtype]
        err = fn(ptrs[0], kind, 1.0 if inv_in is None else float(inv_in),
                 *ptrs[1:], epi.shape[0], epi.shape[1], out.data_ptr(), n, h,
                 w, c1, c, cm, co, tile, float(alpha), int(cast_bf16),
                 int(fast), w_s1.data_ptr() if rawimg else None, ci,
                 int(affine2), stream)
    else:
        err = fn(*ptrs, epi.shape[0], epi.shape[1], out.data_ptr(), n, h, w,
                 c, cm, co, tile, float(alpha), int(cast_bf16), stream)
    _build.check(err, entry)
    count = entry if not region or twin else variant(affine2, rawimg)
    _build.launch_counts[count] += 1
    return out


def _kernel_fn(entry: str, region: bool):
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load(NAME), entry)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if region:
            fn.argtypes = [p, i, f] + [p] * 5 + [i, i, p] + [i] * 8 + [
                f, i, i, p, i, i, p]
        else:
            fn.argtypes = [p] * 5 + [i, i, p] + [i] * 7 + [f, i, p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def s2d_region_block_q(x: torch.Tensor, w_s2: torch.Tensor,
                       w_pw: torch.Tensor, w_fb0: torch.Tensor,
                       w_exit: torch.Tensor, epi: torch.Tensor, *,
                       alpha: float, cast_bf16: bool, fast: bool = False,
                       inv_in: Optional[float] = None, affine2: bool = False,
                       w_s1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N,H,W,c1] (stem1's output; H, W multiples of 4): s8 at
    ConvBlock_1's scale, or bf16/f32 with inv_in = 1/s of that scale
    (`ops/quant.py::reciprocal`); w_s2 [9, c, c1], w_pw [1, cm, c], w_fb0
    [9, c, cm], w_exit [9, co, c] s8 ((u, v) major); epi f32 [17, >= max(c,
    cm, co)] (`region_epi`, or with `affine2` `region_epi_affine2` and the
    weights it flips). With w_s1 [9, c1, ci] (bf16 or f32, the image's
    type), x is the z-scored image [N, H, W, ci] and epi has stem1's rows
    17-20 (`with_stem1`). Returns s8 [N, H/4, W/4, co] at
    FeatureBlock_1/ConvBlock_0's scale."""
    kw = dict(alpha=alpha, cast_bf16=cast_bf16, fast=fast, inv_in=inv_in,
              affine2=affine2, w_s1=w_s1)
    if x.device.type == "cpu":
        return s2d_region_block_q_plain(x, w_s2, w_pw, w_fb0, w_exit, epi,
                                        **kw)
    check(x, (w_s2, w_pw, w_fb0, w_exit), epi, 17, inv_in, w_s1)
    return launch(NAME, x, (w_s2, w_pw, w_fb0, w_exit), epi, **kw)


def s2d_region_block_q_mma(x: torch.Tensor, w_s2: torch.Tensor,
                           w_pw: torch.Tensor, w_fb0: torch.Tensor,
                           w_exit: torch.Tensor, epi: torch.Tensor, *,
                           alpha: float, cast_bf16: bool, fast: bool = False,
                           inv_in: Optional[float] = None) -> torch.Tensor:
    """`s2d_region_block_q` on the first design's kernel (CUDA tensors
    only): the A/B twin of the kernel."""
    check(x, (w_s2, w_pw, w_fb0, w_exit), epi, 17, inv_in)
    return launch(NAME, x, (w_s2, w_pw, w_fb0, w_exit), epi, alpha=alpha,
                  cast_bf16=cast_bf16, fast=fast, inv_in=inv_in, twin=True)
