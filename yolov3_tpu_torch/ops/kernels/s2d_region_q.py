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
`fast` epilogue, by `fast`; `ops/quant.py::with_stem1`). For a bf16 image
the kernel sums stem1 on the tensor cores, in their own order, and takes
again in the plain order the few sums whose bf16 rounding, and code, that
order could change (`stem1_gemm_plain` is this route in plain PyTorch);
for an f32 image, and on `s2d_region_block_q_cores`, on CUDA cores in the
plain order.

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
output only), and `s2d_region_block_q_cores` the `rawimg` mode with stem1
on CUDA cores (the mode's first design), both for A/B timing only: no
serving path calls them. A launch is counted under `variant(affine2,
rawimg)`, on `_cores` with CORES after it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops.kernels import _build, _conv_q

NAME = "s2d_region_block_q"
TWIN = "_mma"  # the first design's entries: NAME + TWIN, tail + TWIN
CORES = "_cores"  # the rawimg mode with stem1 on CUDA cores: NAME + CORES
F32 = torch.float32
# shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
# the stem1 sums a tile's queue holds on tensor cores (csrc kRedo)
REDO = 1024
# bytes after each pixel's channels and each weight row in the first
# design's shared memory (csrc kPad)
_PAD = 16
TILES = (8, 4, 2, 1)
_fns = {}


def weight_bytes(taps: int, n: int, k: int) -> int:
    """A stage's resident weights: [taps][K in 32-byte steps][n][32]."""
    return taps * -(-k // 32) * n * 32


def patch_reads(side: int, ci: int) -> int:
    """The elements of a bf16 image patch row that stem1 on tensor cores
    reads: `side` pixels of ci channels, and the last A row's 16 elements
    from pixel side - 3 (csrc `patch_reads`)."""
    return max(side * ci, (side - 3) * ci + 16)


def patch_pitch(side: int, ci: int) -> int:
    """Bytes of a bf16 image patch row in shared memory: its first byte's
    offset in its 16-byte chunk (< 16) and the elements read, in whole
    chunks (csrc `patch_pitch`)."""
    return -(-(15 + 2 * patch_reads(side, ci)) // 16) * 16


def smem_bytes(tile: int, c1: int, c: int, cm: int, co: int,
               region: bool, e: int = 0, twin: bool = False,
               ci: int = 0, cores: bool = False) -> int:
    """Shared memory of one block at output tile `tile` x `tile` (e: the
    epi table's width, default the widest stage; ci > 0: the image's
    channels of the `rawimg` kernel, stem1 on tensor cores unless
    `cores`).

    The kernel (`csrc/s2d_region_block_q.cu::layout90`): 1 KB of
    alignment slack; the four stages' weights (stem2's for the region
    only), resident for all of the block's tiles; q2, the input tile with
    its halo (region only), q3 and q4, each pixel's channels unpadded; the
    epi table. With `ci`: stem1's weights after the others (bf16 packed
    [3][c1][16], then their magnitudes, or f32 with `cores`); one buffer that holds the x tile
    while stem1 and stem2 run, then q3 and q4; then the bf16 image patch,
    (4T+9) rows of `patch_pitch` bytes, which the next tile's copy fills
    while this one's stages run, and the queue of the stem1 sums taken
    again (16 + 4 REDO bytes); with `cores` the f32 patch ((4T+9)^2
    pixels) shares the first buffer with the x tile instead. The table has
    21 rows. With `twin`, the first design's (`layout`): one buffer that
    first holds the input tile and stem2's weights (region only), then FB0's
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
        stem1 = 9 * ci * c1 * 4 if cores else 2 * weight_bytes(3, c1, 32)
        x = xw * xw * c1 + ((xw + 2) ** 2 * ci * 4 if cores else 0)
        shared = -(-max(x, qw * qw * cm + q4w * q4w * c) // 16) * 16
        # the patch and the queue of stem1 sums taken again
        patch = 0 if cores else ((xw + 2) * patch_pitch(xw + 2, ci)
                                 + 16 + 4 * REDO)
        return 1024 + weights + stem1 + qw * qw * c + shared + patch + epi
    acts = (qw * qw * c + (xw * xw * c1 if region else 0) + qw * qw * cm
            + q4w * q4w * c)
    return 1024 + weights + acts + epi


def plan_tile(c1: int, c: int, cm: int, co: int, region: bool = True,
              e: int = 0, twin: bool = False, ci: int = 0,
              cores: bool = False) -> int:
    """The largest output tile whose block fits in shared memory (the
    kernel's layout, the `rawimg` kernel's with `ci`, stem1 on CUDA cores
    with `cores`, or the first design's with `twin`), or 0 when the
    channels are not what the kernel takes (multiples of 16; the image's
    1 to 4)."""
    if any(ch <= 0 or ch % 16 for ch in (c1 if region else 16, c, cm, co)):
        return 0
    if ci and (twin or not region or ci > MAX_IMAGE_CHANNELS):
        return 0
    for tile in TILES:
        if smem_bytes(tile, c1, c, cm, co, region, e, twin, ci,
                      cores) <= SMEM_LIMIT:
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


def stem1_sums(img: torch.Tensor, w_s1: torch.Tensor) -> torch.Tensor:
    """stem1's f32 sums [N, H, W, c1] as the plain version takes them: the
    3x3 SAME conv of the image with w_s1 [9, c1, ci] over (u, v, channel)
    in that order, each product and add rounded on its own."""
    n, h, w, ci = img.shape
    x = F.pad(img.to(F32), (0, 0, 1, 1, 1, 1))
    wf = w_s1.to(F32)
    acc = torch.zeros((n, h, w, wf.shape[1]), dtype=F32, device=img.device)
    for u in range(3):
        for v in range(3):
            for k in range(ci):
                acc = acc + x[:, u:u + h, v:v + w, k:k + 1] * wf[3 * u + v,
                                                                 :, k]
    return acc


def stem1_plain(img: torch.Tensor, w_s1: torch.Tensor, rows: torch.Tensor,
                *, alpha: float, cast_bf16: bool,
                fast: bool) -> torch.Tensor:
    """stem1 as the `rawimg` kernel computes it: the 3x3 SAME conv of the
    image [N, H, W, ci] with w_s1 [9, c1, ci], summed in f32 over (u, v,
    channel) in that order, each product and add rounded on its own;
    [cast_bf16] bf16; then rows 17-20 (b, m, a, inv) as a stage's exact
    or fast epilogue. Returns s8 [N, H, W, c1]."""
    acc = stem1_sums(img, w_s1)
    if cast_bf16:
        acc = _conv_q._bf16_round(acc)
    return stage_plain(acc, rows, alpha=alpha, cast_bf16=cast_bf16,
                       fast=fast)


def pack_stem1(w_s1: torch.Tensor) -> torch.Tensor:
    """stem1's weights [9, c1, ci] as the tensor-core route's B operand
    [3, c1, 16]: tap row u's row o holds w_s1[3u + v, o, cc] at k = v * ci
    + cc and zeros from k = 3 ci on, where a pixel's A row runs on into the
    next pixels (csrc `pack_stem1`, before its swizzle)."""
    _, c1, ci = w_s1.shape
    b = w_s1.new_zeros((3, c1, 16))
    for u in range(3):
        for v in range(3):
            b[u, :, v * ci:(v + 1) * ci] = w_s1[3 * u + v]
    return b


# the tensor cores' stem1 sum and the plain version's lie within this
# fraction of the sum of the products' magnitudes (csrc kDoubt)
STEM1_DOUBT = 2.0 ** -21


def stem1_gemm_plain(img: torch.Tensor, w_s1: torch.Tensor,
                     rows: torch.Tensor, *, alpha: float, cast_bf16: bool,
                     fast: bool, tile: int) -> torch.Tensor:
    """stem1 as the kernel runs it on tensor cores (`csrc/
    s2d_region_block_q.cu::stem1_tc`), in plain PyTorch, output tile by
    output tile (`tile` x `tile`; stem1 pixels 4R0-2 .. 4R0+4T+4):

    - the image patch (rows 4R0-3 .. 4R0+4T+5) in a buffer of (4T+9)
      rows of `patch_pitch` bytes, each image row copied as the 16-byte
      chunks of the image's bytes that cover it (`copy_patch`), placed at
      the row's first byte's offset in its chunk; a patch that runs off
      the image has every byte outside its on-image pixels zeroed
      (`fix_patch`);
    - pixel (i, j)'s A row for tap row u: the 16 elements from pixel j of
      patch row i + u; K = 3 x 16 against `pack_stem1`'s weights, summed
      in f32 in matmul's order, and the products' magnitudes summed too;
    - with `cast_bf16`, a sum whose bf16 rounding the plain order could
      change (within STEM1_DOUBT of the magnitudes' sum from the midpoint
      between its two bf16 neighbours lo and hi, or that far from a
      quarter of their step) and whose code differs from lo to hi is
      taken in the plain order instead (the sums `stem1_plain` takes);
      without the cast every sum is;
    - the epilogue as `stem1_plain`'s.

    So its codes are `stem1_plain`'s.

    The buffer starts each tile, and the image's last 16-byte block ends,
    with NaN bytes, so a read of bytes the tile did not copy or zero (the
    kernel's buffer holds an earlier tile's there) shows; every chunk is
    checked to lie in the image's 16-byte blocks. The kernel takes a bf16
    image; the same index arithmetic runs here at the image's element
    size. Returns s8 [N, H, W, c1]."""
    n, h, w, ci = img.shape
    c1 = w_s1.shape[1]
    es = img.element_size()
    side = 4 * tile + 9
    reads = patch_reads(side, ci)
    pitch = -(-(15 + es * reads) // 16) * 16
    mem = img.contiguous().view(torch.uint8).reshape(-1).numpy()
    mem = np.concatenate([mem, np.full(-mem.size % 16, 255, np.uint8)])
    buf = np.full((side, pitch), 255, np.uint8)
    b = pack_stem1(w_s1.to(F32)).permute(0, 2, 1).reshape(48, c1)
    out = torch.zeros((n, h, w, c1), dtype=torch.int8)
    kw = dict(alpha=alpha, cast_bf16=cast_bf16, fast=fast)
    plain = stem1_sums(img, w_s1)
    row_i, col_j = np.divmod(np.arange((side - 2) ** 2), side - 2)
    k16 = np.arange(16)
    finite = bool(torch.isfinite(img).all())
    for im in range(n):
        base = im * h * w * ci * es
        for r0 in range(-3, h // 4 * 4 - 3, 4 * tile):
            for c0 in range(-3, w // 4 * 4 - 3, 4 * tile):
                edge = r0 < 0 or c0 < 0 or r0 + side > h or c0 + side > w
                buf[:] = 255  # an earlier tile's bytes: read none
                first = np.zeros(side, np.int64)
                for i in range(side):
                    s = ((r0 + i) * w + c0) * ci * es
                    first[i] = s % 16
                    if not 0 <= r0 + i < h:
                        continue
                    lo, hi = s, s + es * reads
                    if edge:
                        lo = s + ci * es * max(0, -c0)
                        hi = s + ci * es * min(side, w - c0)
                    for g in range(lo // 16 * 16, hi, 16):
                        dst = g - s // 16 * 16
                        if not (0 <= base + g and base + g + 16 <= mem.size
                                and 0 <= dst and dst + 16 <= pitch):
                            raise AssertionError(f"chunk {g} of row {i}")
                        buf[i, dst:dst + 16] = mem[base + g:base + g + 16]
                if edge:
                    for i in range(side):
                        lo = first[i] + ci * es * max(0, -c0)
                        hi = first[i] + ci * es * min(side, w - c0)
                        if not 0 <= r0 + i < h:
                            lo = hi = pitch
                        buf[i, :lo] = 0
                        buf[i, hi:] = 0
                flat = torch.from_numpy(buf.reshape(-1).copy()).view(
                    img.dtype)
                start = ((row_i[:, None] + np.arange(3)) * pitch
                         + first[row_i[:, None] + np.arange(3)]) // es \
                    + (ci * col_j)[:, None]
                idx = torch.from_numpy(start[:, :, None] + k16)
                a = flat[idx].reshape(-1, 48).to(F32)
                acc, mag = a @ b, a.abs() @ b.abs()
                if finite and not bool(torch.isfinite(acc).all()):
                    raise AssertionError("a read the zero weights do not "
                                         "cancel")
                gr, gc = r0 + 1 + row_i, c0 + 1 + col_j
                on = (gr >= 0) & (gr < h) & (gc >= 0) & (gc < w)
                redo = torch.ones_like(acc, dtype=torch.bool)
                if cast_bf16:
                    t = acc.view(torch.int32) & -65536
                    mid = (t | 0x8000).view(F32)
                    lo, hi = t.view(F32), (t + 0x10000).view(F32)
                    delta = mag * STEM1_DOUBT
                    far = (mid - lo).abs() <= 2 * delta
                    redo = (far | ((acc - mid).abs() <= delta)) & (
                        far | (stage_plain(lo, rows, **kw)
                               != stage_plain(hi, rows, **kw)))
                seq = plain[im, torch.from_numpy(gr.clip(0, h - 1)),
                            torch.from_numpy(gc.clip(0, w - 1))]
                acc = torch.where(redo, seq, acc)
                if cast_bf16:
                    acc = _conv_q._bf16_round(acc)
                q = stage_plain(acc, rows, **kw)
                out[im, torch.from_numpy(gr[on]),
                    torch.from_numpy(gc[on])] = q[torch.from_numpy(on)]
    return out


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
           affine2: bool = False, w_s1: Optional[torch.Tensor] = None,
           cores: bool = False) -> torch.Tensor:
    """Launch the region (4 weights) or the tail (3) on CUDA tensors, on
    the first design's entry (name + TWIN, counted under it) with `twin`,
    on the entry with stem1 on CUDA cores (name + CORES) with `cores`;
    raises on what the kernel does not take."""
    region = len(weights) == 4
    rawimg = w_s1 is not None
    if (affine2 or rawimg) and (twin or not region):
        raise ValueError(f"{name}: affine2 and rawimg are modes of the "
                         f"region's kernel only")
    if cores and not rawimg:
        raise ValueError(f"{name}: stem1 on CUDA cores is the rawimg "
                         f"mode's")
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
    # stem1 on tensor cores for a bf16 image, else on CUDA cores
    stem1_cores = rawimg and (cores or x.dtype != torch.bfloat16)
    tile = plan_tile(c1, c, cm, co, region, epi.shape[1], twin, ci,
                     stem1_cores)
    if tile == 0:
        raise ValueError(f"{name}: channels {c1, c, cm, co} (image {ci}) "
                         f"must be multiples of 16 (1 to "
                         f"{MAX_IMAGE_CHANNELS}) and fit in shared memory")
    out = torch.empty((n, h // step, w // step, co), dtype=torch.int8,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = name + TWIN if twin else name + CORES if cores else name
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
    count = (entry if not region or twin
             else variant(affine2, rawimg) + (CORES if cores else ""))
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


def s2d_region_block_q_cores(x: torch.Tensor, w_s2: torch.Tensor,
                             w_pw: torch.Tensor, w_fb0: torch.Tensor,
                             w_exit: torch.Tensor, epi: torch.Tensor, *,
                             alpha: float, cast_bf16: bool,
                             w_s1: torch.Tensor, fast: bool = False,
                             inv_in: Optional[float] = None,
                             affine2: bool = False) -> torch.Tensor:
    """`s2d_region_block_q`'s `rawimg` mode with stem1 on CUDA cores, summed
    in the plain version's order (CUDA tensors only; the region's
    arguments, an image taking no inv_in): the mode's first design, its
    A/B twin, code for code `s2d_region_block_q_plain`."""
    check(x, (w_s2, w_pw, w_fb0, w_exit), epi, 17, inv_in, w_s1)
    return launch(NAME, x, (w_s2, w_pw, w_fb0, w_exit), epi, alpha=alpha,
                  cast_bf16=cast_bf16, fast=fast, affine2=affine2, w_s1=w_s1,
                  cores=True)
