"""What the int8 ConvBlock kernels share: the plain PyTorch version of
their arithmetic, the tile plan of the Hopper core, and the ctypes launch
of their CUDA entry points.

The 1x1, 3x3, stride-2 and exit kernels (`csrc/pointwise_conv_block_q.cu`,
`conv3x3_block_q.cu`, `down_conv_block_q.cu`, `exit_conv_block_q.cu`) run
one wgmma + TMA implicit GEMM (`csrc/conv_gemm_q_sm90.cuh`) under the
tile plan `conv_plan` picks per launch (the bf16 1x1 of `conv_block.py`
runs the same core with bf16 operands, planned here too); their `*_wmma`
entries (the same contracts on the first design, for A/B timing) run the
WMMA core (`csrc/conv_block_q.cuh`). Each has its own entry point and
contract. The modules `pointwise_q`, `conv3x3_q`, `down_conv_q` and
`exit_conv_q` are their public wrappers. Layouts: activations NHWC;
weights `w_t` [taps, Co, Ci] s8 (each output channel's K contiguous, the
kernels' B layout); `epi` [3, Co] f32 rows (b/dq, mul*dq, add), or
[4, Co] with 1/s_next per channel in row 3.

The plain version sums the int8 products in float64, which is exact
below 2^53 (the largest |acc| here is 9 * 1024 * 127^2 ~ 1.5e8), then runs
the float32 epilogue op by op in the kernels' order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from yolov3_tpu_torch.ops.kernels import _build
from yolov3_tpu_torch.ops.quant import quantize_act

F32 = torch.float32
BF16 = torch.bfloat16
IN_KINDS = {torch.int8: 0, BF16: 1, F32: 2}
# the kernels on the wgmma core; NAME + "_wmma" is the same contract on the
# WMMA core, in the same library
WGMMA_KERNELS = ("pointwise_conv_block_q", "conv3x3_block_q",
                 "down_conv_block_q", "exit_conv_block_q")
SMS = 132              # H100 SXM streaming multiprocessors
SMEM_BYTES = 232448    # shared memory a block can use
MAX_STAGES = 5
# elements a TMA box may span in one dimension; an s8 input's stride-2
# box spans twice the TH x TW it lands
BOX_MAX = 256
# a float input's ring stops at 4 stages: the shared memory left over
# serves as L1 for the converting producer's loads (each pixel of a 3x3 is
# read by nine taps), which beats a fifth stage on the H100 (PERF.md)
FLOAT_MAX_STAGES = 4
# a float input's A rows cost this many weight rows: the producer loads
# and quantizes them instead of one TMA copy (one of the four is the
# row's bytes from L2; at stride 2 a tile's nine taps share a quarter as
# many pixels through L1, each input pixel read by ~2.25 taps instead of
# 9, so those bytes count stride^2 times). A BM = 64 block has two
# converting producer warpgroups (the block is three warpgroups), which
# halves the cost of its rows.
FLOAT_A_COST = 4
# (pixels, channels) of a block's output tile
TILES = ((128, 256), (128, 128), (64, 256), (64, 128), (128, 64), (64, 64),
         (128, 32), (64, 32))
_fns = {}


class Plan(NamedTuple):
    """A wgmma launch's tiles: BM output pixels (a TH x TW rectangle of one
    output image for the 3x3s; TH = 1, TW = BM for the 1x1) x BN output
    channels,
    K steps of BK bytes (64 or 128, the TMA / wgmma swizzle span: 64 or
    128 s8 channels, 32 or 64 bf16 ones), and a ring of `stages` (A, B)
    tiles in shared memory."""
    bm: int
    bn: int
    bk: int
    th: int
    tw: int
    stages: int


def smem_bytes(plan: Plan, staged: bool = False) -> int:
    """Dynamic shared memory of a launch (csrc/conv_gemm_q_sm90.cuh::
    smem_bytes): 1 KB of alignment slack, the ring and its barriers, each
    consumer warpgroup's copy of the tile's four epilogue rows, and with
    `staged` (the s8 stride-2 path) the BM staged output rows of BN + 16
    bytes."""
    return (1024 + plan.stages * ((plan.bm + plan.bn) * plan.bk + 16)
            + plan.bm // 64 * 16 * plan.bn
            + (plan.bm * (plan.bn + 16) if staged else 0))


def staged(plan: Plan, float_in: bool = False, stride: int = 1) -> bool:
    """Whether a launch of the exit's s8 stride-2 path stages its s8 output
    in shared memory (csrc/conv_gemm_q_sm90.cuh::launch's rule): an s8
    input at stride 2, when the staged rows fit beside the ring."""
    return (stride == 2 and not float_in
            and smem_bytes(plan, True) <= SMEM_BYTES)


def plan_tiles(plan: Plan, n: int, h: int, w: int, co: int,
                ksize: int) -> int:
    """Output tiles of a launch under `plan` over an [n, h, w, co] output
    (the kernel runs min(tiles, SMS) persistent blocks that walk them)."""
    if ksize == 1:
        mtiles = -(-(n * h * w) // plan.bm)
    else:
        mtiles = n * -(-h // plan.th) * -(-w // plan.tw)
    return mtiles * -(-co // plan.bn)


def plan_cost(plan: Plan, n: int, h: int, w: int, ci: int, co: int,
              ksize: int, float_in: bool = False, esize: int = 1,
              stride: int = 1) -> int:
    """The plan's time in the planner's model: the bytes one SM streams
    from L2, K steps of (BM + BN) x BK bytes a tile (a float input's A
    rows FLOAT_A_COST times over, its L2 bytes stride^2 times, over its
    3 - BM/64 producer warpgroups; an s8 input's A rows once a tap at
    either stride, TMA landing only the pixels at the stride; `esize`
    bytes an operand), over
    ceil(tiles / SMS) tiles of the output. On the H100 every SM's stream
    runs at about the same rate whether or not the others are busy, so
    fewer, larger tiles win until they leave SMs idle."""
    steps = ksize * ksize * -(-(ci * esize) // plan.bk)
    waves = -(-plan_tiles(plan, n, -(-h // stride), -(-w // stride), co,
                          ksize) // SMS)
    a_rows = (plan.bm * (FLOAT_A_COST - 1 + stride * stride)
              // (3 - plan.bm // 64) if float_in else plan.bm)
    return waves * steps * (a_rows + plan.bn) * plan.bk


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, ci: int, co: int, ksize: int,
              float_in: bool = False, esize: int = 1,
              stride: int = 1) -> Plan:
    """The tile plan of a 1x1 (ksize 1) or 3x3 launch on the wgmma core,
    x [n, h, w, ci] with co output channels: s8 operands (`esize` 1) on an
    s8 x, or a bf16 / f32 one with `float_in`; or bf16 operands (`esize`
    2, a 1x1 on a bf16 x through TMA, channels in 8s). `stride` 2: a 3x3
    with s8 operands, on a float x (the converting producer) or an s8 one
    (TMA at element strides of 2).

    BK: 64 or 128 bytes, whichever pads Ci's bytes less (128 on a tie).
    Tile: of TILES with BN at most Co rounded up to 32, the least
    `plan_cost` (ties: the larger BM, or for a float input the smaller,
    whose two producer warpgroups measured faster on the H100 (PERF.md);
    then the larger BN). 3x3 rectangle: TW the
    power of two >= the output's W, at most BM (and BOX_MAX / stride);
    TH = BM / TW. Stages: as
    many as fit in SMEM_BYTES (beside the staged output rows of an s8
    input at stride 2), at most MAX_STAGES (FLOAT_MAX_STAGES for a float
    input).
    Cached: a serving call plans each of its ~64 launches again, and the
    search (~20 us of Python) would otherwise add to the host's
    dispatch."""
    if ksize not in (1, 3) or esize not in (1, 2) or stride not in (1, 2) or (
            esize == 2 and (ksize != 1 or float_in)) or (
            stride == 2 and (ksize != 3 or esize != 1)):
        raise ValueError(f"conv_plan: no {ksize}x{ksize} stride-{stride} "
                         f"kernel with {esize}-byte operands "
                         f"(float_in={float_in})")
    step = 16 // esize
    if min(n, h, w, ci, co) < 1 or ci % step or co % step:
        raise ValueError(f"conv_plan: x ({n}, {h}, {w}, {ci}) -> {co} needs "
                         f"positive sizes and channels multiple of {step}")
    kb = ci * esize
    bk = 64 if -(-kb // 64) * 64 < -(-kb // 128) * 128 else 128
    ow = -(-w // stride)
    plans = []
    for bm, bn in TILES:
        if bn > -(-co // 32) * 32:
            continue
        tw = bm if ksize == 1 else min(bm, 1 << (ow - 1).bit_length(),
                                       BOX_MAX // stride)
        fixed = 1024 + bm // 64 * 16 * bn + (
            bm * (bn + 16) if stride == 2 and not float_in else 0)
        stages = min(FLOAT_MAX_STAGES if float_in else MAX_STAGES,
                     (SMEM_BYTES - fixed) // ((bm + bn) * bk + 16))
        plans.append(Plan(bm, bn, bk, bm // tw, tw, stages))
    return min(plans, key=lambda q: (
        plan_cost(q, n, h, w, ci, co, ksize, float_in, esize, stride),
        q.bm if float_in else -q.bm, -q.bn))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA/TF SAME padding (the end gets the odd pixel)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).to(F32)


def quantized_input(x: torch.Tensor, inv_in: float,
                    residual_in: Optional[torch.Tensor] = None,
                    res_scale: float = 0.0) -> torch.Tensor:
    """The s8 codes the kernels multiply: x itself when s8, else the
    quantize of x (after the bf16 residual add of the 1x1 variant)."""
    if x.dtype == torch.int8:
        return x
    if residual_in is not None:
        x = (residual_in.to(F32) * res_scale).to(BF16) + x.to(BF16)
    return quantize_act(x, inv_in)


def epilogue(acc: torch.Tensor, epi: torch.Tensor, *, inv_next: float,
             alpha: float, cast_bf16: bool,
             residual_out: Optional[torch.Tensor] = None,
             res_scale: float = 0.0, emit_s8: bool = True,
             out_dtype: Optional[torch.dtype] = None):
    """The kernels' f32 epilogue on exact sums `acc` [..., Co] (any
    type), op by op in their order."""
    y = acc.to(F32) + epi[0]
    y = torch.where(y >= 0.0, y, alpha * y)
    y = y * epi[1] + epi[2]
    if cast_bf16:
        y = _bf16_round(y)
    if residual_out is not None:
        res = residual_out.to(F32) * res_scale
        if cast_bf16:
            res = _bf16_round(res)
        y = res + y
        if cast_bf16:
            y = _bf16_round(y)
    outs = []
    if emit_s8:
        outs.append(quantize_act(y, inv_next))
    if out_dtype is not None:
        outs.append(y.to(out_dtype))
    return outs[0] if len(outs) == 1 else tuple(outs)


def conv_block_q_plain(x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor,
                       *, ksize: int, stride: int, inv_in: float,
                       inv_next: float, alpha: float, cast_bf16: bool,
                       residual_in: Optional[torch.Tensor] = None,
                       residual_out: Optional[torch.Tensor] = None,
                       res_scale: float = 0.0, emit_s8: bool = True,
                       out_dtype: Optional[torch.dtype] = None):
    """The kernels' function without their tiling: returns the s8 output,
    the float output, or (s8, float) when both are asked for."""
    q = quantized_input(x, inv_in, residual_in, res_scale)
    return epilogue(conv_sums(q, w_t, ksize, stride), epi, inv_next=inv_next,
                    alpha=alpha, cast_bf16=cast_bf16,
                    residual_out=residual_out, res_scale=res_scale,
                    emit_s8=emit_s8, out_dtype=out_dtype)


def conv_sums(q: torch.Tensor, w_t: torch.Tensor, ksize: int,
              stride: int) -> torch.Tensor:
    """Exact sums of an s8 NHWC tensor's SAME conv with s8 w_t
    [taps, Co, Ci], as float64 NHWC."""
    n, h, w, _ = q.shape
    co = w_t.shape[1]
    (pt, pb), (pl, pr) = same_pads(h, ksize, stride), same_pads(w, ksize,
                                                                 stride)
    f64 = torch.float64
    wk = w_t.reshape(ksize, ksize, co, -1).permute(2, 3, 0, 1).to(f64)
    # not cuDNN, whose FFT or Winograd algorithms would not sum exactly
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(F.pad(q.permute(0, 3, 1, 2).to(f64),
                             (pl, pr, pt, pb)), wk, stride=stride)
    return acc.permute(0, 2, 3, 1)


def _kernel_fn(lib: str, entry: str, planned: bool):
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load(lib), entry)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the WMMA entries end at inv_next_row; the wgmma ones add the
        # plan
        fn.argtypes = ([p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                        i, i, f, f, f, f, i, i]
                       + [i] * (6 if planned else 0) + [p])
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def launch(name: str, x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor,
           *, ksize: int, stride: int, inv_in: float, inv_next: float,
           alpha: float, cast_bf16: bool,
           residual_in: Optional[torch.Tensor] = None,
           residual_out: Optional[torch.Tensor] = None,
           res_scale: float = 0.0, emit_s8: bool = True,
           out_dtype: Optional[torch.dtype] = None,
           plan: Optional[Plan] = None, wmma: bool = False):
    """Launch kernel `name` on CUDA tensors (same result layout as
    `conv_block_q_plain`); raises on what the kernel does not take.

    A wgmma kernel (WGMMA_KERNELS) runs under `plan`, by default
    `conv_plan`'s; `wmma` runs the same contract on the WMMA core instead
    (entry NAME + "_wmma", counted under that name). A [4, Co] epi gives
    1/s_next per channel in row 3."""
    if x.dtype not in IN_KINDS:
        raise TypeError(f"{name}: x must be s8, bf16 or f32, got {x.dtype}")
    if w_t.dtype != torch.int8 or epi.dtype != F32:
        raise TypeError(f"{name}: need s8 weights and f32 epi, got "
                        f"{w_t.dtype} and {epi.dtype}")
    if out_dtype not in (None, BF16, F32) or not (emit_s8 or out_dtype):
        raise ValueError(f"{name}: bad outputs (emit_s8={emit_s8}, "
                         f"out_dtype={out_dtype})")
    n, h, w, ci = x.shape
    taps, co, wci = w_t.shape
    planned = name in WGMMA_KERNELS and not wmma
    if (taps != ksize * ksize or wci != ci or epi.dim() != 2
            or tuple(epi.shape) not in ((3, co), (4, co))):
        raise ValueError(f"{name}: w_t {tuple(w_t.shape)} / epi "
                         f"{tuple(epi.shape)} do not fit x {tuple(x.shape)}")
    if ci % 16 or co % 16:
        raise ValueError(f"{name}: Ci = {ci} and Co = {co} must be "
                         f"multiples of 16")
    (pt, _), (pl, _) = same_pads(h, ksize, stride), same_pads(w, ksize,
                                                              stride)
    oh, ow = -(-h // stride), -(-w // stride)
    for r, shape in ((residual_in, (n, h, w, ci)),
                     (residual_out, (n, oh, ow, co))):
        if r is not None and (r.dtype != torch.int8
                              or tuple(r.shape) != shape):
            raise ValueError(f"{name}: residual must be s8 {shape}")
    tensors = [t for t in (x, w_t, epi, residual_in, residual_out)
               if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                         f"aligned")
    out_s8 = (torch.empty((n, oh, ow, co), dtype=torch.int8, device=x.device)
              if emit_s8 else None)
    out_f = (torch.empty((n, oh, ow, co), dtype=out_dtype, device=x.device)
             if out_dtype is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    entry = name + "_wmma" if wmma else name
    extra = (int(epi.shape[0] == 4),)
    if planned:
        extra += tuple(plan or conv_plan(n, h, w, ci, co, ksize,
                                         x.dtype != torch.int8,
                                         stride=stride))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn(name, entry, planned)(
        x.data_ptr(), IN_KINDS[x.dtype], w_t.data_ptr(), epi.data_ptr(),
        ptr(residual_in), ptr(residual_out), ptr(out_s8), ptr(out_f),
        int(out_dtype == BF16), n, h, w, ci, co, oh, ow, ksize, stride, pt,
        pl, float(inv_in), float(inv_next), float(res_scale), float(alpha),
        int(cast_bf16), *extra, stream)
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    outs = [t for t in (out_s8, out_f) if t is not None]
    return outs[0] if len(outs) == 1 else tuple(outs)
