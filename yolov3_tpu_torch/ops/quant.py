"""int8 post-training-quantization primitives (port of the helpers in
`yolov3_tpu/models/quantized.py`).

- weights: per-output-channel symmetric, s_w[o] = max|W[..., o]| / 127;
- activations: per-tensor symmetric, quantized by multiplying with the
  f32 reciprocal of the scale and rounding half to even (`torch.round`
  rounds as `jnp.round` does), clipped to +-127;
- calibration: per-tensor absmax, or a percentile of |activations| from a
  fixed 4096-bin histogram;
- the inference BatchNorm as the affine pair (mul, add), with
  mul = scale * rsqrt(var + eps);
- the exact int32 sums of an s8 SAME conv (`int8_conv_sums`), which the
  quantization-aware training forward (`models/yolo.py::int8_ste_conv`)
  scales itself.

Every result is computed in float32 in the reference's op order, since a
last-bit difference in a scale flips the codes that sit on a .5 boundary.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32

# linear bins over [0, absmax] per tensor for percentile calibration
HIST_BINS = 4096


def reciprocal(scale: float) -> float:
    """f32(1) / f32(scale), correctly rounded, as a Python float that
    holds the f32 value exactly."""
    return float(np.float32(1.0) / np.float32(scale))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 [..., co] (HWIO) -> (int8 kernel, per-output-channel scale [co]).

    An all-zero output channel gets scale 1.0: its codes are 0 whatever
    the scale, and a tiny floor would blow its bias up in the epilogue's
    b/dq fold."""
    w = w.to(F32)
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.where(absmax > 0, absmax, torch.full_like(absmax, 127.0)
                        ) / 127.0
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_act(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """clip(round(x * (1/s)), +-127) as int8; `inv_scale` from
    `reciprocal`."""
    xq = torch.round(x.to(F32) * inv_scale)
    return torch.clamp(xq, -127, 127).to(torch.int8)


def abs_histogram(tensors) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts [HIST_BINS] int64, absmax) of |values| over `tensors`,
    binned linearly over [0, absmax]."""
    avs = [t.to(F32).abs().reshape(-1) for t in tensors]
    m = torch.clamp(torch.stack([a.max() for a in avs]).max(), min=1e-30)
    counts = torch.zeros(HIST_BINS, dtype=torch.int64, device=m.device)
    for a in avs:
        idx = torch.clamp((a * (HIST_BINS / m)).to(torch.int32),
                          max=HIST_BINS - 1)
        counts += torch.bincount(idx, minlength=HIST_BINS)
    return counts, m


def hist_percentile(counts: torch.Tensor, m: torch.Tensor,
                    pct: float) -> torch.Tensor:
    """Percentile of |activations| from a (counts, absmax) histogram, with
    linear interpolation inside the landing bin; numpy's 'linear' rank
    h = (n-1)*pct/100 (cumulative-count target h+1)."""
    c = torch.cumsum(counts.to(F32), dim=0)
    target = (c[-1] - 1.0) * np.float32(pct / 100.0) + 1.0
    idx = int(torch.clamp(torch.searchsorted(c, target.reshape(1)), 0,
                          HIST_BINS - 1))
    prev = c[idx - 1] if idx > 0 else torch.zeros((), dtype=F32,
                                                  device=c.device)
    frac = torch.clamp((target - prev) / torch.clamp(c[idx] - prev, min=1.0),
                       0.0, 1.0)
    return (np.float32(idx) + frac) * (m / HIST_BINS)


def bn_affine(scale: torch.Tensor, offset: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as f32 (mul, add): mul = scale * rsqrt(var +
    eps), add = offset - mean * mul."""
    mul = scale.to(F32) * torch.rsqrt(var.to(F32) + eps)
    return mul, offset.to(F32) - mean.to(F32) * mul


def fold_conv_block(weight: torch.Tensor, bias: torch.Tensor,
                    mul: torch.Tensor, add: torch.Tensor, act_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int8 ConvBlock's kernel constants for activation scale `act_scale`.

    weight OIHW f32, bias [co], (mul, add) from `bn_affine`. Returns
    (w_t [kh*kw, co, ci] s8, each output channel's K contiguous, and epi
    [3, co] f32 rows b/dq, mul*dq, add), with dq = s_x * s_w the
    per-channel dequant scale that the epilogue commutes through LeakyReLU:
    leaky(y*dq + b) * mul == leaky(y + b/dq) * (mul*dq) since dq > 0."""
    co, ci, kh, kw = weight.shape
    wq, sw = quantize_weight(weight.permute(2, 3, 1, 0))
    w_t = wq.permute(0, 1, 3, 2).reshape(kh * kw, co, ci).contiguous()
    dq = sw * float(np.float32(act_scale))
    epi = torch.stack([bias.to(F32) / dq, mul * dq, add])
    return w_t, epi


# --- the stem region's epilogue rows ----------------------------------------
#
# The fused stem-region kernels (stem2 -> FeatureBlock_0 1x1 -> its 3x3 ->
# residual -> exit conv) take one f32 table of per-channel rows, each
# zero-padded to the widest stage, in the order of the JAX kernels'
# docstrings (yolov3_tpu/ops/pallas/s2d_region_kernel.py, s2d_tail_kernel.py,
# exit_conv_kernel.py). A stage's (b/dq, mul*dq, add) rows are its block's
# `fold_conv_block` epi; s2..s5 are the activation scales of
# FeatureBlock_0/ConvBlock_0, FeatureBlock_0/ConvBlock_1, ConvBlock_2 and
# FeatureBlock_1/ConvBlock_0.


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=F32)


def _rows(rows, width: int) -> torch.Tensor:
    """Stack 1-D f32 rows, each zero-padded to `width`."""
    out = torch.zeros((len(rows), width), dtype=F32)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def _tail_rows(pw: torch.Tensor, fb0: torch.Tensor, exit_: torch.Tensor,
               s2: float, s3: float, s4: float, s5: float,
               fast: bool = False):
    """Rows 0-12 as 1-D tensors:
      0-3   pw:   b/dq, mul*dq, add, 1/s3
      4-8   fb0:  b/dq, mul*dq, add, s2 (residual dequant), 1/s4
      9-12  exit: b/dq, mul*dq, add, 1/s5
    With `fast`, each stage's 1/s is folded into its mul and add
    (f32 divisions, as quantized.py:905-913) and row 7 is s2/s4; rows
    3, 8 and 12 are then unused by the kernels."""
    cm, c, co = pw.shape[1], fb0.shape[1], exit_.shape[1]
    s2_, s3_, s4_, s5_ = (_f32(s) for s in (s2, s3, s4, s5))
    (b1, m1, a1), (bf, mf, af), (b3, m3, a3) = pw, fb0, exit_
    if fast:
        m1, a1 = m1 / s3_, a1 / s3_
        mf, af = mf / s4_, af / s4_
        res = (s2_ / s4_).expand(c)
        m3, a3 = m3 / s5_, a3 / s5_
    else:
        res = s2_.expand(c)
    one = _f32(1.0)
    return [b1, m1, a1, (one / s3_).expand(cm),
            bf, mf, af, res, (one / s4_).expand(c),
            b3, m3, a3, (one / s5_).expand(co)]


def region_epi(stem2: torch.Tensor, pw: torch.Tensor, fb0: torch.Tensor,
               exit_: torch.Tensor, s2: float, s3: float, s4: float,
               s5: float, fast: bool = False) -> torch.Tensor:
    """The region kernel's f32 [17, max_c] table: `_tail_rows`, then
      13-16 stem2: b/dq, mul*dq, add, 1/s2
    (`fast`: mul and add divided by s2)."""
    rows = _tail_rows(pw, fb0, exit_, s2, s3, s4, s5, fast)
    b2, m2, a2 = stem2
    s2_ = _f32(s2)
    if fast:
        m2, a2 = m2 / s2_, a2 / s2_
    rows += [b2, m2, a2, (_f32(1.0) / s2_).expand(stem2.shape[1])]
    return _rows(rows, max(r.shape[0] for r in rows))


def _quad(b: torch.Tensor, m: torch.Tensor, a: torch.Tensor, s: float,
          alpha: float):
    """A stage's (b/dq, mul*dq, add) as the two affines whose max is
    leaky(acc + b) * m / s + a / s for m >= 0 (quantized.py:895-901):
    m1 = m/s, c1 = m1*b + a/s, m2 = alpha*m1, c2 = m2*b + a/s, each times
    the channel's sign of m1 (a channel with m1 < 0 then emits -q).
    Returns ([m1, c1, m2, c2], sign)."""
    s_ = _f32(s)
    g1 = m / s_
    g2 = _f32(alpha) * g1
    sgn = torch.where(g1 >= 0, _f32(1.0), _f32(-1.0))
    rows = [g1, g1 * b + a / s_, g2, g2 * b + a / s_]
    return [r * sgn for r in rows], sgn


def region_epi_affine2(stem2: torch.Tensor, pw: torch.Tensor,
                       fb0: torch.Tensor, exit_: torch.Tensor, s2: float,
                       s3: float, s4: float, s5: float, alpha: float):
    """The region kernel's f32 [17, max_c] table for the `affine2`
    epilogue (quantized.py:867-917), and the signs (sgn2, sgn3, sgn4) of
    stem2's, the 1x1's and FB0's output channels:
      0-3   pw:    m1, c1, m2, c2
      4-8   fb0:   m1, c1, m2, c2, r = s2/s4 * sgn2 * sgn4
      9-12  exit:  b/dq, mul*dq/s5, add/s5, 0 (the fast rows)
      13-16 stem2: m1, c1, m2, c2
    A stage whose channel has a negative sign emits that channel negated;
    its consumers' weights take the channel negated (`flip_inputs` with the
    sign), so every product and the residual are as before."""
    (b3, m3, a3) = exit_
    rows2, sgn2 = _quad(*stem2, s2, alpha)
    rows3, sgn3 = _quad(*pw, s3, alpha)
    rows4, sgn4 = _quad(*fb0, s4, alpha)
    res = (_f32(s2) / _f32(s4)).expand(sgn2.shape[0]) * sgn2 * sgn4
    s5_ = _f32(s5)
    rows = rows3 + rows4 + [res, b3, m3 / s5_, a3 / s5_,
                            torch.zeros_like(b3)] + rows2
    return _rows(rows, max(r.shape[0] for r in rows)), (sgn2, sgn3, sgn4)


def flip_inputs(w_t: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """s8 weights [taps, Co, Ci] with the input channels of negative sign
    negated (lossless: the codes are within +-127)."""
    return torch.where(sgn[None, None, :] < 0, -w_t, w_t)


def with_stem1(epi: torch.Tensor, stem1, s1: float,
               fast: bool = False) -> torch.Tensor:
    """A region table with stem1's rows for the kernel that runs stem1
    itself (`rawimg`, quantized.py:929-945):
      17-20 stem1: b, mul, add, 1/s1
    stem1's f32 bias and BatchNorm (mul, add) (`bn_affine`), unquantized,
    and 1/s1 with s1 ConvBlock_1's scale (`fast`: mul and add divided by
    s1)."""
    b, m, a = stem1
    s1_ = _f32(s1)
    if fast:
        m, a = m / s1_, a / s1_
    rows = list(epi) + [b, m, a, (_f32(1.0) / s1_).expand(b.shape[0])]
    return _rows(rows, max(epi.shape[1], b.shape[0]))


def tail_epi(pw: torch.Tensor, fb0: torch.Tensor, exit_: torch.Tensor,
             s2: float, s3: float, s4: float, s5: float) -> torch.Tensor:
    """The tail kernel's f32 [13, max_c] table (exact epilogue)."""
    rows = _tail_rows(pw, fb0, exit_, s2, s3, s4, s5)
    return _rows(rows, max(r.shape[0] for r in rows))


def exit_epi(exit_: torch.Tensor, s5: float) -> torch.Tensor:
    """The exit kernel's f32 [4, co] table: b/dq, mul*dq, add, 1/s5."""
    inv = (_f32(1.0) / _f32(s5)).expand(exit_.shape[1])
    return torch.cat([exit_, inv[None]]).contiguous()


# --- the int32 sums of an s8 convolution ------------------------------------


def int8_conv_sums(q_x: torch.Tensor, q_w: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """Exact int32 sums of the SAME convolution of s8 codes: q_x NHWC
    int8, q_w OIHW int8 -> NHWC int32 (the reference's
    `conv_general_dilated(..., preferred_element_type=int32)`, padded as
    XLA's SAME pads, the odd pixel at the end).

    On a CUDA tensor: `torch._int_mm` over an im2col (`_int_mm_sums`);
    a failure there raises. On the CPU: a float64 convolution of the
    codes, exact since |sum| <= taps * Ci * 127^2 (9 * 1024 * 127^2, about
    1.5e8, at the widest conv) lies far below 2^53."""
    from yolov3_tpu_torch.ops.kernels._conv_q import same_pads
    n, h, w, _ = q_x.shape
    k = q_w.shape[-1]
    pads = same_pads(h, k, stride) + same_pads(w, k, stride)
    if q_x.device.type == "cuda":
        return _int_mm_sums(q_x, q_w, stride, pads)
    pt, pb, pl, pr = pads
    y = F.conv2d(F.pad(q_x.permute(0, 3, 1, 2).to(torch.float64),
                       (pl, pr, pt, pb)), q_w.to(torch.float64),
                 stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


def _int_mm_sums(q_x: torch.Tensor, q_w: torch.Tensor, stride: int,
                 pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """`int8_conv_sums` by `torch._int_mm`: the rows (M = N*Ho*Wo, at
    least 32) of an im2col in (tap, channel) order, K and Co padded with
    zero codes to multiples of 16 (cuBLAS's int8 GEMM takes K and Co in
    multiples of 8 and M above 16), times the weights as a column-major
    [K, Co]."""
    n, h, w, ci = q_x.shape
    co, _, k, _ = q_w.shape
    pt, pb, pl, pr = pads
    oh, ow = -(-h // stride), -(-w // stride)
    m, kk = n * oh * ow, k * k * ci
    cols = q_x.new_zeros((max(m, 32), _ceil16(kk)))
    if k == 1 and stride == 1:
        cols[:m, :ci] = q_x.reshape(m, ci)
    else:
        xp = F.pad(q_x, (0, 0, pl, pr, pt, pb))
        view = cols[:m].view(n, oh, ow, cols.shape[1])
        for u in range(k):
            for v in range(k):
                t = (u * k + v) * ci
                view[..., t:t + ci] = xp[:, u:u + stride * (oh - 1) + 1:stride,
                                         v:v + stride * (ow - 1) + 1:stride]
    wm = q_w.new_zeros((_ceil16(co), cols.shape[1]))
    wm[:co, :kk] = q_w.permute(0, 2, 3, 1).reshape(co, kk)
    sums = torch._int_mm(cols, wm.t())
    return sums[:m, :co].reshape(n, oh, ow, co)
