"""int8 post-training-quantization primitives (port of the helpers in
`yolov3_tpu/models/quantized.py`).

- weights: per-output-channel symmetric, s_w[o] = max|W[..., o]| / 127;
- activations: per-tensor symmetric, quantized by multiplying with the
  f32 reciprocal of the scale and rounding half to even (`torch.round`
  rounds as `jnp.round` does), clipped to +-127;
- calibration: per-tensor absmax, or a percentile of |activations| from a
  fixed 4096-bin histogram;
- the inference BatchNorm as the affine pair (mul, add), with
  mul = scale * rsqrt(var + eps).

Every result is computed in float32 in the reference's op order, since a
last-bit difference in a scale flips the codes that sit on a .5 boundary.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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
