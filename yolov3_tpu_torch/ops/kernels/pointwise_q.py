"""int8 1x1 ConvBlock: the CUDA kernel's wrapper and its plain version.

Replaces `yolov3_tpu/ops/pallas/pointwise_kernel.py::
pointwise_conv_block_q`. Over the flattened pixels of x [B,H,W,Ci]:

    t   = bf16(bf16(rq * s_res) + x)         [residual variant, bf16 x]
    q   = clip(round(t * inv_in), +-127)     [bf16 or f32 x; s8 x as is]
    acc = q @ w                              (int8, summed in int32)
    f   = leaky(acc + b/dq) * (mul*dq) + add (f32, dq folded)
    out = clip(round(bf16(f) * inv_next))    s8 for the next conv
    and/or the block output bf16(f) (or f, unrounded, as f32)

The s8 output and a bf16 output are quantized from bf16(f), as the TPU
kernel does; an f32 output (the plain int8 1x1 conv block of an f32
model) is f itself. The kernel is `csrc/pointwise_conv_block_q.cu`; a
CUDA tensor goes through it or the wrapper raises, a CPU tensor goes
through `pointwise_conv_block_q_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolov3_tpu_torch.ops.kernels import _conv_q

NAME = "pointwise_conv_block_q"


def _args(x, residual_q, emit_s8, out_dtype):
    if residual_q is not None and x.dtype != torch.bfloat16:
        raise TypeError(f"the residual variant needs a bf16 x, got {x.dtype}")
    if emit_s8 and out_dtype == torch.float32:
        raise ValueError("an s8 output comes with a bf16 block output only")
    return dict(ksize=1, stride=1, cast_bf16=out_dtype != torch.float32,
                residual_in=residual_q, emit_s8=emit_s8, out_dtype=out_dtype)


def pointwise_conv_block_q_plain(x: torch.Tensor, w_t: torch.Tensor,
                                 epi: torch.Tensor, *, inv_in: float,
                                 inv_next: float, alpha: float,
                                 residual_q: Optional[torch.Tensor] = None,
                                 res_scale: float = 0.0, emit_s8: bool = True,
                                 out_dtype: Optional[torch.dtype] = None):
    """The kernel's arithmetic in plain PyTorch (exact int32 sums)."""
    return _conv_q.conv_block_q_plain(
        x, w_t, epi, inv_in=inv_in, inv_next=inv_next, alpha=alpha,
        res_scale=res_scale, **_args(x, residual_q, emit_s8, out_dtype))


def pointwise_conv_block_q(x: torch.Tensor, w_t: torch.Tensor,
                           epi: torch.Tensor, *, inv_in: float,
                           inv_next: float, alpha: float,
                           residual_q: Optional[torch.Tensor] = None,
                           res_scale: float = 0.0, emit_s8: bool = True,
                           out_dtype: Optional[torch.dtype] = None):
    """x [B,H,W,Ci] s8, bf16 or f32; w_t [1, Co, Ci] s8; epi [3, Co] f32
    (b/dq, mul*dq, add); residual_q [B,H,W,Ci] s8 with a bf16 x only.
    Returns s8 [B,H,W,Co], the `out_dtype` block output, or both as
    (s8, float)."""
    kw = _args(x, residual_q, emit_s8, out_dtype)
    if x.device.type == "cpu":
        return _conv_q.conv_block_q_plain(
            x, w_t, epi, inv_in=inv_in, inv_next=inv_next, alpha=alpha,
            res_scale=res_scale, **kw)
    return _conv_q.launch(NAME, x, w_t, epi, inv_in=inv_in,
                          inv_next=inv_next, alpha=alpha,
                          res_scale=res_scale, **kw)
