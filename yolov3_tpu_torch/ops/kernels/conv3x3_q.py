"""int8 3x3 stride-1 ConvBlock: the CUDA kernel's wrapper and its plain
version.

Replaces `yolov3_tpu/ops/pallas/conv3x3_kernel.py::conv3x3_block_q`:
nine tap products with SAME (1, 1) zero padding, summed in int32, then

    y = leaky(acc + b/dq) * (mul*dq) + add          (f32)
    [cast_bf16] y = bf16(y)
    [residual]  y = bf16(bf16(rq * s_res) + y)      (casts as above)
    s8 out = clip(round(y * inv_next)), and/or y as bf16 or f32.

In a feature block it carries the 3x3, the residual add of the block
input and the next rep's quantize (s8 in, s8 out; bf16 out on the last
rep); with no residual and a float output only it is the plain int8 3x3
conv block. The kernel is `csrc/conv3x3_block_q.cu`; a CUDA tensor goes
through it or the wrapper raises, a CPU tensor goes through
`conv3x3_block_q_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolov3_tpu_torch.ops.kernels import _conv_q

NAME = "conv3x3_block_q"


def conv3x3_block_q_plain(x: torch.Tensor, w_t: torch.Tensor,
                          epi: torch.Tensor, *, inv_in: float,
                          inv_next: float, alpha: float, cast_bf16: bool,
                          residual_q: Optional[torch.Tensor] = None,
                          res_scale: float = 0.0, emit_s8: bool = True,
                          out_dtype: Optional[torch.dtype] = None):
    """The kernel's arithmetic in plain PyTorch (exact int32 sums)."""
    return _conv_q.conv_block_q_plain(
        x, w_t, epi, ksize=3, stride=1, inv_in=inv_in, inv_next=inv_next,
        alpha=alpha, cast_bf16=cast_bf16, residual_out=residual_q,
        res_scale=res_scale, emit_s8=emit_s8, out_dtype=out_dtype)


def conv3x3_block_q(x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor,
                    *, inv_in: float, inv_next: float, alpha: float,
                    cast_bf16: bool,
                    residual_q: Optional[torch.Tensor] = None,
                    res_scale: float = 0.0, emit_s8: bool = True,
                    out_dtype: Optional[torch.dtype] = None):
    """x [N,H,W,C] s8, bf16 or f32; w_t [9, Co, C] s8 ((u, v) major);
    epi [3, Co] f32; residual_q [N,H,W,Co] s8. Returns s8 [N,H,W,Co], the
    `out_dtype` output, or both as (s8, float)."""
    kw = dict(inv_in=inv_in, inv_next=inv_next, alpha=alpha,
              cast_bf16=cast_bf16, res_scale=res_scale, emit_s8=emit_s8,
              out_dtype=out_dtype)
    if x.device.type == "cpu":
        return conv3x3_block_q_plain(x, w_t, epi, residual_q=residual_q,
                                     **kw)
    return _conv_q.launch(NAME, x, w_t, epi, ksize=3, stride=1,
                          residual_out=residual_q, **kw)
