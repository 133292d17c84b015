"""int8 3x3 stride-2 ConvBlock: the CUDA kernel's wrapper and its plain
version.

Replaces `yolov3_tpu/ops/pallas/down_conv_kernel.py::down_conv_block_q`:
the quantize of the bf16 (or f32) input, nine tap products over the
stride-2 grid summed in int32, the folded epilogue

    y = leaky(acc + b/dq) * (mul*dq) + add;  [cast_bf16] y = bf16(y)

and the next block's quantize clip(round(y * inv_next)) to s8. XLA's SAME
padding: an even input gets its one zero row and column at the
bottom/right only. With `emit_s8=False` and an `out_dtype` the kernel
returns y instead: the plain int8 stride-2 conv block, which the
reference runs where no next block is calibrated. The kernel is
`csrc/down_conv_block_q.cu`, on the wgmma core under `_conv_q.conv_plan`'s
tile plan (`down_conv_block_q_wmma` in the same library is the first
design, for A/B timing only); a CUDA tensor goes through it or the
wrapper raises, a CPU tensor goes through `down_conv_block_q_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from yolov3_tpu_torch.ops.kernels import _conv_q

NAME = "down_conv_block_q"


def _check(x):
    if x.dtype == torch.int8:
        raise TypeError("the stride-2 block quantizes a bf16 or f32 input, "
                        "got s8")


def down_conv_block_q_plain(x: torch.Tensor, w_t: torch.Tensor,
                            epi: torch.Tensor, *, inv_in: float,
                            inv_next: float, alpha: float, cast_bf16: bool,
                            emit_s8: bool = True,
                            out_dtype: Optional[torch.dtype] = None):
    """The kernel's arithmetic in plain PyTorch (exact int32 sums)."""
    _check(x)
    return _conv_q.conv_block_q_plain(
        x, w_t, epi, ksize=3, stride=2, inv_in=inv_in, inv_next=inv_next,
        alpha=alpha, cast_bf16=cast_bf16, emit_s8=emit_s8,
        out_dtype=out_dtype)


def down_conv_block_q(x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor,
                      *, inv_in: float, inv_next: float, alpha: float,
                      cast_bf16: bool, emit_s8: bool = True,
                      out_dtype: Optional[torch.dtype] = None):
    """x [N,H,W,C] bf16 or f32; w_t [9, Co, C] s8 ((u, v) major); epi
    [3, Co] f32 (or [4, Co] with 1/s_next per channel in row 3). Returns
    s8 [N,ceil(H/2),ceil(W/2),Co] (or the `out_dtype` output, or both)."""
    kw = dict(inv_in=inv_in, inv_next=inv_next, alpha=alpha,
              cast_bf16=cast_bf16, emit_s8=emit_s8, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return down_conv_block_q_plain(x, w_t, epi, **kw)
    _check(x)
    return _conv_q.launch(NAME, x, w_t, epi, ksize=3, stride=2, **kw)
