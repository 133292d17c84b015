"""The stem region's tail (FeatureBlock_0 1x1 -> 3x3 + residual -> exit
conv): the CUDA kernel's wrapper and its plain version.

Replaces `yolov3_tpu/ops/pallas/s2d_tail_kernel.py::s2d_tail_block_q`:
the region of `s2d_region_q` entered one stage later, from stem2's s8
output q2 (scale s2 = FeatureBlock_0/ConvBlock_0's), with the exact
epilogue, to FeatureBlock_1's s8 input. epi f32 [13, >= max(c, cm, co)]
is rows 0-12 of the region's table (`ops/quant.py::tail_epi`).

The kernel is the `s2d_tail_block_q` entry of `csrc/s2d_region_block_q.cu`;
a CUDA tensor goes through it or the wrapper raises, a CPU tensor goes
through `s2d_tail_block_q_plain`. `s2d_tail_block_q_mma` is the first
design's entry (A/B timing only).
"""

from __future__ import annotations

import torch

from yolov3_tpu_torch.ops.kernels import _conv_q, s2d_region_q as R

NAME = "s2d_tail_block_q"


def s2d_tail_block_q_plain(x: torch.Tensor, w_pw: torch.Tensor,
                           w_fb0: torch.Tensor, w_exit: torch.Tensor,
                           epi: torch.Tensor, *, alpha: float,
                           cast_bf16: bool,
                           sums=_conv_q.conv_sums) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (exact int32 sums from
    `sums`)."""
    R.check(x, (w_pw, w_fb0, w_exit), epi, 13)
    return R.tail_plain(x, w_pw, w_fb0, w_exit, epi, alpha=alpha,
                        cast_bf16=cast_bf16, fast=False, sums=sums)


def s2d_tail_block_q(x: torch.Tensor, w_pw: torch.Tensor, w_fb0: torch.Tensor,
                     w_exit: torch.Tensor, epi: torch.Tensor, *,
                     alpha: float, cast_bf16: bool) -> torch.Tensor:
    """x s8 [N,H,W,c] (H, W even); w_pw [1, cm, c], w_fb0 [9, c, cm],
    w_exit [9, co, c] s8; epi f32 [13, ·]. Returns s8 [N, H/2, W/2, co]."""
    if x.device.type == "cpu":
        return s2d_tail_block_q_plain(x, w_pw, w_fb0, w_exit, epi,
                                      alpha=alpha, cast_bf16=cast_bf16)
    R.check(x, (w_pw, w_fb0, w_exit), epi, 13)
    return R.launch(NAME, x, (w_pw, w_fb0, w_exit), epi, alpha=alpha,
                    cast_bf16=cast_bf16)


def s2d_tail_block_q_mma(x: torch.Tensor, w_pw: torch.Tensor,
                         w_fb0: torch.Tensor, w_exit: torch.Tensor,
                         epi: torch.Tensor, *, alpha: float,
                         cast_bf16: bool) -> torch.Tensor:
    """`s2d_tail_block_q` on the first design's kernel (CUDA tensors
    only): the A/B twin of the kernel."""
    R.check(x, (w_pw, w_fb0, w_exit), epi, 13)
    return R.launch(NAME, x, (w_pw, w_fb0, w_exit), epi, alpha=alpha,
                    cast_bf16=cast_bf16, twin=True)
