"""The stem region's exit ConvBlock (s8 in, s8 out): the CUDA kernel's
wrapper and its plain version.

Replaces `yolov3_tpu/ops/pallas/exit_conv_kernel.py::exit_conv_block_q`.
In the plain NHWC layout the TPU kernel's [2, 2, 4Ci, Co] window conv is
the 3x3 stride-2 SAME conv of ConvBlock_2; the s8 input is FeatureBlock_0's
output quantized with ConvBlock_2's scale, and the output FeatureBlock_1's
s8 input:

    y   = leaky(acc + b/dq) * (mul*dq) + add;  [cast_bf16] y = bf16(y)
    out = clip(round(y * inv_next), +-127)

epi f32 [4, Co] = (b/dq, mul*dq, add, 1/s_next), the JAX contract
(`ops/quant.py::exit_epi`). The kernel is `csrc/exit_conv_block_q.cu`, on
the wgmma core under `_conv_q.conv_plan`'s tile plan, its s8 input
through TMA at element strides of 2 (`exit_conv_block_q_wmma` in the same
library is the first design, for A/B timing only); a CUDA tensor goes
through it or the wrapper raises, a CPU tensor goes through
`exit_conv_block_q_plain`.
"""

from __future__ import annotations

import torch

from yolov3_tpu_torch.ops.kernels import _conv_q

NAME = "exit_conv_block_q"


def _check(x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError(f"{NAME}: x and w_t must be s8, got {x.dtype} and "
                        f"{w_t.dtype}")
    if epi.dtype != torch.float32:
        raise TypeError(f"{NAME}: epi must be f32, got {epi.dtype}")
    if x.dim() != 4 or w_t.dim() != 3 or w_t.shape[0] != 9 \
            or w_t.shape[2] != x.shape[-1] \
            or tuple(epi.shape) != (4, w_t.shape[1]):
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, w_t "
                         f"{tuple(w_t.shape)} and epi {tuple(epi.shape)} do "
                         f"not fit [N,H,W,Ci], [9,Co,Ci] and [4,Co]")


def exit_conv_block_q_plain(x: torch.Tensor, w_t: torch.Tensor,
                            epi: torch.Tensor, *, alpha: float,
                            cast_bf16: bool,
                            sums=_conv_q.conv_sums) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (exact int32 sums from
    `sums(q, w_t, ksize, stride)`)."""
    _check(x, w_t, epi)
    return _conv_q.epilogue(sums(x, w_t, 3, 2), epi[:3],
                            inv_next=epi[3], alpha=alpha,
                            cast_bf16=cast_bf16)


def _launch(x, w_t, epi, alpha, cast_bf16, plan=None, wmma=False):
    _check(x, w_t, epi)
    return _conv_q.launch(NAME, x, w_t, epi, ksize=3, stride=2, inv_in=1.0,
                          inv_next=0.0, alpha=alpha, cast_bf16=cast_bf16,
                          plan=plan, wmma=wmma)


def exit_conv_block_q(x: torch.Tensor, w_t: torch.Tensor, epi: torch.Tensor,
                      *, alpha: float, cast_bf16: bool) -> torch.Tensor:
    """x s8 [N,H,W,Ci]; w_t s8 [9, Co, Ci] ((u, v) major); epi f32
    [4, Co]. Returns s8 [N, ceil(H/2), ceil(W/2), Co]."""
    if x.device.type == "cpu":
        return exit_conv_block_q_plain(x, w_t, epi, alpha=alpha,
                                       cast_bf16=cast_bf16)
    return _launch(x, w_t, epi, alpha, cast_bf16)


def exit_conv_block_q_wmma(x: torch.Tensor, w_t: torch.Tensor,
                           epi: torch.Tensor, *, alpha: float,
                           cast_bf16: bool) -> torch.Tensor:
    """The first design of `exit_conv_block_q`'s kernel (entry
    exit_conv_block_q_wmma, on the WMMA core, counted under that name), on
    CUDA tensors only: the A/B twin that chip_smoke.py and the card tests
    hold the kernel against."""
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}_wmma runs on CUDA tensors only")
    return _launch(x, w_t, epi, alpha, cast_bf16, wmma=True)
