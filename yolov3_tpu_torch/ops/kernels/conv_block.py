"""Fused inference 1x1 ConvBlock: the CUDA kernel's wrapper and its plain
version.

Replaces `yolov3_tpu/ops/pallas/conv_block_kernel.py::
fused_pointwise_conv_block`. At inference the block Conv -> LeakyReLU ->
BatchNorm is one matrix product with an epilogue:

    y = leaky(x @ W + b) * mul + add
    mul = gamma / sqrt(var + eps),  add = beta - mean * mul

x and W go in as bf16, the products are summed in f32 and the epilogue is
f32, as the TPU kernel does. The kernel is `csrc/pointwise_conv_block.cu`
(tiled WMMA bf16 with the epilogue on the way out; the source note says
what bounds it). A CUDA tensor goes through the kernel, or the wrapper
raises; a CPU tensor goes through `pointwise_conv_block_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from yolov3_tpu_torch.ops.kernels import _build

NAME = "pointwise_conv_block"
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(NAME).pointwise_conv_block
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pointwise_conv_block_plain(x: torch.Tensor, w: torch.Tensor,
                               bias: torch.Tensor, mul: torch.Tensor,
                               add: torch.Tensor, alpha: float,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, Ci], w [Ci, Co] rounded to bf16 and multiplied in f32, then
    the f32 epilogue; the kernel's arithmetic without its tiling."""
    f32 = torch.float32
    y = x.to(torch.bfloat16).to(f32) @ w.to(torch.bfloat16).to(f32)
    y = y + bias.to(f32)
    y = torch.where(y >= 0.0, y, alpha * y)
    y = y * mul.to(f32) + add.to(f32)
    return y.to(out_dtype)


def _launch(x, w, bias, mul, add, alpha, out_dtype) -> torch.Tensor:
    m, ci = x.shape
    co = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"need bf16 x and w, got {x.dtype} and {w.dtype}")
    if any(t.dtype != torch.float32 for t in (bias, mul, add)):
        raise TypeError("bias, mul and add must be float32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if ci % 8 or co % 8:
        raise ValueError(f"Ci = {ci} and Co = {co} must be multiples of 8")
    tensors = (x, w, bias, mul, add)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    out = torch.empty((m, co), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn()(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                       mul.data_ptr(), add.data_ptr(), out.data_ptr(),
                       m, ci, co, float(alpha),
                       int(out_dtype == torch.bfloat16), stream)
    _build.check(err, NAME)
    _build.launch_counts[NAME] += 1
    return out


def pointwise_conv_block(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, mul: torch.Tensor,
                         add: torch.Tensor, alpha: float,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, Ci] bf16, w [Ci, Co] bf16, bias/mul/add [Co] f32 ->
    [M, Co] in `out_dtype`."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x [M, Ci] and w [Ci, Co], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return pointwise_conv_block_plain(x, w, bias, mul, add, alpha,
                                          out_dtype)
    return _launch(x, w, bias, mul, add, alpha, out_dtype)


def fold_batchnorm(scale: torch.Tensor, offset: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as f32 `(mul, add)` (conv_block_kernel.py:57-58)."""
    f32 = torch.float32
    mul = scale.to(f32) / torch.sqrt(var.to(f32) + eps)
    return mul, offset.to(f32) - mean.to(f32) * mul


def fused_pointwise_conv_block(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor, scale: torch.Tensor,
                               offset: torch.Tensor, mean: torch.Tensor,
                               var: torch.Tensor, alpha: float = 0.2,
                               eps: float = 1e-3,
                               out_dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """x [N,H,W,Ci] -> [N,H,W,Co] through the fused block (the JAX
    function's contract); `kernel` is [Ci, Co]. Folds the BatchNorm into
    mul/add in f32 (conv_block_kernel.py:57-58)."""
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    mul, add = fold_batchnorm(scale, offset, mean, var, eps)
    y = pointwise_conv_block(x.reshape(n * h * w, ci).to(torch.bfloat16),
                             kernel.to(torch.bfloat16).contiguous(),
                             bias.to(torch.float32), mul, add, alpha,
                             out_dtype)
    return y.reshape(n, h, w, co)
