"""Fused inference 1x1 ConvBlock: the CUDA kernel's wrapper and its plain
version.

Replaces `yolov3_tpu/ops/pallas/conv_block_kernel.py::
fused_pointwise_conv_block`. At inference the block Conv -> LeakyReLU ->
BatchNorm is one matrix product with an epilogue:

    y = leaky(x @ W + b) * mul + add
    mul = gamma / sqrt(var + eps),  add = beta - mean * mul

x and W go in as bf16, the products are summed in f32 and the epilogue is
f32, as the TPU kernel does. The kernel is `csrc/pointwise_conv_block.cu`:
the wgmma + TMA core of the int8 1x1 and 3x3 kernels
(`csrc/conv_gemm_q_sm90.cuh`) with bf16 operands, under the tile plan
`_conv_q.conv_plan` picks (the source note says what bounds it). A CUDA
tensor goes through the kernel, or the wrapper raises; a CPU tensor goes
through `pointwise_conv_block_plain`.

`fused_pointwise_conv_block` keeps the JAX function's contract (`kernel`
[Ci, Co]); the inner `pointwise_conv_block`, its plain version and its
WMMA twin take the kernel's layout, W [Co, Ci] (K-major, the conv's OIHW
weight without its taps), which the model derives once at load.
`pointwise_conv_block_wmma` is the same contract on the first, WMMA
kernel, for A/B timing only: no serving path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from yolov3_tpu_torch.ops.kernels import _build, _conv_q

NAME = "pointwise_conv_block"
WMMA = NAME + "_wmma"
_fns = {}


def _kernel_fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load(NAME), entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        # the sm90 entry takes the tile plan (bm, bn, bk, stages) too
        plan = [i] * 4 if entry == NAME else []
        fn.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_float, i,
                       *plan, p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def pointwise_conv_block_plain(x: torch.Tensor, w: torch.Tensor,
                               bias: torch.Tensor, mul: torch.Tensor,
                               add: torch.Tensor, alpha: float,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, Ci], w [Co, Ci] rounded to bf16 and multiplied in f32, then
    the f32 epilogue; the kernel's arithmetic without its tiling."""
    f32 = torch.float32
    y = x.to(torch.bfloat16).to(f32) @ w.to(torch.bfloat16).to(f32).t()
    y = y + bias.to(f32)
    y = torch.where(y >= 0.0, y, alpha * y)
    y = y * mul.to(f32) + add.to(f32)
    return y.to(out_dtype)


def _launch(x, w, bias, mul, add, alpha, out_dtype, entry=NAME,
            plan: Optional[_conv_q.Plan] = None) -> torch.Tensor:
    m, ci = x.shape
    co = w.shape[0]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"need bf16 x and w, got {x.dtype} and {w.dtype}")
    if any(t.dtype != torch.float32 for t in (bias, mul, add)):
        raise TypeError("bias, mul and add must be float32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if ci % 8 or co % 8:
        raise ValueError(f"Ci = {ci} and Co = {co} must be multiples of 8")
    tensors = (x, w, bias, mul, add)
    if any(tuple(t.shape) != (co,) for t in (bias, mul, add)):
        raise ValueError(f"bias, mul and add must be [{co}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("all operands must be contiguous and 16-byte "
                         "aligned")
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    out = torch.empty((m, co), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    extra = ()
    if entry == NAME:
        plan = plan or _conv_q.conv_plan(1, 1, m, ci, co, 1, esize=2)
        extra = (plan.bm, plan.bn, plan.bk, plan.stages)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn(entry)(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            mul.data_ptr(), add.data_ptr(), out.data_ptr(),
                            m, ci, co, float(alpha),
                            int(out_dtype == torch.bfloat16), *extra, stream)
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    return out


def _check_shapes(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x [M, Ci] and w [Co, Ci], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def pointwise_conv_block(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, mul: torch.Tensor,
                         add: torch.Tensor, alpha: float,
                         out_dtype: torch.dtype,
                         plan: Optional[_conv_q.Plan] = None
                         ) -> torch.Tensor:
    """x [M, Ci] bf16, w [Co, Ci] bf16, bias/mul/add [Co] f32 ->
    [M, Co] in `out_dtype`; `plan` forces a tile plan (default
    `_conv_q.conv_plan`'s)."""
    _check_shapes(x, w)
    if x.device.type == "cpu":
        return pointwise_conv_block_plain(x, w, bias, mul, add, alpha,
                                          out_dtype)
    return _launch(x, w, bias, mul, add, alpha, out_dtype, plan=plan)


def pointwise_conv_block_wmma(x: torch.Tensor, w: torch.Tensor,
                              bias: torch.Tensor, mul: torch.Tensor,
                              add: torch.Tensor, alpha: float,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """`pointwise_conv_block` on the WMMA kernel (CUDA tensors only;
    counted under its own name): the A/B twin of the sm90 kernel."""
    _check_shapes(x, w)
    return _launch(x, w, bias, mul, add, alpha, out_dtype, entry=WMMA)


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
                             kernel.to(torch.bfloat16).t().contiguous(),
                             bias.to(torch.float32), mul, add, alpha,
                             out_dtype)
    return y.reshape(n, h, w, co)
