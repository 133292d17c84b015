"""Greedy NMS suppression: the CUDA kernels' wrappers and their plain
versions.

`suppress_boxes_t` replaces `yolov3_tpu/ops/pallas/nms_kernel.py::
suppress_boxes_pallas_t` (and `suppress_boxes_pallas`, the same contract
in row layout). Its kernel is `csrc/nms_suppress.cu`, two launches a
call: every IoU test the recurrence could need, on the whole card, into a
bitmask (one 64-bit word per row and 64 later slots; the workspace
[C, K, ceil(K/64)] is allocated here), then one warp per (image, class)
problem that decides its slots in order with a bit test and an OR in
registers a step, up to the problem's highest valid slot. The source
note says more. `suppress_boxes_chain` runs the first design (one block
per problem, one block-wide OR per candidate), the same contract, for
A/B timing only; no path calls it.

`greedy_suppress` replaces `nms_kernel.py::greedy_suppress_pallas`, the
same recurrence from a precomputed IoU slab (`csrc/greedy_suppress.cu`):
two launches a call as well, a bitmask built from the slab's lower
triangle, then the same warp scan (`csrc/nms_scan.cuh`).
`greedy_suppress_chain` runs its first design (one block per problem,
one block-wide OR per candidate) for A/B timing only. No path of the
package calls either; the entry keeps the reference's contract for
callers that already hold the IoU matrices.

A CUDA tensor goes through a kernel, or the wrapper raises; a CPU tensor
goes through the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from yolov3_tpu_torch.ops.kernels import _build
from yolov3_tpu_torch.ops.nms import _greedy_suppress, pairwise_iou

NAME = "nms_suppress"
CHAIN = "nms_suppress_chain"
GREEDY = "greedy_suppress"
GREEDY_CHAIN = "greedy_suppress_chain"
WORD = 64  # slots of a mask word
# the IoU-slab entries' K: the mask grid's words^2 blocks fit gridDim.y
GREEDY_MAX_K = 255 * WORD
_fns = {}


def _kernel_fn(name: str = NAME):
    """The C entry point `name`: of the library `nms_suppress` (the mask +
    scan entry, with the workspace pointer, and its chain twin) or
    `greedy_suppress` (the same two)."""
    fn = _fns.get(name)
    if fn is None:
        lib = GREEDY if name in (GREEDY, GREEDY_CHAIN) else NAME
        fn = getattr(_build.load(lib), name)
        p = ctypes.c_void_p
        fn.argtypes = ([p, p, p] + ([p] if name in (NAME, GREEDY) else [])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def suppress_boxes_plain(cand: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """cand [C, K, 4] ltrb score-sorted, valid [C, K] -> keep [C, K] bool,
    from the full IoU matrices and the sequential recurrence."""
    return _greedy_suppress(pairwise_iou(cand.to(torch.float32)),
                            valid.to(torch.bool), iou_threshold)


def _check(cand: torch.Tensor, valid: torch.Tensor) -> None:
    if cand.dim() != 3 or cand.shape[-1] != 4:
        raise ValueError(f"cand must be [C, K, 4], got {tuple(cand.shape)}")
    if tuple(valid.shape) != tuple(cand.shape[:2]):
        raise ValueError(f"valid must be {tuple(cand.shape[:2])}, got "
                         f"{tuple(valid.shape)}")
    if valid.device != cand.device:
        raise ValueError("cand and valid must be on one device")


def _launch(cand: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
            entry: str = NAME) -> torch.Tensor:
    """Launch `entry` (NAME, or its chain twin CHAIN) on CUDA tensors."""
    if cand.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 cand and bool valid, got {cand.dtype} "
                        f"and {valid.dtype}")
    if not (cand.is_contiguous() and valid.is_contiguous()):
        raise ValueError("cand and valid must be contiguous")
    c, k, _ = cand.shape
    if k * 21 > 227 * 1024:
        # the chain twin holds a problem's boxes in shared memory; both
        # entries take the same K
        raise ValueError(f"K = {k} candidates do not fit in shared memory")
    keep = torch.empty((c, k), dtype=torch.bool, device=cand.device)
    ptrs = [cand.data_ptr(), valid.data_ptr(), keep.data_ptr()]
    if entry == NAME:
        mask = torch.empty((c, k, -(-k // WORD)), dtype=torch.int64,
                           device=cand.device)
        ptrs.append(mask.data_ptr())
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = _kernel_fn(entry)(*ptrs, c, k, float(iou_threshold), stream)
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    return keep


def suppress_boxes_t(cand: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """cand [C, K, 4] f32 ltrb score-sorted, valid [C, K] bool ->
    keep [C, K] bool (the `suppress_boxes_pallas_t` contract)."""
    _check(cand, valid)
    if cand.device.type == "cpu":
        return suppress_boxes_plain(cand, valid, iou_threshold)
    return _launch(cand, valid, iou_threshold)


def suppress_boxes_chain(cand: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """The first design of `suppress_boxes_t`'s kernel (entry
    nms_suppress_chain, counted under that name), on CUDA tensors only:
    the A/B twin that chip_smoke.py and the card tests hold the kernel
    against."""
    _check(cand, valid)
    if cand.device.type != "cuda":
        raise ValueError("suppress_boxes_chain runs on CUDA tensors only")
    return _launch(cand, valid, iou_threshold, CHAIN)


def suppress_boxes(cand: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Row-layout entry (the `suppress_boxes_pallas` contract): the same
    function as `suppress_boxes_t`, onto the same CUDA kernel."""
    return suppress_boxes_t(cand, valid, iou_threshold)


def greedy_suppress_plain(iou: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """iou [C, K, K], valid [C, K] -> keep [C, K] bool: the recurrence of
    `_greedy_suppress`, reading row i of the slab for candidate i as the
    reference's kernel does (the transpose of `_greedy_suppress`'s column
    read; a slab from `pairwise_iou` is symmetric)."""
    return _greedy_suppress(iou.to(torch.float32).transpose(-1, -2),
                            valid.to(torch.bool), iou_threshold)


def _check_slab(iou: torch.Tensor, valid: torch.Tensor) -> None:
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"iou must be [C, K, K], got {tuple(iou.shape)}")
    if tuple(valid.shape) != tuple(iou.shape[:2]):
        raise ValueError(f"valid must be {tuple(iou.shape[:2])}, got "
                         f"{tuple(valid.shape)}")
    if valid.device != iou.device:
        raise ValueError("iou and valid must be on one device")


def _launch_slab(iou: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float, entry: str) -> torch.Tensor:
    """Launch `entry` (GREEDY, or its chain twin GREEDY_CHAIN) on CUDA
    tensors."""
    if iou.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 iou and bool valid, got {iou.dtype} "
                        f"and {valid.dtype}")
    if not (iou.is_contiguous() and valid.is_contiguous()):
        raise ValueError("iou and valid must be contiguous")
    c, k = valid.shape
    if k > GREEDY_MAX_K:
        raise ValueError(f"K = {k} candidates: the IoU-slab kernels take at "
                         f"most {GREEDY_MAX_K}")
    keep = torch.empty((c, k), dtype=torch.bool, device=iou.device)
    ptrs = [iou.data_ptr(), valid.data_ptr(), keep.data_ptr()]
    if entry == GREEDY:
        mask = torch.empty((c, k, -(-k // WORD)), dtype=torch.int64,
                           device=iou.device)
        ptrs.append(mask.data_ptr())
    stream = torch.cuda.current_stream(iou.device).cuda_stream
    err = _kernel_fn(entry)(*ptrs, c, k, float(iou_threshold), stream)
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    return keep


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """iou [C, K, K] f32, valid [C, K] bool -> keep [C, K] bool (the
    `greedy_suppress_pallas` contract)."""
    _check_slab(iou, valid)
    if iou.device.type == "cpu":
        return greedy_suppress_plain(iou, valid, iou_threshold)
    return _launch_slab(iou, valid, iou_threshold, GREEDY)


def greedy_suppress_chain(iou: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """The first design of `greedy_suppress`'s kernel (entry
    greedy_suppress_chain, counted under that name), on CUDA tensors only:
    the A/B twin that chip_smoke.py and the card tests hold the kernel
    against."""
    _check_slab(iou, valid)
    if iou.device.type != "cuda":
        raise ValueError("greedy_suppress_chain runs on CUDA tensors only")
    return _launch_slab(iou, valid, iou_threshold, GREEDY_CHAIN)
