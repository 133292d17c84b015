"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build the kernels from
`yolov3_tpu_torch/csrc/`) and skip elsewhere. They import neither JAX nor
the JAX package, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.ops.kernels import _build
from yolov3_tpu_torch.ops.kernels import conv_block as PW
from yolov3_tpu_torch.ops.kernels import nms_suppress as NMS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sorted_candidates(rng, c, k):
    xy = rng.rand(c, k, 2).astype(np.float32) * 100
    wh = rng.rand(c, k, 2).astype(np.float32) * 40 + 1
    cand = np.concatenate([xy, xy + wh], axis=-1)
    counts = rng.randint(0, k + 1, c)
    valid = np.arange(k)[None, :] < counts[:, None]
    return cand, valid


@pytest.mark.parametrize("c,k,sparse", [(128, 512, False), (128, 512, True),
                                        (3, 40, True), (2, 3000, True)])
def test_nms_kernel_bit_equal_to_plain(cuda, c, k, sparse):
    cand, valid = sorted_candidates(np.random.RandomState(c + k), c, k)
    if not sparse:
        valid[:] = True
    ct, vt = torch.from_numpy(cand), torch.from_numpy(valid)
    want = NMS.suppress_boxes_plain(ct, vt, 0.3)
    before = _build.launch_counts[NMS.NAME]
    got = NMS.suppress_boxes_t(ct.to(cuda), vt.to(cuda), 0.3)
    torch.cuda.synchronize()
    assert _build.launch_counts[NMS.NAME] == before + 1
    assert torch.equal(got.cpu(), want)


def test_nms_kernel_threshold_tie_and_degenerate(cuda):
    cand = torch.tensor([[[0, 0, 10, 10], [0, 5, 10, 15], [0, 0, 0, 0],
                          [0, 0, 0, 0]]], dtype=torch.float32, device=cuda)
    valid = torch.ones(1, 4, dtype=torch.bool, device=cuda)
    iou = 50.0 / 150.0
    assert NMS.suppress_boxes(cand, valid, iou).tolist() == [[True] * 4]
    assert NMS.suppress_boxes(cand, valid, iou - 1e-4).tolist() == [
        [True, False, True, True]]


def test_nms_kernel_raises_on_wrong_dtype(cuda):
    cand = torch.zeros(2, 8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        NMS.suppress_boxes_t(cand, torch.ones(2, 8, dtype=torch.bool,
                                              device=cuda), 0.3)


@pytest.mark.parametrize("m,ci,co,out", [
    (1000, 64, 32, torch.bfloat16), (4096, 768, 384, torch.bfloat16),
    (130, 1024, 512, torch.float32), (64, 8, 8, torch.float32)])
def test_pointwise_kernel_matches_plain(cuda, m, ci, co, out):
    rng = np.random.RandomState(m + ci)
    x = torch.from_numpy(rng.randn(m, ci).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(ci, co) / np.sqrt(ci)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    b, mul, add = (torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (
        0.1 * rng.randn(co), rng.uniform(0.8, 1.2, co), 0.1 * rng.randn(co)))
    want = PW.pointwise_conv_block_plain(x, w, b, mul, add, 0.2, out)
    before = _build.launch_counts[PW.NAME]
    got = PW.pointwise_conv_block(x, w, b, mul, add, 0.2, out)
    torch.cuda.synchronize()
    assert _build.launch_counts[PW.NAME] == before + 1
    assert got.dtype == out
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_pointwise_kernel_raises_on_f32_input(cuda):
    x = torch.zeros(64, 64, device=cuda)
    w = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
    z = torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        PW.pointwise_conv_block(x, w, z, z, z, 0.2, torch.float32)
