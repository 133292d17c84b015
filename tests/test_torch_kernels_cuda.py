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


def int8_block(rng, k, ci, co, scale=0.05):
    """s8 weights [k*k, co, ci] and the folded epi rows of a random block."""
    from yolov3_tpu_torch.ops import quant
    w = torch.from_numpy((rng.randn(co, ci, k, k) / np.sqrt(k * k * ci))
                         .astype(np.float32))
    b, g, o, m = (torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.randn(co), rng.uniform(0.8, 1.2, co), 0.1 * rng.randn(co),
        0.1 * rng.randn(co)))
    mul, add = quant.bn_affine(g, o, m, torch.from_numpy(
        rng.uniform(0.5, 1.5, co).astype(np.float32)), 1e-3)
    return quant.fold_conv_block(w, b, mul, add, scale)


def int8_input(rng, shape, kind, cuda):
    if kind == "s8":
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(
            np.int8)).to(cuda)
    x = torch.from_numpy((rng.randn(*shape) * 2).astype(np.float32))
    return x.to(cuda, torch.bfloat16 if kind == "bf16" else torch.float32)


def assert_int8_close(got, want):
    """s8 codes within 1; float outputs within a bf16 ulp."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max() <= 1
        else:
            d = (g.float() - w.float()).abs()
            assert bool((d <= 2.0 ** -7 * w.float().abs() + 1e-6).all())


def launched(mod, fn):
    before = _build.launch_counts[mod.NAME]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts[mod.NAME] == before + 1
    return out


@pytest.mark.parametrize("shape,co,kind,res,emit_s8,out", [
    ((2, 9, 7, 64), 32, "s8", False, True, None),
    ((2, 16, 16, 64), 32, "bf16", True, True, None),
    ((2, 16, 16, 256), 128, "bf16", False, True, torch.bfloat16),
    ((1, 8, 8, 128), 256, "f32", False, False, torch.float32),
    ((8, 16, 16, 1024), 512, "s8", False, True, None)])
def test_pointwise_q_matches_plain(cuda, shape, co, kind, res, emit_s8, out):
    from yolov3_tpu_torch.ops.kernels import pointwise_q as K
    rng = np.random.RandomState(shape[-1] + co)
    w_t, epi = int8_block(rng, 1, shape[-1], co)
    x = int8_input(rng, shape, kind, cuda)
    rq = int8_input(rng, shape, "s8", cuda) if res else None
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, residual_q=rq,
              res_scale=0.03, emit_s8=emit_s8, out_dtype=out)
    w_t, epi = w_t.to(cuda), epi.to(cuda)
    got = launched(K, lambda: K.pointwise_conv_block_q(x, w_t, epi, **kw))
    assert_int8_close(got, K.pointwise_conv_block_q_plain(x, w_t, epi, **kw))


@pytest.mark.parametrize("shape,co,kind,res,emit_s8,out,cast", [
    ((2, 16, 16, 32), 64, "s8", True, True, None, True),
    ((2, 10, 12, 32), 64, "s8", True, False, torch.bfloat16, True),
    ((2, 16, 16, 64), 128, "bf16", False, False, torch.bfloat16, True),
    ((1, 8, 8, 32), 64, "f32", False, False, torch.float32, False),
    ((2, 16, 16, 512), 1024, "s8", True, True, torch.bfloat16, False)])
def test_conv3x3_q_matches_plain(cuda, shape, co, kind, res, emit_s8, out,
                                 cast):
    from yolov3_tpu_torch.ops.kernels import conv3x3_q as K
    rng = np.random.RandomState(shape[1] + co)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, shape[-1], co))
    x = int8_input(rng, shape, kind, cuda)
    rq = int8_input(rng, shape[:3] + (co,), "s8", cuda) if res else None
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, cast_bf16=cast,
              residual_q=rq, res_scale=0.03, emit_s8=emit_s8, out_dtype=out)
    got = launched(K, lambda: K.conv3x3_block_q(x, w_t, epi, **kw))
    assert_int8_close(got, K.conv3x3_block_q_plain(x, w_t, epi, **kw))


@pytest.mark.parametrize("shape,co,kind,emit_s8,out", [
    ((2, 32, 32, 32), 64, "bf16", True, None),
    ((1, 15, 17, 32), 64, "bf16", True, None),
    ((2, 8, 8, 64), 128, "f32", False, torch.float32),
    ((8, 32, 32, 512), 1024, "bf16", True, None)])
def test_down_conv_q_matches_plain(cuda, shape, co, kind, emit_s8, out):
    from yolov3_tpu_torch.ops.kernels import down_conv_q as K
    rng = np.random.RandomState(shape[1] + co)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, shape[-1], co))
    x = int8_input(rng, shape, kind, cuda)
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, cast_bf16=kind == "bf16",
              emit_s8=emit_s8, out_dtype=out)
    got = launched(K, lambda: K.down_conv_block_q(x, w_t, epi, **kw))
    assert_int8_close(got, K.down_conv_block_q_plain(x, w_t, epi, **kw))


def test_int8_sums_exact_beyond_f32(cuda):
    """9 * 1024 * 127^2 ~ 1.5e8 > 2^24: the kernel sums in int32."""
    from yolov3_tpu_torch.ops.kernels import conv3x3_q as K
    x = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8, device=cuda)
    w_t = torch.full((9, 16, 1024), 127, dtype=torch.int8, device=cuda)
    w_t[0, 0, 0] = 126
    epi = torch.stack([torch.zeros(16), torch.ones(16), torch.zeros(16)]).to(
        cuda)
    y = K.conv3x3_block_q(x, w_t, epi, inv_in=1.0, inv_next=1.0, alpha=0.2,
                          cast_bf16=False, emit_s8=False,
                          out_dtype=torch.float32)
    assert y[0, 1, 1, 0].item() == np.float32(9 * 1024 * 127 * 127 - 127)


def test_int8_kernels_raise_on_what_they_do_not_take(cuda):
    from yolov3_tpu_torch.ops.kernels import down_conv_q, pointwise_q
    w_t = torch.zeros(1, 16, 24, dtype=torch.int8, device=cuda)
    epi = torch.zeros(3, 16, device=cuda)
    with pytest.raises(ValueError):  # Ci = 24 is not a multiple of 16
        pointwise_q.pointwise_conv_block_q(
            torch.zeros(1, 4, 4, 24, dtype=torch.int8, device=cuda), w_t,
            epi, inv_in=1.0, inv_next=1.0, alpha=0.2)
    with pytest.raises(TypeError):  # the stride-2 block takes floats
        down_conv_q.down_conv_block_q(
            torch.zeros(1, 4, 4, 16, dtype=torch.int8, device=cuda),
            torch.zeros(9, 16, 16, dtype=torch.int8, device=cuda), epi,
            inv_in=1.0, inv_next=1.0, alpha=0.2, cast_bf16=True)
