"""stem1 on tensor cores, the region kernel's `rawimg` route for a bf16
image (`csrc/s2d_region_block_q.cu::stem1_tc`), checked here through its
formulation in plain PyTorch (`s2d_region_q.stem1_gemm_plain`: the image
patch's rows as the kernel copies them, the 16-element A rows, the packed
weights with their zero rows, the sums in doubt taken again in the plain
order), since the kernel itself runs only on the card. Random images and
weights from a numpy seed.
"""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.ops.kernels import s2d_region_q as R


def stem1_case(dtype, h, w, ci=3, c1=32, seed=0):
    """A z-scored-like image [2, h, w, ci], stem1's weights [9, c1, ci] of
    its type and the epilogue rows (b, m, a, 1/s1)."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.standard_normal((2, h, w, ci)).astype(
        np.float32)).to(dtype)
    w_s1 = torch.from_numpy((rng.standard_normal((9, c1, ci))
                             / np.sqrt(9 * ci)).astype(np.float32)).to(dtype)
    rows = torch.from_numpy(np.stack([
        0.1 * rng.standard_normal(c1), rng.uniform(0.8, 1.2, c1),
        0.1 * rng.standard_normal(c1), np.full(c1, 40.0)]).astype(np.float32))
    return img, w_s1, rows


def assert_codes(got, want, codes, frac):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= codes, (int(d.max()), float((d > 0).float().mean()))
    assert float((d > 0).float().mean()) <= frac


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w", [(64, 64), (64, 96)])
@pytest.mark.parametrize("tile", [8, 2])
def test_stem1_gemm_is_stem1_plain(dtype, h, w, tile):
    """The tensor-core route's formulation against the plain stem1: code
    for code, since every sum whose code the summation order could change
    is taken again in the plain order (within the class of
    test_torch_region_modes.py::test_stem1_plain_is_stem1, <= 1 code on
    <= 1%, with none). At T = 8 every 64 px tile's patch runs off the
    image; at T = 2 most lie inside it."""
    img, w_s1, rows = stem1_case(dtype, h, w)
    kw = dict(alpha=0.1, cast_bf16=dtype == torch.bfloat16, fast=False)
    got = R.stem1_gemm_plain(img, w_s1, rows, tile=tile, **kw)
    want = R.stem1_plain(img, w_s1, rows, **kw)
    assert got.shape == want.shape == (2, h, w, 32)
    assert_codes(got, want, 0, 0.0)


@pytest.mark.parametrize("ci", [1, 2, 3, 4])
def test_stem1_gemm_image_channels(ci):
    """1 to 4 image channels (each A row's tail, past 3 ci elements, runs
    into the next pixels), the fast epilogue, 16 stem1 channels."""
    img, w_s1, rows = stem1_case(torch.bfloat16, 32, 48, ci=ci, c1=16,
                                 seed=ci)
    kw = dict(alpha=0.1, cast_bf16=True, fast=True)
    assert_codes(R.stem1_gemm_plain(img, w_s1, rows, tile=2, **kw),
                 R.stem1_plain(img, w_s1, rows, **kw), 0, 0.0)


@pytest.mark.parametrize("ci", [1, 2, 3, 4])
def test_pack_stem1(ci):
    """[3, c1, 16]: tap row u, channel o, k = v * ci + cc holds w[3u + v,
    o, cc]; k >= 3 ci is zero."""
    w = torch.arange(9 * 16 * ci, dtype=torch.float32).reshape(9, 16, ci) + 1
    b = R.pack_stem1(w.to(torch.bfloat16)).float()
    assert b.shape == (3, 16, 16)
    for u in range(3):
        for v in range(3):
            assert torch.equal(b[u, :, v * ci:(v + 1) * ci],
                               w[3 * u + v].to(torch.bfloat16).float())
    assert not b[:, :, 3 * ci:].any()
    assert bool((b[:, :, :3 * ci] != 0).all())


def test_stem1_tc_plan():
    """The flagship's rawimg block with stem1 on tensor cores: packed bf16
    weights and their magnitudes, the x tile sharing q3's and q4's buffer,
    the bf16 patch (41 rows of 288 bytes) in a buffer of its own for the
    prefetch, the queue of the sums taken again; T = 8 under the card's
    227 KB, below the CUDA-core layout's 219,824 bytes."""
    t, c1, c, cm, co, ci = 8, 32, 64, 32, 128, 3
    xw, qw, q4w = 4 * t + 7, 2 * t + 3, 2 * t + 1
    assert R.patch_reads(xw + 2, ci) == 130
    assert R.patch_pitch(xw + 2, ci) == 288
    weights = 9 * c * c1 + cm * c + 9 * c * cm + 9 * co * c
    shared = max(xw * xw * c1, qw * qw * cm + q4w * q4w * c)
    want = (1024 + weights + 2 * 3 * c1 * 32 + qw * qw * c + shared
            + (xw + 2) * 288 + 16 + 4 * R.REDO + 21 * co * 4)
    got = R.smem_bytes(t, c1, c, cm, co, True, ci=ci)
    assert got == want == 218256 <= R.SMEM_LIMIT
    assert R.plan_tile(c1, c, cm, co, ci=ci) == 8
    assert R.smem_bytes(t, c1, c, cm, co, True, ci=ci, cores=True) == 219824
    for ci_ in range(1, R.MAX_IMAGE_CHANNELS + 1):
        assert R.plan_tile(c1, c, cm, co, ci=ci_) == 8
        # the row's offset in its chunk and the last A row fit its pitch
        side = xw + 2
        assert 15 + 2 * R.patch_reads(side, ci_) <= R.patch_pitch(side, ci_)


def test_cores_is_the_rawimg_mode_only():
    """The CUDA-core twin takes an image and its weights only; a CPU tensor
    never reaches a kernel."""
    img, w_s1, rows = stem1_case(torch.bfloat16, 16, 16, c1=16)
    q = torch.zeros(9, 16, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        R.launch(R.NAME, img, (q, q[:1], q, q), torch.zeros(17, 16),
                 alpha=0.2, cast_bf16=True, cores=True)
