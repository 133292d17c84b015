"""PyTorch port box decode vs the JAX package's decode, same feature maps.

Tolerance: rtol 1e-6, with an absolute floor of 1e-6 of the largest
coordinate. torch's and XLA's float32 exp and sigmoid differ by a few ulps,
and the corner subtraction cx - 0.5*w cancels, so a corner near zero
carries the ulps of the much larger cx and w.
"""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops import decode as jdec
from yolov3_tpu_torch.ops import decode as tdec

ANCHORS = {2: ((16, 16), (32, 32)), 3: ((10, 13), (33, 23), (116, 90))}


def feature_maps(rng, n, img, a, c):
    return [(rng.randn(n, img // s, img // s, a * (5 + c)) * 2).astype(
        np.float32) for s in (32, 16, 8)]


@pytest.mark.parametrize("n,img,a,c", [(2, 64, 2, 2), (1, 128, 3, 1),
                                       (1, 96, 2, 4)])
def test_decode_detections_matches_jax(n, img, a, c):
    fms = feature_maps(np.random.RandomState(img + c), n, img, a, c)
    want = np.asarray(jdec.decode_detections(fms, ANCHORS[a], c))
    got = tdec.decode_detections([torch.from_numpy(f) for f in fms],
                                 ANCHORS[a], c).numpy()
    assert got.shape == want.shape == (n, a * sum(
        (img // s) ** 2 for s in (32, 16, 8)), 5 + c)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_reorg_feature_map_matches_jax():
    fm = feature_maps(np.random.RandomState(0), 2, 64, 2, 2)[1]
    want = jdec.reorg_feature_map(fm, ANCHORS[2], 2, 16)
    got = tdec.reorg_feature_map(torch.from_numpy(fm), ANCHORS[2], 2, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_bf16_feature_maps_decode_in_f32():
    fm = feature_maps(np.random.RandomState(1), 1, 64, 2, 2)
    t = [torch.from_numpy(f).to(torch.bfloat16) for f in fm]
    want = np.asarray(jdec.decode_detections(
        [f.float().numpy() for f in t], ANCHORS[2], 2))
    got = tdec.decode_detections(t, ANCHORS[2], 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_row_order_scale_cell_anchor():
    """Rows run (scale, cell, anchor): a large objectness logit at scale 1,
    cell (row 1, col 0), anchor 1 lands on row (1*2 + 0)*2 + 1 after the
    stride-32 scale's rows."""
    fms = [np.full((1, 64 // s, 64 // s, 2 * 7), -10, np.float32)
           for s in (32, 16, 8)]
    fms[1][0, 1, 0, 7 + 4] = 10.0
    det = tdec.decode_detections([torch.from_numpy(f) for f in fms],
                                 ANCHORS[2], 2).numpy()
    hot = np.flatnonzero(det[0, :, 4] > 0.5)
    assert hot.tolist() == [2 * 2 * 2 + (1 * 4 + 0) * 2 + 1]
