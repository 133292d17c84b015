"""The port's ghost-zone tiling (`yolov3_tpu_torch/utils/tiling.py`)
against the JAX package's copy (`yolov3_tpu/utils/tiling.py`): the same
tiles, origins, keep masks and stitched predictions, exactly."""

import numpy as np
import pytest

from yolov3_tpu.utils import tiling as J
from yolov3_tpu_torch.utils import tiling as T

# (image H, W, C), tile: smaller than a tile, sizes that are not multiples
# of the zone, one axis within a tile
CASES = [((100, 90, 3), (128, 128)), ((700, 530, 1), (256, 256)),
         ((1000, 333, 3), (512, 256)), ((257, 640, 3), (256, 320))]


@pytest.mark.parametrize("edge", [0, 96])
@pytest.mark.parametrize("shape,tile", CASES)
def test_tiles_match_jax(shape, tile, edge):
    img = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.uint8)
    got, want = (m.convert_image_to_tiles(img, tile, edge) for m in (T, J))
    assert got[1:] == want[1:]
    assert len(got[0]) == len(want[0]) > 0
    for g, w in zip(got[0], want[0]):
        assert g.shape == (*tile, shape[2])
        np.testing.assert_array_equal(g, w)


def test_tile_asserts_match_jax():
    img = np.zeros((600, 600, 1), np.uint8)
    for m in (T, J):
        with pytest.raises(AssertionError):
            m.convert_image_to_tiles(img, (500, 512))
        with pytest.raises(AssertionError):  # no zone left
            m.convert_image_to_tiles(img, (128, 128), 96)


def random_boxes(rng, n, extent):
    xy = rng.rand(n, 2) * extent - 20
    wh = rng.rand(n, 2) * 60 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.mark.parametrize("edge", [0, 96])
@pytest.mark.parametrize("shape,tile", CASES)
def test_keep_mask_matches_jax(shape, tile, edge):
    rng = np.random.RandomState(len(CASES) + edge)
    img = np.zeros(shape, np.uint8)
    _, xs, ys = T.convert_image_to_tiles(img, tile, edge)
    for x, y in zip(xs, ys):
        boxes = random_boxes(rng, 64, max(tile))
        got = T.ghost_zone_keep_mask(boxes, x, y, tile, shape, edge)
        np.testing.assert_array_equal(
            got, J.ghost_zone_keep_mask(boxes, x, y, tile, shape, edge))
    empty = np.zeros((0, 4), np.float32)
    assert T.ghost_zone_keep_mask(empty, 0, 0, tile, shape, edge).shape == (0,)


@pytest.mark.parametrize("shape", [(150, 130, 3), (700, 530, 1)])
def test_stitch_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    parts = [(random_boxes(rng, n, max(shape) + 40),
              rng.rand(n).astype(np.float32),
              rng.randint(0, 2, n).astype(np.int32)) for n in (5, 0, 17)]
    lists = [list(p) for p in zip(*parts)]
    got = T.stitch_tile_detections(*lists, shape)
    want = J.stitch_tile_detections(*lists, shape)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert 0 < got.shape[0] < 22
    np.testing.assert_array_equal(got, want)
    none_got = T.stitch_tile_detections([], [], [], shape)
    none_want = J.stitch_tile_detections([], [], [], shape)
    assert none_got.shape == none_want.shape == (0, 6)
    assert none_got.dtype == none_want.dtype
