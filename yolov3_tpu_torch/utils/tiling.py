"""Ghost-zone tiling for large-image inference (the port's own copy of
`yolov3_tpu/utils/tiling.py`, which imports the JAX package's config).

Geometry as the reference's (reference/inference_tiled.py:25-100,236-301):

- each tile owns a "zone of responsibility" = tile - 2 * edge_range per
  axis; the edge_range radius collapses to 0 along axes where the image is
  not larger than the tile
- tiles walk the image on the zone grid, padded with reflection at borders;
  a padded tile's origin is recorded as max(0, start), as the reference
  records it
- tile sizes and the ghost radius must be multiples of the network's
  downsample factor (32)
- after per-tile detection and NMS, boxes whose CENTERS fall in a ghost
  margin are culled unless that margin is the true image border; survivors
  shift into global coordinates
- stitching: concatenate, round to int, drop centers outside the image,
  clamp corners into the image. There is no cross-tile NMS: the ghost-zone
  rule alone removes duplicates.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from yolov3_tpu_torch.config import (EDGE_EFFECT_RANGE,
                                     NETWORK_DOWNSAMPLE_FACTOR)


def convert_image_to_tiles(img: np.ndarray, tile_size: Sequence[int],
                           edge_range: int = EDGE_EFFECT_RANGE,
                           ) -> Tuple[List[np.ndarray], List[int], List[int]]:
    """Split an HWC image into reflect-padded tiles.

    Returns (tiles, x_origins, y_origins); origins are the global pixel
    coordinates of each tile's upper-left corner, clamped at 0.
    """
    height, width = img.shape[0], img.shape[1]
    assert tile_size[0] % NETWORK_DOWNSAMPLE_FACTOR == 0
    assert tile_size[1] % NETWORK_DOWNSAMPLE_FACTOR == 0

    radius = [edge_range, edge_range]
    if tile_size[0] >= height:
        radius[0] = 0
    if tile_size[1] >= width:
        radius[1] = 0
    assert radius[0] % NETWORK_DOWNSAMPLE_FACTOR == 0
    assert radius[1] % NETWORK_DOWNSAMPLE_FACTOR == 0
    zone = [tile_size[0] - 2 * radius[0], tile_size[1] - 2 * radius[1]]
    assert zone[0] > 0 and zone[1] > 0, (
        f"tile {tuple(tile_size)} too small for ghost radius {edge_range}")

    tiles: List[np.ndarray] = []
    x_origins: List[int] = []
    y_origins: List[int] = []
    for i in range(0, height, zone[0]):
        for j in range(0, width, zone[1]):
            y_st, y_end = i - radius[0], i + zone[0] + radius[0]
            x_st, x_end = j - radius[1], j + zone[1] + radius[1]
            pre_y, pre_x = max(0, -y_st), max(0, -x_st)
            post_y, post_x = max(0, y_end - height), max(0, x_end - width)
            tile = img[max(0, y_st):min(y_end, height),
                       max(0, x_st):min(x_end, width)]
            if pre_y or pre_x or post_y or post_x:
                tile = np.pad(tile, ((pre_y, post_y), (pre_x, post_x), (0, 0)),
                              mode="reflect")
            tiles.append(tile)
            x_origins.append(max(0, x_st))
            y_origins.append(max(0, y_st))
    return tiles, x_origins, y_origins


def ghost_zone_keep_mask(boxes: np.ndarray, tile_x: int, tile_y: int,
                         tile_size: Sequence[int], img_size: Sequence[int],
                         edge_range: int = EDGE_EFFECT_RANGE) -> np.ndarray:
    """Keep-mask for per-tile ltrb boxes against the ghost margins: a box
    is culled when its center lies within `edge_range` of a tile edge
    unless that edge is the true image border."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    cx = (boxes[:, 2] + boxes[:, 0]) / 2.0
    cy = (boxes[:, 3] + boxes[:, 1]) / 2.0
    cx_g, cy_g = cx + tile_x, cy + tile_y
    invalid = ((cy_g > edge_range) & (cy < edge_range)) \
        | ((cy_g <= img_size[0] - edge_range)
           & (cy >= tile_size[0] - edge_range)) \
        | ((cx_g > edge_range) & (cx < edge_range)) \
        | ((cx_g <= img_size[1] - edge_range)
           & (cx >= tile_size[1] - edge_range))
    return ~invalid


def stitch_tile_detections(boxes_list: List[np.ndarray],
                           scores_list: List[np.ndarray],
                           labels_list: List[np.ndarray],
                           img_size: Sequence[int]) -> np.ndarray:
    """Merge per-tile global-coordinate results into [M, 6] predictions
    [x1, y1, x2, y2, score, class] (reference/inference_tiled.py:272-310)."""
    if not boxes_list:
        return np.zeros((0, 6))
    boxes = np.round(np.concatenate(boxes_list, axis=0)).astype(np.int32)
    scores = np.concatenate(scores_list, axis=0).reshape(-1, 1)
    labels = np.concatenate(labels_list, axis=0).reshape(-1, 1)

    cx = (boxes[:, 2] + boxes[:, 0]) / 2.0
    cy = (boxes[:, 3] + boxes[:, 1]) / 2.0
    keep = ~(((cx < 0) | (cx >= img_size[1]))
             | ((cy < 0) | (cy >= img_size[0])))
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, img_size[1] - 1)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, img_size[0] - 1)
    return np.concatenate([boxes, scores, labels], axis=-1)
