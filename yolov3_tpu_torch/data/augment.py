"""Joint image + box augmentation on the host, numpy and scipy only (copy
of `yolov3_tpu/data/augment.py`: the same functions, with the same
`RandomState` draws in the same order, so one seed gives the same boxes
and, to float32 rounding, the same image).

Parity target: reference/augment.py:20-298. Transform chain
(reference/augment.py:30-125):
  1. Bernoulli x/y reflection decisions
  2. random anisotropic scale in [max(crop_fit, 1-s), 1+s]
  3. per-box location/size jitter ~ N(0, severity * dim)
  4. affine: rescale -> random crop to target -> flips (boxes transformed
     to match, with off-image and <12 px culls)
  5. additive Gaussian noise, sigma ~ U(-s, s) * dynamic range
  6. Gaussian blur, sigma ~ U(-max, max) clamped at 0 (so blur applies on
     roughly half the draws) — blurs across channels with a scalar sigma,
     exactly like the reference's scipy call (reference/augment.py:122)

The JAX module rescales with OpenCV's bilinear resize; this one has its
own (`_rescale_image`, the same sample positions and weights, within
1.5 float32 ulp of OpenCV's pixels), since the card's host has no
OpenCV.

Boxes are [N, 5] int rows of [x, y, w, h, class-id]; `None` is returned when
every box is culled (reference/augment.py:236-238).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage

BOX_MIN_EXTENT = 12  # cull boxes with <12 px remaining (reference/augment.py:226)


def _linear_taps(src: int, dst: int):
    """Bilinear sample taps of a `src` -> `dst` resize, as OpenCV's
    INTER_LINEAR places them: pixel centres aligned, position (d + 0.5) *
    src / dst - 0.5, its fraction taken in float64, edges clamped."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(pos)
    frac = (pos - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    edge = (i0 < 0) | (i0 >= src - 1)
    frac[edge] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1.0) - frac, frac


def _rescale_image(img: np.ndarray, scale_y: float, scale_x: float) -> np.ndarray:
    """Bilinear rescale to round(size * scale), rows then columns in
    float32 (the JAX module's `cv2.resize(..., INTER_LINEAR)`)."""
    if scale_y == 1.0 and scale_x == 1.0:
        return img
    out_h = int(round(img.shape[0] * scale_y))
    out_w = int(round(img.shape[1] * scale_x))
    x = img if img.ndim == 3 else img[:, :, None]
    x0, x1, a0, a1 = _linear_taps(x.shape[1], out_w)
    y0, y1, b0, b1 = _linear_taps(x.shape[0], out_h)
    rows = x[:, x0] * a0[:, None] + x[:, x1] * a1[:, None]
    out = rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]
    return out if img.ndim == 3 else out[:, :, 0]


def apply_affine_transformation(img: np.ndarray, reflect_x: bool,
                                reflect_y: bool, scale_x: float,
                                scale_y: float, crop_to: Sequence[int],
                                rng: Optional[np.random.RandomState] = None,
                                ) -> Tuple[np.ndarray, int, int]:
    """Rescale, random-crop to `crop_to`, then flip. Returns (img, dx, dy).

    Matches reference/augment.py:275-298: the crop offset is drawn uniformly
    from the surplus after scaling.
    """
    rng = rng or np.random
    assert img.ndim in (2, 3)
    img = _rescale_image(img, scale_y, scale_x)

    dy = dx = 0
    surplus_y = img.shape[0] - crop_to[0]
    surplus_x = img.shape[1] - crop_to[1]
    if surplus_y > 0:
        dy = int(rng.randint(0, surplus_y))
    if surplus_x > 0:
        dx = int(rng.randint(0, surplus_x))
    img = img[dy:dy + crop_to[0], dx:dx + crop_to[1]]

    if reflect_x:
        img = np.fliplr(img)
    if reflect_y:
        img = np.flipud(img)
    return img, dx, dy


def apply_affine_transformation_boxes(boxes: Optional[np.ndarray],
                                      crop_size: Sequence[int],
                                      reflect_x: bool, reflect_y: bool,
                                      scale_x: float, scale_y: float,
                                      crop_dx: int, crop_dy: int,
                                      ) -> Optional[np.ndarray]:
    """Apply the image affine to [N,5] xywh boxes; cull off-image/thin boxes.

    Matches reference/augment.py:192-272, including:
    - inclusive-corner convention (x_end = x + w - 1, w = x_end - x_st + 1)
    - two-stage cull: fully off-image, then <12 px remaining extent
    - clamp to crop, then reflect as x' = W - x (note: W, not W-1 — a
      reference quirk that offsets reflected boxes by one pixel)
    - returns None when all boxes are culled
    """
    if boxes is None or boxes.shape[0] == 0:
        return None

    cls = boxes[:, 4].astype(np.float64)
    x_st = boxes[:, 0] * scale_x - crop_dx
    x_end = (boxes[:, 0] + boxes[:, 2] - 1) * scale_x - crop_dx
    y_st = boxes[:, 1] * scale_y - crop_dy
    y_end = (boxes[:, 1] + boxes[:, 3] - 1) * scale_y - crop_dy

    h, w = crop_size[0], crop_size[1]

    off_image = ((x_st >= w) | (y_st >= h)) | ((x_end < 0) | (y_end < 0))
    too_thin = ((x_st >= w - BOX_MIN_EXTENT) | (y_st >= h - BOX_MIN_EXTENT)
                | (x_end < BOX_MIN_EXTENT) | (y_end < BOX_MIN_EXTENT))
    keep = ~(off_image | too_thin)
    if not np.any(keep):
        return None
    x_st, y_st = x_st[keep], y_st[keep]
    x_end, y_end = x_end[keep], y_end[keep]
    cls = cls[keep]

    x_st = np.maximum(x_st, 0)
    y_st = np.maximum(y_st, 0)
    x_end = np.minimum(x_end, w - 1)
    y_end = np.minimum(y_end, h - 1)

    if reflect_x:
        x_st, x_end = w - x_end, w - x_st
    if reflect_y:
        y_st, y_end = h - y_end, h - y_st

    out_w = x_end - x_st + 1
    out_h = y_end - y_st + 1
    assert np.all(out_w > 0) and np.all(out_h > 0), "box with zero or negative size"

    return np.stack([x_st, y_st, out_w, out_h, cls], axis=1).astype(np.int32)


def augment_boxes(boxes: Optional[np.ndarray], location_jitter_percent: float,
                  size_percent: float, img_size: Sequence[int],
                  rng: Optional[np.random.RandomState] = None,
                  ) -> Optional[np.ndarray]:
    """Gaussian jitter of box location and size, clamped to the image.

    Matches reference/augment.py:128-189: per-box sigma is severity * extent,
    deltas are truncated to int, size jitter re-centers by delta/2.
    """
    rng = rng or np.random
    if boxes is None or boxes.shape[0] == 0:
        return None if boxes is None else boxes

    cls = boxes[:, 4].astype(np.float64)
    x_st = boxes[:, 0].astype(np.float64)
    y_st = boxes[:, 1].astype(np.float64)
    w = boxes[:, 2].astype(np.float64)
    h = boxes[:, 3].astype(np.float64)

    for i in range(len(x_st)):
        x_st[i] += int(location_jitter_percent * w[i] * rng.randn())
        y_st[i] += int(location_jitter_percent * h[i] * rng.randn())

    for i in range(len(x_st)):
        delta = int(size_percent * w[i] * rng.randn())
        x_st[i] -= int(delta / 2)
        w[i] += delta
        delta = int(size_percent * h[i] * rng.randn())
        y_st[i] -= int(delta / 2)
        h[i] += delta

    x_end = x_st + w - 1
    y_end = y_st + h - 1
    x_st = np.maximum(x_st, 0)
    y_st = np.maximum(y_st, 0)
    x_end = np.minimum(x_end, img_size[1] - 1)
    y_end = np.minimum(y_end, img_size[0] - 1)
    w = x_end - x_st + 1
    h = y_end - y_st + 1
    assert np.all(w > 0) and np.all(h > 0), "box with zero or negative size"

    return np.stack([x_st, y_st, w, h, cls], axis=1).astype(np.int32)


def crop_to_size(img: np.ndarray, boxes: Optional[np.ndarray],
                 crop_to: Sequence[int],
                 rng: Optional[np.random.RandomState] = None,
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Identity-parameter affine: random crop to `crop_to` only
    (reference/augment.py:20-27)."""
    img, dx, dy = apply_affine_transformation(img, False, False, 1.0, 1.0,
                                              crop_to, rng=rng)
    boxes = apply_affine_transformation_boxes(boxes, crop_to, False, False,
                                              1.0, 1.0, dx, dy)
    return img, boxes


def augment_image_box_pair(img: np.ndarray, boxes: Optional[np.ndarray],
                           rotation_flag: bool = False,
                           reflection_flag: bool = False,
                           crop_to: Optional[Sequence[int]] = None,
                           noise_augmentation_severity: float = 0,
                           scale_augmentation_severity: float = 0,
                           blur_augmentation_max_sigma: float = 0,
                           box_size_augmentation_severity: float = 0,
                           box_location_jitter_severity: float = 0,
                           rng: Optional[np.random.RandomState] = None,
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Full augmentation chain (reference/augment.py:30-125); the JAX
    module's debug option that pins the draws at their maxima is not
    copied."""
    assert not rotation_flag, "Rotation not implemented for image and boxes pair"
    rng = rng or np.random
    img = np.asarray(img, dtype=np.float32)
    assert img.ndim in (2, 3)

    noise_augmentation_severity = noise_augmentation_severity or 0
    scale_augmentation_severity = scale_augmentation_severity or 0
    blur_augmentation_max_sigma = blur_augmentation_max_sigma or 0
    box_size_augmentation_severity = box_size_augmentation_severity or 0
    box_location_jitter_severity = box_location_jitter_severity or 0
    assert 0 <= noise_augmentation_severity < 1
    assert 0 <= scale_augmentation_severity < 1
    assert 0 <= box_size_augmentation_severity < 1
    assert 0 <= box_location_jitter_severity < 1

    reflect_x = reflect_y = False
    scale_x = scale_y = 1.0
    if reflection_flag:
        reflect_x = bool(rng.rand() > 0.5)
        reflect_y = bool(rng.rand() > 0.5)

    if scale_augmentation_severity > 0:
        # floor the scale so the rescaled image still covers the crop window
        # (reference/augment.py:77-88)
        hi = 1.0 + scale_augmentation_severity
        lo = max(crop_to[0] / img.shape[0], crop_to[1] / img.shape[1],
                 1.0 - scale_augmentation_severity)
        scale_x = lo + (hi - lo) * rng.rand()
        scale_y = lo + (hi - lo) * rng.rand()

    boxes = augment_boxes(boxes, box_location_jitter_severity,
                          box_size_augmentation_severity, img.shape, rng=rng)
    img, dx, dy = apply_affine_transformation(img, reflect_x, reflect_y,
                                              scale_x, scale_y, crop_to, rng=rng)
    boxes = apply_affine_transformation_boxes(boxes, crop_to, reflect_x,
                                              reflect_y, scale_x, scale_y,
                                              dx, dy)

    if noise_augmentation_severity > 0:
        sigma_max = noise_augmentation_severity * (np.max(img) - np.min(img))
        sigma = -sigma_max + 2.0 * sigma_max * rng.rand()
        img = img + rng.standard_normal(img.shape) * sigma

    if blur_augmentation_max_sigma > 0:
        sigma = (-blur_augmentation_max_sigma
                 + 2.0 * blur_augmentation_max_sigma * rng.rand())
        if sigma > 0:
            img = scipy.ndimage.gaussian_filter(img, sigma, mode="reflect")

    return np.asarray(img, dtype=np.float32), boxes
