"""On-device augmentation, normalization and label encoding (port of
`yolov3_tpu/data/device_pipeline.py`).

The host workers only decode records (`reader.py`'s raw mode); this
module runs the rest of the per-batch chain on the batch's device:

  reflect / anisotropic-scale / crop warp -> box affine + cull ->
  noise -> blur -> per-image z-score -> dense YOLO label grids

Semantics are the JAX module's (the same parameter ranges, culls and
grid-write rules). Every step is batched over B on `[B,H,W,C]` tensors;
there is no vmap. Randomness is split from arithmetic:
`draw_augment` makes every random value of a batch from one
`torch.Generator`, and `augment_batch` is deterministic in those draws,
so two devices (or this port and the JAX module) can be held to each
other on the same draws although their generators differ.

Boxes travel as fixed-size `[B, M, 5]` float tensors (x, y, w, h, c)
with a `[B, M]` validity mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from yolov3_tpu_torch.config import AugmentConfig
from yolov3_tpu_torch.data.augment import BOX_MIN_EXTENT
from yolov3_tpu_torch.utils import tracing


@dataclasses.dataclass
class AugmentDraws:
    """The random values of one batch's augmentation, final per image
    (the values `_augment_one` of the JAX module draws).

    reflect_x, reflect_y: [B] bool; scale_x, scale_y: [B] in
    [max(1, 1-s), 1+s]; dx, dy: [B] integral crop offsets,
    floor(u * (floor(size * scale) - size)); jitter: [4, B, M] standard
    normals (x, y, w, h); noise_factor: [B] in [-1, 1) and noise:
    [B, H, W, C] standard normals, or None when the noise step is off;
    blur_sigma: [B] in [-max, max], or None when the blur is off.
    """

    reflect_x: torch.Tensor
    reflect_y: torch.Tensor
    scale_x: torch.Tensor
    scale_y: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    jitter: torch.Tensor
    noise_factor: Optional[torch.Tensor]
    noise: Optional[torch.Tensor]
    blur_sigma: Optional[torch.Tensor]

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def draw_augment(gen: torch.Generator, batch: int,
                 image_shape: Sequence[int], max_boxes: int,
                 cfg: AugmentConfig) -> AugmentDraws:
    """Every random value of one batch's augmentation, from `gen`, on
    `gen`'s device."""
    dev = gen.device
    h, w = int(image_shape[0]), int(image_shape[1])

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    reflect_x = reflect_y = torch.zeros(batch, dtype=torch.bool, device=dev)
    if cfg.reflection_flag:
        reflect_x = uniform(batch) > 0.5
        reflect_y = uniform(batch) > 0.5

    scale_x = scale_y = torch.ones(batch, device=dev)
    dy = dx = torch.zeros(batch, device=dev)
    if cfg.scale_augmentation_severity > 0:
        # crop size == image size, so the scale floor is max(1, 1-s)
        # (reference/augment.py:77-88 with fx = fy = 1)
        lo = max(1.0, 1.0 - cfg.scale_augmentation_severity)
        hi = 1.0 + cfg.scale_augmentation_severity
        scale_x = lo + uniform(batch) * (hi - lo)
        scale_y = lo + uniform(batch) * (hi - lo)
        # integer crop offset within the upscale surplus
        dy = torch.floor(uniform(batch) * (torch.floor(h * scale_y) - h))
        dx = torch.floor(uniform(batch) * (torch.floor(w * scale_x) - w))

    jitter = torch.randn((4, batch, max_boxes), generator=gen, device=dev)

    noise_factor = noise = None
    if cfg.noise_augmentation_severity > 0:
        noise_factor = uniform(batch) * 2.0 - 1.0
        noise = torch.randn((batch, *image_shape), generator=gen, device=dev)

    blur_sigma = None
    if cfg.blur_augmentation_max_sigma > 0:
        m = cfg.blur_augmentation_max_sigma
        blur_sigma = uniform(batch) * (2.0 * m) - m
    return AugmentDraws(reflect_x, reflect_y, scale_x, scale_y, dx, dy,
                        jitter, noise_factor, noise, blur_sigma)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _take(img: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """img [B,H,W,C] gathered along `axis` (1 or 2) at per-image whole
    rows or columns idx [B, n]."""
    shape = list(img.shape)
    shape[axis] = idx.shape[1]
    view = [idx.shape[0], 1, 1, 1]
    view[axis] = idx.shape[1]
    return torch.gather(img, axis, idx.view(view).expand(shape))


def _interp_axis(img: torch.Tensor, coords: torch.Tensor, axis: int,
                 size: int) -> torch.Tensor:
    """1-D linear interpolation of each image along `axis` at its float
    `coords` [B, n]."""
    coords = torch.clamp(coords, 0.0, size - 1.0)
    lo_f = torch.floor(coords)
    lo = lo_f.to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    view = [coords.shape[0], 1, 1, 1]
    view[axis] = coords.shape[1]
    frac = (coords - lo_f).view(view)
    a = _take(img, lo, axis)
    b = _take(img, hi, axis)
    return a * (1.0 - frac) + b * frac


def _warp_image(img: torch.Tensor, scale_y: torch.Tensor,
                scale_x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                reflect_x: torch.Tensor, reflect_y: torch.Tensor
                ) -> torch.Tensor:
    """Rescale-by-(sy,sx) -> crop at (dy,dx) -> flips, as a separable
    bilinear warp: per-image row and column coordinates, a gather along
    H, then along W (reference/augment.py:275-298 with the crop size
    equal to the image size)."""
    h, w = img.shape[1], img.shape[2]
    rows = torch.arange(h, dtype=torch.float32, device=img.device)
    cols = torch.arange(w, dtype=torch.float32, device=img.device)
    rows = torch.where(reflect_y[:, None], rows.flip(0), rows)
    cols = torch.where(reflect_x[:, None], cols.flip(0), cols)
    ys = (rows + dy[:, None]) / scale_y[:, None]
    xs = (cols + dx[:, None]) / scale_x[:, None]
    img = _interp_axis(img, ys, axis=1, size=h)
    return _interp_axis(img, xs, axis=2, size=w)


def _reflect_index(size: int, r: int, device) -> torch.Tensor:
    """Source indices of numpy's `reflect` padding by r a side (the edge
    is not repeated)."""
    idx = torch.arange(-r, size + r, device=device).abs()
    return torch.where(idx >= size, 2 * (size - 1) - idx, idx)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                   max_sigma: float) -> torch.Tensor:
    """Gaussian blur with a per-image sigma [B] over H, W AND C (the
    reference blurs the channel axis too: a scalar-sigma scipy call on an
    HWC array, reference/augment.py:122). sigma <= 0 is the identity.

    Reflect padding, radius ceil(3 * max_sigma), clamped to size - 1 on a
    short axis and renormalised by the sum of the weights used; the taps
    summed k = -r..r from zeros, as the JAX module sums them."""
    b = img.shape[0]
    radius = max(int(math.ceil(3.0 * max_sigma)), 1)
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=img.device)
    sig = torch.clamp(sigma, min=1e-6)[:, None]
    weights = torch.exp(-0.5 * (offsets / sig) ** 2)
    weights = weights / weights.sum(dim=1, keepdim=True)
    identity = (offsets == 0.0).to(torch.float32)
    weights = torch.where(sigma[:, None] > 0.0, weights, identity)

    for axis in (1, 2, 3):
        size = img.shape[axis]
        r = min(radius, size - 1)
        if r == 0:
            continue
        xp = img.index_select(axis, _reflect_index(size, r, img.device))
        out = torch.zeros_like(img)
        for k in range(-r, r + 1):
            out = out + weights[:, k + radius].view(b, 1, 1, 1) \
                * xp.narrow(axis, k + r, size)
        wsum = weights[:, radius - r:radius + r + 1].sum(dim=1)
        img = out / wsum.view(b, 1, 1, 1)
    return img


def zscore_image(img: torch.Tensor) -> torch.Tensor:
    """Per-image z-score of one image, in float32, with the std <= 1
    guard (reference/imagereader.py:34-46); `zscore_images` is the
    batched form."""
    x = img.to(torch.float32)
    mean = x.mean()
    std = torch.sqrt(((x - mean) ** 2).mean())
    return torch.where(std <= 1.0, x - mean, (x - mean) / std)


def zscore_images(images: torch.Tensor) -> torch.Tensor:
    """Per-image z-score of an NHWC batch, in float32, on the batch's device.

    Population std over each whole image; an image with std <= 1 is only
    mean-subtracted (reference/imagereader.py:34-46). Accepts raw integer
    pixels and converts them on the device.
    """
    x = images.to(torch.float32)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True))
    return torch.where(std <= 1.0, x - mean, (x - mean) / std)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _jitter_boxes(boxes: torch.Tensor, loc_sev: float, size_sev: float,
                  img_hw: Tuple[int, int], normals: torch.Tensor
                  ) -> torch.Tensor:
    """Location/size jitter (reference/augment.py:128-189), int
    truncation; boxes [B, M, 5], normals [4, B, M]."""
    x, y, w, h, c = boxes.to(torch.float32).unbind(-1)
    x = x + torch.trunc(loc_sev * w * normals[0])
    y = y + torch.trunc(loc_sev * h * normals[1])
    dw = torch.trunc(size_sev * w * normals[2])
    dh = torch.trunc(size_sev * h * normals[3])
    x = x - torch.trunc(dw / 2.0)
    w = w + dw
    y = y - torch.trunc(dh / 2.0)
    h = h + dh
    x_end = torch.clamp(x + w - 1, max=img_hw[1] - 1)
    y_end = torch.clamp(y + h - 1, max=img_hw[0] - 1)
    x = torch.clamp(x, min=0.0)
    y = torch.clamp(y, min=0.0)
    return torch.stack([x, y, x_end - x + 1, y_end - y + 1, c], dim=-1)


def _mul_sub(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """a * b - c rounded once to float32, as the fused multiply-add that
    XLA's CPU backend makes of it: the float32 product is exact in
    float64, and so is the difference at box scales (both integral or of
    at most 33 significant bits), so only the final cast rounds."""
    return (a.double() * b.double() - c.double()).to(torch.float32)


def _affine_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                  crop_hw: Tuple[int, int], scale_x: torch.Tensor,
                  scale_y: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                  reflect_x: torch.Tensor, reflect_y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Box affine + off-image/thin culls (reference/augment.py:192-272);
    per-image parameters [B] against boxes [B, M, 5]."""
    ch, cw = float(crop_hw[0]), float(crop_hw[1])
    sx, sy = scale_x[:, None], scale_y[:, None]
    dx, dy = dx[:, None], dy[:, None]
    x_st = _mul_sub(boxes[..., 0], sx, dx)
    x_end = _mul_sub(boxes[..., 0] + boxes[..., 2] - 1, sx, dx)
    y_st = _mul_sub(boxes[..., 1], sy, dy)
    y_end = _mul_sub(boxes[..., 1] + boxes[..., 3] - 1, sy, dy)
    cls = boxes[..., 4]

    off = ((x_st >= cw) | (y_st >= ch)) | ((x_end < 0) | (y_end < 0))
    thin = ((x_st >= cw - BOX_MIN_EXTENT) | (y_st >= ch - BOX_MIN_EXTENT)
            | (x_end < BOX_MIN_EXTENT) | (y_end < BOX_MIN_EXTENT))
    valid = valid & ~(off | thin)

    x_st = torch.clamp(x_st, min=0.0)
    y_st = torch.clamp(y_st, min=0.0)
    x_end = torch.clamp(x_end, max=cw - 1)
    y_end = torch.clamp(y_end, max=ch - 1)

    rx = reflect_x[:, None]
    ry = reflect_y[:, None]
    rx_st = torch.where(rx, cw - x_end, x_st)
    rx_end = torch.where(rx, cw - x_st, x_end)
    ry_st = torch.where(ry, ch - y_end, y_st)
    ry_end = torch.where(ry, ch - y_st, y_end)

    out = torch.stack([rx_st, ry_st, rx_end - rx_st + 1,
                       ry_end - ry_st + 1, cls], dim=-1)
    return torch.trunc(out), valid


# ---------------------------------------------------------------------------
# label encoding (device twin of data/encoder.py::encode_boxes)
# ---------------------------------------------------------------------------

def encode_labels_device(boxes: torch.Tensor, valid: torch.Tensor,
                         image_size: Sequence[int],
                         anchors: Sequence[Tuple[float, float]],
                         number_classes: int) -> List[torch.Tensor]:
    """Encode boxes [B, M, 5] (x, y, w, h, c) + validity [B, M] into the
    three dense label grids [B, gh, gw, A, 5 + C] (strides 32, 16, 8).

    The host encoder's rules: floor centre shift, best anchor by
    origin-centred IoU, written to all scales; a later box overwrites an
    earlier one's coordinates in a shared (cell, anchor) slot, but the
    one-hot class bits OR-accumulate. Each box maps to a flat slot index;
    a scatter of the box's priority (its index + 1, 0 when invalid) with
    `amax` per slot picks the last writer, whose coordinates are then
    gathered, and a second `amax` scatter sets the class bits. Both are
    order-free, so the grids are deterministic on any device, and exact
    (no matmul, so no TF32 rounding of the coordinates). Out-of-grid
    centres clamp to the border cell, as in the JAX encoder.
    """
    dev = boxes.device
    b, m = boxes.shape[0], boxes.shape[1]
    anchors_t = torch.tensor(anchors, dtype=torch.float32, device=dev)
    num_anchors = anchors_t.shape[0]
    img_h, img_w = float(image_size[0]), float(image_size[1])

    boxes = boxes.to(torch.float32)
    wh = boxes[..., 2:4]
    centers = torch.floor(boxes[..., 0:2] + (wh - 1.0) / 2.0)

    half_wh = wh[..., None, :] / 2.0
    half_anchor = anchors_t / 2.0
    inter_wh = torch.clamp(torch.minimum(half_wh, half_anchor) * 2.0,
                           min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area_box = (wh[..., 0] * wh[..., 1])[..., None]
    area_anchor = anchors_t[:, 0] * anchors_t[:, 1]
    iou = inter / (area_box + area_anchor - inter)
    best_anchor = torch.argmax(iou, dim=-1)

    cls = boxes[..., 4].to(torch.int32).to(torch.int64)
    cls_ok = valid & (cls >= 0) & (cls < number_classes)
    cls = torch.clamp(cls, 0, number_classes - 1)
    rows = torch.cat([centers, wh], dim=-1)                 # [B, M, 4]
    # ascending priority implements the later-box-overwrites rule
    prio = (torch.arange(1, m + 1, dtype=torch.float32, device=dev)
            * valid.to(torch.float32))

    labels = []
    for div in (32, 16, 8):
        gh, gw = int(image_size[0]) // div, int(image_size[1]) // div
        g_slots = gh * gw * num_anchors
        i = torch.floor(centers[..., 1] / img_h * gh).to(torch.int64)
        j = torch.floor(centers[..., 0] / img_w * gw).to(torch.int64)
        i = torch.clamp(i, 0, gh - 1)
        j = torch.clamp(j, 0, gw - 1)
        q = (i * gw + j) * num_anchors + best_anchor        # [B, M]

        win = torch.zeros((b, g_slots), device=dev).scatter_reduce(
            1, q, prio, "amax")                              # [B, G]
        occupied = win > 0.0
        winner = torch.clamp(win.to(torch.int64) - 1, min=0)
        coords = torch.gather(rows, 1, winner[..., None].expand(b, g_slots,
                                                                 4))
        coords = torch.where(occupied[..., None], coords, 0.0)
        cls_bits = torch.zeros((b, g_slots * number_classes),
                               device=dev).scatter_reduce(
            1, q * number_classes + cls, cls_ok.to(torch.float32), "amax")

        grid = torch.cat([coords, occupied.to(torch.float32)[..., None],
                          cls_bits.view(b, g_slots, number_classes)], dim=-1)
        labels.append(grid.view(b, gh, gw, num_anchors, 5 + number_classes))
    return labels


# ---------------------------------------------------------------------------
# the whole chain
# ---------------------------------------------------------------------------

def augment_batch(images: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, draws: AugmentDraws,
                  cfg: AugmentConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The augmentation of one batch on the given draws: box jitter, the
    warp, the box affine and culls, noise, blur. images [B,H,W,C] float32
    raw pixels, boxes [B,M,5], valid [B,M] bool."""
    h, w = images.shape[1], images.shape[2]
    boxes = _jitter_boxes(boxes, cfg.box_location_jitter_severity,
                          cfg.box_size_augmentation_severity, (h, w),
                          draws.jitter)
    images = _warp_image(images, draws.scale_y, draws.scale_x, draws.dy,
                         draws.dx, draws.reflect_x, draws.reflect_y)
    boxes, valid = _affine_boxes(boxes, valid, (h, w), draws.scale_x,
                                 draws.scale_y, draws.dx, draws.dy,
                                 draws.reflect_x, draws.reflect_y)
    if cfg.noise_augmentation_severity > 0:
        dyn_range = images.amax(dim=(1, 2, 3)) - images.amin(dim=(1, 2, 3))
        sigma = draws.noise_factor * (cfg.noise_augmentation_severity
                                      * dyn_range)
        images = images + draws.noise * sigma.view(-1, 1, 1, 1)
    if cfg.blur_augmentation_max_sigma > 0:
        images = _gaussian_blur(images, draws.blur_sigma,
                                cfg.blur_augmentation_max_sigma)
    return images, boxes, valid


def preprocess_batch(images: torch.Tensor, boxes: torch.Tensor,
                     valid: torch.Tensor, gen: Optional[torch.Generator],
                     cfg: AugmentConfig, image_size: Sequence[int],
                     anchors: Sequence[Tuple[float, float]],
                     number_classes: int, use_augmentation: bool = True,
                     draws: Optional[AugmentDraws] = None):
    """The device preprocessing of one batch.

    images [B,H,W,C] raw pixels (any dtype), boxes [B,M,5], valid [B,M]
    -> (z-scored float32 images, label_s32, label_s16, label_s8), on the
    images' device. With augmentation, its random values are `draws`
    when given, else drawn from `gen` (a generator on that device).
    """
    with tracing.span("yolo.feed"):
        images = images.to(torch.float32)
        boxes = boxes.to(torch.float32)
        valid = valid.to(torch.bool)
        if use_augmentation:
            if draws is None:
                draws = draw_augment(gen, images.shape[0], images.shape[1:],
                                     boxes.shape[1], cfg)
            images, boxes, valid = augment_batch(images, boxes, valid,
                                                 draws, cfg)
        images = zscore_images(images)
        labels = encode_labels_device(boxes, valid, image_size, anchors,
                                      number_classes)
        return (images, *labels)
