"""Plain reference of the training feed on the card: augmentation on given
draws, per-image z-score, dense YOLO label grids
(usnistgov/object-detection-yolov3 `augment.py`, `imagereader.py`,
`yolo_encoder`), a frozen copy of the arithmetic, batched over B.

Draws (`make_draws`), per image: reflect_x, reflect_y (p 0.5 each with
reflection on); scale_x, scale_y in [max(1, 1-s), 1+s]; integral crop
offsets floor(u * (floor(size * scale) - size)); 4 x M box-jitter
normals; a noise factor in [-1, 1) and H x W x C noise normals; a blur
sigma in [-max, max] (<= 0: no blur).

Order: box jitter (int truncation) -> rescale, crop, flips as a separable
bilinear warp -> box affine and the off-image / thinner-than-12-px culls
-> noise scaled by the image's dynamic range -> Gaussian blur over H, W
and C (reflect padding, radius ceil(3 max sigma)) -> z-score -> label
grids: the box centre floor(xy + (wh - 1) / 2), the anchor of best
origin-centred IoU, a later box overwriting an earlier one's coordinates
in a shared (cell, anchor) slot while the class bits accumulate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

F32 = torch.float32
BOX_MIN_EXTENT = 12


def make_draws(gen: torch.Generator, batch: int, shape: Sequence[int],
               max_boxes: int, acfg: dict) -> Dict[str, torch.Tensor]:
    """Every random value of one batch's augmentation, on gen's device."""
    dev = gen.device
    h, w = int(shape[0]), int(shape[1])

    def uniform(*s):
        return torch.rand(s, generator=gen, device=dev)

    d = {}
    if acfg["reflection_flag"]:
        d["reflect_x"] = uniform(batch) > 0.5
        d["reflect_y"] = uniform(batch) > 0.5
    else:
        d["reflect_x"] = d["reflect_y"] = torch.zeros(batch, dtype=torch.bool,
                                                      device=dev)
    s = acfg["scale_augmentation_severity"]
    lo, hi = max(1.0, 1.0 - s), 1.0 + s
    d["scale_x"] = lo + uniform(batch) * (hi - lo)
    d["scale_y"] = lo + uniform(batch) * (hi - lo)
    d["dy"] = torch.floor(uniform(batch) * (torch.floor(h * d["scale_y"]) - h))
    d["dx"] = torch.floor(uniform(batch) * (torch.floor(w * d["scale_x"]) - w))
    d["jitter"] = torch.randn((4, batch, max_boxes), generator=gen, device=dev)
    d["noise_factor"] = uniform(batch) * 2.0 - 1.0
    d["noise"] = torch.randn((batch, *shape), generator=gen, device=dev)
    m = acfg["blur_augmentation_max_sigma"]
    d["blur_sigma"] = uniform(batch) * (2.0 * m) - m
    return d


def _take(img, idx, axis):
    shape = list(img.shape)
    shape[axis] = idx.shape[1]
    view = [idx.shape[0], 1, 1, 1]
    view[axis] = idx.shape[1]
    return torch.gather(img, axis, idx.view(view).expand(shape))


def _interp_axis(img, coords, axis, size):
    coords = torch.clamp(coords, 0.0, size - 1.0)
    lo_f = torch.floor(coords)
    lo = lo_f.to(torch.int64)
    hi = torch.clamp(lo + 1, max=size - 1)
    view = [coords.shape[0], 1, 1, 1]
    view[axis] = coords.shape[1]
    frac = (coords - lo_f).view(view)
    return _take(img, lo, axis) * (1.0 - frac) + _take(img, hi, axis) * frac


def warp(img, d):
    h, w = img.shape[1], img.shape[2]
    rows = torch.arange(h, dtype=F32, device=img.device)
    cols = torch.arange(w, dtype=F32, device=img.device)
    rows = torch.where(d["reflect_y"][:, None], rows.flip(0), rows)
    cols = torch.where(d["reflect_x"][:, None], cols.flip(0), cols)
    ys = (rows + d["dy"][:, None]) / d["scale_y"][:, None]
    xs = (cols + d["dx"][:, None]) / d["scale_x"][:, None]
    img = _interp_axis(img, ys, 1, h)
    return _interp_axis(img, xs, 2, w)


def _reflect_index(size, r, device):
    idx = torch.arange(-r, size + r, device=device).abs()
    return torch.where(idx >= size, 2 * (size - 1) - idx, idx)


def blur(img, sigma, max_sigma):
    b = img.shape[0]
    radius = max(int(math.ceil(3.0 * max_sigma)), 1)
    offsets = torch.arange(-radius, radius + 1, dtype=F32, device=img.device)
    sig = torch.clamp(sigma, min=1e-6)[:, None]
    wts = torch.exp(-0.5 * (offsets / sig) ** 2)
    wts = wts / wts.sum(dim=1, keepdim=True)
    identity = (offsets == 0.0).to(F32)
    wts = torch.where(sigma[:, None] > 0.0, wts, identity)
    for axis in (1, 2, 3):
        size = img.shape[axis]
        r = min(radius, size - 1)
        if r == 0:
            continue
        xp = img.index_select(axis, _reflect_index(size, r, img.device))
        out = torch.zeros_like(img)
        for k in range(-r, r + 1):
            out = out + wts[:, k + radius].view(b, 1, 1, 1) * xp.narrow(
                axis, k + r, size)
        wsum = wts[:, radius - r:radius + r + 1].sum(dim=1)
        img = out / wsum.view(b, 1, 1, 1)
    return img


def zscore(x):
    x = x.to(F32)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True))
    return torch.where(std <= 1.0, x - mean, (x - mean) / std)


def jitter_boxes(boxes, loc, size_sev, hw, n):
    x, y, w, h, c = boxes.to(F32).unbind(-1)
    x = x + torch.trunc(loc * w * n[0])
    y = y + torch.trunc(loc * h * n[1])
    dw = torch.trunc(size_sev * w * n[2])
    dh = torch.trunc(size_sev * h * n[3])
    x = x - torch.trunc(dw / 2.0)
    w = w + dw
    y = y - torch.trunc(dh / 2.0)
    h = h + dh
    x_end = torch.clamp(x + w - 1, max=hw[1] - 1)
    y_end = torch.clamp(y + h - 1, max=hw[0] - 1)
    x = torch.clamp(x, min=0.0)
    y = torch.clamp(y, min=0.0)
    return torch.stack([x, y, x_end - x + 1, y_end - y + 1, c], -1)


def _mul_sub(a, b, c):
    """a * b - c rounded once to float32 (a fused multiply-add)."""
    return (a.double() * b.double() - c.double()).to(F32)


def affine_boxes(boxes, valid, hw, d):
    ch, cw = float(hw[0]), float(hw[1])
    sx, sy = d["scale_x"][:, None], d["scale_y"][:, None]
    dx, dy = d["dx"][:, None], d["dy"][:, None]
    x_st = _mul_sub(boxes[..., 0], sx, dx)
    x_end = _mul_sub(boxes[..., 0] + boxes[..., 2] - 1, sx, dx)
    y_st = _mul_sub(boxes[..., 1], sy, dy)
    y_end = _mul_sub(boxes[..., 1] + boxes[..., 3] - 1, sy, dy)
    off = ((x_st >= cw) | (y_st >= ch)) | ((x_end < 0) | (y_end < 0))
    thin = ((x_st >= cw - BOX_MIN_EXTENT) | (y_st >= ch - BOX_MIN_EXTENT)
            | (x_end < BOX_MIN_EXTENT) | (y_end < BOX_MIN_EXTENT))
    valid = valid & ~(off | thin)
    x_st, y_st = torch.clamp(x_st, min=0.0), torch.clamp(y_st, min=0.0)
    x_end = torch.clamp(x_end, max=cw - 1)
    y_end = torch.clamp(y_end, max=ch - 1)
    rx, ry = d["reflect_x"][:, None], d["reflect_y"][:, None]
    rx_st = torch.where(rx, cw - x_end, x_st)
    rx_end = torch.where(rx, cw - x_st, x_end)
    ry_st = torch.where(ry, ch - y_end, y_st)
    ry_end = torch.where(ry, ch - y_st, y_end)
    out = torch.stack([rx_st, ry_st, rx_end - rx_st + 1, ry_end - ry_st + 1,
                       boxes[..., 4]], -1)
    return torch.trunc(out), valid


def encode(boxes, valid, image_size, anchors, classes) -> List[torch.Tensor]:
    """Label grids [B, gh, gw, A, 5 + C] at strides 32, 16, 8."""
    dev = boxes.device
    b, m = boxes.shape[0], boxes.shape[1]
    anc = torch.tensor(anchors, dtype=F32, device=dev)
    na = anc.shape[0]
    img_h, img_w = float(image_size[0]), float(image_size[1])
    boxes = boxes.to(F32)
    wh = boxes[..., 2:4]
    centers = torch.floor(boxes[..., 0:2] + (wh - 1.0) / 2.0)
    inter_wh = torch.clamp(torch.minimum(wh[..., None, :] / 2.0, anc / 2.0)
                           * 2.0, min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    iou = inter / ((wh[..., 0] * wh[..., 1])[..., None]
                   + anc[:, 0] * anc[:, 1] - inter)
    best = torch.argmax(iou, dim=-1)
    cls = boxes[..., 4].to(torch.int32).to(torch.int64)
    cls_ok = valid & (cls >= 0) & (cls < classes)
    cls = torch.clamp(cls, 0, classes - 1)
    rows = torch.cat([centers, wh], -1)
    prio = (torch.arange(1, m + 1, dtype=F32, device=dev)
            * valid.to(F32))
    out = []
    for div in (32, 16, 8):
        gh, gw = int(image_size[0]) // div, int(image_size[1]) // div
        slots = gh * gw * na
        i = torch.clamp(torch.floor(centers[..., 1] / img_h * gh).to(
            torch.int64), 0, gh - 1)
        j = torch.clamp(torch.floor(centers[..., 0] / img_w * gw).to(
            torch.int64), 0, gw - 1)
        q = (i * gw + j) * na + best
        win = torch.zeros((b, slots), device=dev).scatter_reduce(
            1, q, prio, "amax")
        occ = win > 0.0
        winner = torch.clamp(win.to(torch.int64) - 1, min=0)
        coords = torch.gather(rows, 1, winner[..., None].expand(b, slots, 4))
        coords = torch.where(occ[..., None], coords, 0.0)
        bits = torch.zeros((b, slots * classes), device=dev).scatter_reduce(
            1, q * classes + cls, cls_ok.to(F32), "amax")
        grid = torch.cat([coords, occ.to(F32)[..., None],
                          bits.view(b, slots, classes)], -1)
        out.append(grid.view(b, gh, gw, na, 5 + classes))
    return out


def preprocess(raw, boxes, valid, d, acfg, image_size, anchors, classes
               ) -> Tuple[torch.Tensor, ...]:
    """(z-scored images, label grids at strides 32, 16, 8) of one batch."""
    images = raw.to(F32)
    h, w = images.shape[1], images.shape[2]
    boxes = jitter_boxes(boxes.to(F32), acfg["box_location_jitter_severity"],
                         acfg["box_size_augmentation_severity"], (h, w),
                         d["jitter"])
    images = warp(images, d)
    boxes, valid = affine_boxes(boxes, valid.to(torch.bool), (h, w), d)
    if acfg["noise_augmentation_severity"] > 0:
        rng = images.amax(dim=(1, 2, 3)) - images.amin(dim=(1, 2, 3))
        sigma = d["noise_factor"] * (acfg["noise_augmentation_severity"] * rng)
        images = images + d["noise"] * sigma.view(-1, 1, 1, 1)
    if acfg["blur_augmentation_max_sigma"] > 0:
        images = blur(images, d["blur_sigma"],
                      acfg["blur_augmentation_max_sigma"])
    return (zscore(images), *encode(boxes, valid, image_size, anchors,
                                    classes))
