"""Plain reference of one training step in the configuration's compute
dtype: the train-mode forward (BatchNorm on the batch's statistics,
Flax's arithmetic; `Train`), the YOLOv3 loss in float32
(usnistgov/object-detection-yolov3 `model.py:214-354`), autograd's
gradients of the float32 parameters and Keras's Adam in float32 (b1 0.9,
b2 0.999, eps 1e-7, the bias correction on the update).

Loss, per scale, summed over the three, divided by the batch:
- objectness: sigmoid cross-entropy over cells with an object, and over
  the others whose prediction's best IoU with the anchor priors present
  in the batch (boxes at the origin) is below 0.5;
- class: sigmoid cross-entropy over cells with an object;
- xy: squared error of the inverse sigmoid of the in-cell offsets,
  clipped to [0.01, 0.99];
- wh: squared error of log(wh / anchor), zeros taken as ones, clipped to
  [1e-9, 1e9]; the wh logits capped at 80 before the exp.
The ignore mask and the targets carry no gradient.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.model import forward, no_tf32, same_pads

F32 = torch.float32
WH_LOGIT_MAX = 80.0


REGION = ("Darknet53_0/ConvBlock_0", "Darknet53_0/ConvBlock_1",
          "Darknet53_0/ConvBlock_2", "Darknet53_0/FeatureBlock_0/ConvBlock_0",
          "Darknet53_0/FeatureBlock_0/ConvBlock_1")


def _conv(x, w, b, stride):
    """SAME conv in x's dtype, NHWC; an odd pad goes to the end."""
    k = w.shape[-1]
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], k, stride),
                          same_pads(x.shape[2], k, stride))
    xn = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, b, stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, b, stride)
    return y.permute(0, 2, 3, 1)


class Train:
    """The train-mode forward in the configuration's compute dtype over
    float32 leaf parameters {block: {kernel, bias, scale, offset}}: conv
    operands, activations and residuals in that dtype (float32 sums
    inside each conv), the batch statistics and the normalisation in
    float32, its output cast back. The stem region's blocks (stem1,
    stem2, FeatureBlock_0 and the stride-2 conv after it, with
    `stem_space_to_depth`) add their bias after the conv and normalise as
    x * inv + (offset - mean * inv), inv = scale * rsqrt(var + eps), both
    factors cast to the dtype (its variance not clamped at 0)."""

    def __init__(self, params: dict, model: dict):
        self.p, self.alpha, self.eps = (params, model["leaky_relu_alpha"],
                                        model["bn_epsilon"])
        self.dt = getattr(torch, model["compute_dtype"])
        self.region = REGION if model["stem_space_to_depth"] else ()

    def image(self, x):
        return x.to(self.dt)

    @staticmethod
    def _stats(y):
        yf = y.to(F32)
        mean = yf.mean((0, 1, 2))
        return yf, mean, (yf * yf).mean((0, 1, 2)) - mean * mean

    def block(self, name, x, stride):
        p, dt = self.p[name], self.dt
        x = x.to(dt)
        if name in self.region:
            y = _conv(x, p["kernel"].to(dt), None, stride) + p["bias"].to(dt)
            y = torch.where(y >= 0, y, self.alpha * y)
            _, mean, var = self._stats(y)
            inv = torch.rsqrt(var + self.eps) * p["scale"]
            return y * inv.to(dt) + (p["offset"] - mean * inv).to(dt)
        y = F.leaky_relu(_conv(x, p["kernel"].to(dt), p["bias"].to(dt),
                               stride), self.alpha)
        yf, mean, var = self._stats(y)
        var = torch.maximum(var, var.new_tensor(0.0))
        out = (yf - mean) * (torch.rsqrt(var + self.eps) * p["scale"])
        return (out + p["offset"]).to(dt)

    def block_cat(self, name, a, b):
        return self.block(name, torch.cat([a, b], -1), 1)

    def residual(self, name, x):
        return x, x

    def add(self, a, b):
        return a + b

    def head(self, name, x):
        p, dt = self.p[name], self.dt
        return _conv(x.to(dt), p["kernel"].to(dt), p["bias"].to(dt), 1)


def _sigmoid_ce(z, x):
    return torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))


def loss_layer(fm, gt, anchors, classes, stride):
    b, gh, gw, _ = fm.shape
    na = len(anchors)
    anc = torch.tensor(anchors, dtype=F32, device=fm.device)
    f = fm.to(F32).reshape(b, gh, gw, na, 5 + classes)
    row, col = torch.meshgrid(torch.arange(gh, dtype=F32, device=fm.device),
                              torch.arange(gw, dtype=F32, device=fm.device),
                              indexing="ij")
    off = torch.stack([col, row], -1).reshape(gh, gw, 1, 2)
    pred_xy = (torch.sigmoid(f[..., 0:2]) + off) * float(stride)
    pred_wh = torch.exp(torch.clamp(f[..., 2:4], max=WH_LOGIT_MAX)) * anc
    obj_logit, cls_logit = f[..., 4:5], f[..., 5:]
    gt = gt.to(F32)
    mask = gt[..., 4:5]
    with torch.no_grad():
        present = (mask[..., 0] > 0).any(dim=(0, 1, 2))
        pmin = (pred_xy - pred_wh / 2.0)[..., None, :]
        pmax = (pred_xy + pred_wh / 2.0)[..., None, :]
        iwh = torch.clamp_min(torch.minimum(pmax, anc / 2.0)
                              - torch.maximum(pmin, -anc / 2.0), 0.0)
        inter = iwh[..., 0] * iwh[..., 1]
        iou = inter / ((pred_wh[..., 0] * pred_wh[..., 1])[..., None]
                       + anc[:, 0] * anc[:, 1] - inter)
        best = torch.where(present, iou, float("-inf")).amax(-1)
        ignore = (best < 0.5).to(F32)[..., None]
        valid = mask + (1.0 - mask) * ignore
    n = float(b)
    obj = (valid * _sigmoid_ce(mask, obj_logit)).sum() / n
    cls = (mask * _sigmoid_ce(gt[..., 5:], cls_logit)).sum() / n

    def inv_sigmoid(p):
        return -torch.log(1.0 / p - 1.0)

    t_xy = torch.clamp(gt[..., 0:2] / float(stride) - off, 0.01, 0.99)
    p_xy = torch.clamp(pred_xy / float(stride) - off, 0.01, 0.99)
    xy = ((inv_sigmoid(t_xy) - inv_sigmoid(p_xy)).square() * mask).sum() / n
    t_wh = gt[..., 2:4] / anc
    p_wh = pred_wh / anc
    t_wh = torch.where(t_wh == 0.0, torch.ones_like(t_wh), t_wh)
    p_wh = torch.where(p_wh == 0.0, torch.ones_like(p_wh), p_wh)
    wh = ((torch.log(torch.clamp(t_wh, 1e-9, 1e9))
           - torch.log(torch.clamp(p_wh, 1e-9, 1e9))).square() * mask
          ).sum() / n
    return xy + wh + obj + cls


def loss(params: dict, model: dict, images, labels) -> torch.Tensor:
    fms = forward(Train(params, model), model, images)
    return sum(loss_layer(fm, gt, model["anchors"], model["number_classes"],
                          s) for fm, gt, s in zip(fms, labels, (32, 16, 8)))


def leaves(weights: dict) -> Dict[Tuple[str, str], torch.Tensor]:
    """The trained leaves {(block, leaf): float32 tensor with grad}."""
    out = {}
    for name, p in weights.items():
        for leaf in ("kernel", "bias", "scale", "offset"):
            if leaf in p:
                out[(name, leaf)] = p[leaf].detach().clone().to(
                    F32).requires_grad_(True)
    return out


def train_steps(weights: dict, model: dict, batches: Sequence[tuple],
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-7):
    """Adam steps from `weights` on `batches` [(images, labels...)]: the
    losses, the first step's gradient norms and the final parameters
    {(block, leaf): tensor}."""
    leaf = leaves(weights)
    params: Dict[str, dict] = {}
    for (name, key), t in leaf.items():
        params.setdefault(name, {})[key] = t
    m = {k: torch.zeros_like(v) for k, v in leaf.items()}
    v = {k: torch.zeros_like(t) for k, t in leaf.items()}
    losses, grad_norms = [], None
    with no_tf32():
        for t, (images, *labels) in enumerate(batches, start=1):
            for p in leaf.values():
                p.grad = None
            val = loss(params, model, images, labels) / float(images.shape[0])
            val.backward()
            losses.append(float(val.detach()))
            if grad_norms is None:
                grad_norms = {k: float(p.grad.norm()) for k, p in leaf.items()}
            with torch.no_grad():
                for k, p in leaf.items():
                    g = p.grad
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[k] / (1 - b1 ** t)
                    vh = v[k] / (1 - b2 ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
    return losses, grad_norms, {k: p.detach() for k, p in leaf.items()}
