"""The port's loss (`yolov3_tpu_torch/ops/loss.py`) against the JAX
package's `compute_loss` (5D form) on the same seeded feature maps and
label grids, f32, on the CPU.

Tolerances: the four components and the total within rtol 1e-5 (each is
an f32 sum over a few thousand terms, and the two sides sum in different
orders); gradients with respect to the feature maps are elementwise, so
within 1e-5 of each scale's largest |g| (a few f32 roundings per term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.data.encoder import encode_boxes as j_encode_boxes
from yolov3_tpu.ops import loss as jloss
from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.ops import loss as tloss
from yolov3_tpu_torch.parallel.train_step import create_train_state
from yolov3_tpu_torch.utils.checkpoint import init_train_params

IMG = (64, 64, 3)
NCLS = 2
ANCHORS = ((16, 16), (32, 32))
STRIDES = (32, 16, 8)


def make_inputs(seed, kind, batch=3, img=IMG):
    """Feature maps [B, gh, gw, A*(5+C)] and label grids [B, gh, gw, A,
    5+C] for images of `img` (H, W, C): `empty` has no boxes (V = 0),
    `anchors` boxes that select every anchor, `random` random boxes (with
    exact-zero logits and underflowing wh logits planted in the feature
    maps)."""
    rng = np.random.RandomState(seed)
    h, w = img[0], img[1]
    fms = [rng.randn(batch, h // s, w // s, len(ANCHORS) * (5 + NCLS))
           .astype(np.float32) * 1.5 for s in STRIDES]
    grids = [[], [], []]
    for b in range(batch):
        if kind == "empty":
            boxes = np.zeros((0, 5), np.int32)
        elif kind == "anchors":
            boxes = np.array([[rng.randint(0, w - 24), rng.randint(0, h - 24),
                               aw + rng.randint(-2, 3),
                               ah + rng.randint(-2, 3), i % NCLS]
                              for i, (aw, ah) in enumerate(ANCHORS)],
                             np.int32)
        else:
            n = rng.randint(1, 5)
            boxes = np.stack([rng.randint(0, w - 16, n),
                              rng.randint(0, h - 16, n),
                              rng.randint(6, 40, n), rng.randint(6, 40, n),
                              rng.randint(0, NCLS, n)], 1).astype(np.int32)
        for g, grid in zip(grids, j_encode_boxes(boxes, img, ANCHORS, NCLS)):
            g.append(grid)
    grids = [np.stack(g) for g in grids]
    if kind == "random":
        fms[0][0, 0, 0, [4, 5, 11]] = 0.0    # max(x, 0) and |x| at 0
        fms[1][1, 1, 1, [2, 3]] = -200.0     # exp underflows: the guard
    return fms, grids


CASES = [(seed, kind) for seed in range(3)
         for kind in ("random", "empty", "anchors")]


@jax.jit
def jax_loss(fms, grids):
    return jloss.compute_loss(fms, grids, ANCHORS, NCLS, STRIDES)


@jax.jit
def jax_loss_grad(fms, grids):
    return jax.grad(lambda f: jax_loss(f, grids).total)(fms)


@pytest.mark.parametrize("seed,kind", CASES)
def test_compute_loss_matches_jax(seed, kind):
    fms, grids = make_inputs(seed, kind)
    want = jax_loss(fms, grids)
    got = tloss.compute_loss([torch.from_numpy(f) for f in fms],
                             [torch.from_numpy(g) for g in grids], ANCHORS,
                             NCLS, STRIDES)
    for name, g, w in zip(want._fields, got, want):
        assert np.isfinite(float(g)), name
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    if kind == "empty":
        assert float(got.xy) == float(got.wh) == float(got.class_) == 0.0


@pytest.mark.parametrize("seed,kind", CASES)
def test_loss_gradients_match_jax(seed, kind):
    fms, grids = make_inputs(seed, kind)
    want = jax_loss_grad(fms, grids)
    ts = [torch.from_numpy(f).requires_grad_() for f in fms]
    tloss.compute_loss(ts, [torch.from_numpy(g) for g in grids], ANCHORS,
                       NCLS, STRIDES).total.backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("img", [(64, 96, 3), (96, 64, 3)])
@pytest.mark.parametrize("kind", ["random", "anchors"])
def test_nonsquare_loss_and_gradients_match_jax(img, kind):
    """H != W (tests/test_nonsquare.py): the components and the gradients
    at the bounds above."""
    fms, grids = make_inputs(0, kind, img=img)
    want = jax_loss(fms, grids)
    want_g = jax_loss_grad(fms, grids)
    ts = [torch.from_numpy(f).requires_grad_() for f in fms]
    got = tloss.compute_loss(ts, [torch.from_numpy(g) for g in grids],
                             ANCHORS, NCLS, STRIDES)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    got.total.backward()
    for t, w in zip(ts, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_wh_overflow_gives_finite_gradients():
    """wh logits past the f32 exp's overflow (89, 100), in a cell with an
    object and in one without: the port's loss equals JAX's, and where
    JAX's gradients are finite the port's are the same; JAX's backward
    meets 0 * inf and gives NaN, the port's (`WH_LOGIT_MAX`) 0 there."""
    fms, grids = make_inputs(0, "random")
    obj = np.argwhere(grids[0][..., 4] > 0)[0]
    cell = tuple(obj[:3])
    a = int(obj[3])
    fms[0][cell + (a * 7 + 2,)] = 89.0       # the object's w
    fms[0][0, 1, 1, 3] = 100.0               # a cell without an object
    want = jax_loss(fms, grids)
    want_g = jax_loss_grad(fms, grids)
    ts = [torch.from_numpy(f).requires_grad_() for f in fms]
    got = tloss.compute_loss(ts, [torch.from_numpy(g) for g in grids],
                             ANCHORS, NCLS, STRIDES)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                   err_msg=name)
    got.total.backward()
    assert not np.isfinite(np.asarray(want_g[0])).all()
    for t, w in zip(ts, want_g):
        g, w = t.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                                   atol=1e-5 * np.abs(w[ok]).max())
        assert (g[~ok] == 0).all()


@pytest.mark.parametrize("fn", ["clip", "sigmoid_ce"])
def test_tie_gradients_match_jax(fn):
    """At the ties (x on a clip bound, a logit of exactly 0) JAX splits
    the gradient of max/min evenly and gives |x| gradient +1; the port's
    rules give the same."""
    x = np.array([0.01, 0.99, 0.0, 0.5, 1e-9, -3.0], np.float32)
    z = np.array([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    if fn == "clip":
        want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.01, 0.99) * 3.0))(
            jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        (tloss._clip(t, 0.01, 0.99) * 3.0).sum().backward()
    else:
        want = jax.grad(lambda v: jnp.sum(jloss._sigmoid_ce(z, v)))(
            jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        tloss._sigmoid_ce(torch.from_numpy(z), t).sum().backward()
    # off the ties, exp and log1p may round differently by an ulp
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_l2_regularization_matches_jax():
    """wd * sum(w^2) over the conv kernels, on the same weights: one f32
    sum over ~90k squares each side, rtol 1e-5."""
    cfg = ModelConfig(img_size=IMG, number_classes=NCLS, anchors=ANCHORS,
                      block_count=1, filter_count=32, compute_dtype="float32")
    params, stats = init_train_params(cfg, 0)
    want = jloss.l2_regularization(params, 5e-4)
    state = create_train_state(cfg, TrainConfig(), device="cpu",
                               params=params, batch_stats=stats)
    got = tloss.l2_regularization(state.model, 5e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
