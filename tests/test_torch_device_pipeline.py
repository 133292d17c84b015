"""The port's device pipeline (`yolov3_tpu_torch/data/device_pipeline.py`)
against the JAX module's, on the CPU, at 64 px.

The two packages' generators differ, so every comparison runs both on the
same draws: `jax_draws` makes them with JAX's own `jax.random` calls under
`_augment_one`'s key splits, and the port takes them as `AugmentDraws`.

Tolerances:
- boxes, `valid` and the label grids: identical. The box affine's
  `a * b - c` is one fused multiply-add in XLA's CPU code; the port rounds
  it once too (`_mul_sub`), and `test_affine_boxes_contraction_edges`
  holds it on inputs where a separately rounded product would move an
  edge by a pixel.
- pixels: XLA contracts the warp's lerp and the blur's tap sums into FMAs
  and has its own `exp`, so the port's pixels differ in the last bits.
  The warp and the noise step are held within 4 float32 ulps of 255
  (6.1e-5; measured 2), the blur within 8 (1.2e-4; measured 5: its
  weights differ by an ulp through `exp`, and 13 taps a side sum on
  each of three axes); the whole augmentation within 8 ulps of a pixel
  in [256, 512), which the noise reaches (2.4e-4; measured up to
  1.2e-4); the z-scored images within that bound divided by each
  image's std, plus 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import AugmentConfig as JAugmentConfig
from yolov3_tpu.data import device_pipeline as J
from yolov3_tpu_torch.config import AugmentConfig
from yolov3_tpu_torch.data import device_pipeline as T

SIZE = (64, 64, 3)
ANCHORS = ((16.0, 16.0), (32.0, 32.0))
M = 64
ULP255 = float(np.spacing(np.float32(255.0)))
STAGE_ATOL = 4 * ULP255
BLUR_ATOL = 8 * ULP255
RAW_ATOL = 8 * float(np.spacing(np.float32(256.0)))


def jax_draws(key, b, shape, m, cfg):
    """The final values `_augment_one` draws for each of `b` images from
    `key`, made with the same jax.random calls under the same splits."""
    h, w = shape[0], shape[1]
    cols = {n: [] for n in ("rx", "ry", "sx", "sy", "dx", "dy", "jitter",
                            "nf", "noise", "blur")}
    for kb in jax.random.split(key, b):
        keys = jax.random.split(kb, 8)
        rx = ry = False
        if cfg.reflection_flag:
            rx = jax.random.uniform(keys[0]) > 0.5
            ry = jax.random.uniform(keys[1]) > 0.5
        sx = sy = 1.0
        dy = dx = 0.0
        if cfg.scale_augmentation_severity > 0:
            lo = max(1.0, 1.0 - cfg.scale_augmentation_severity)
            hi = 1.0 + cfg.scale_augmentation_severity
            sx = jax.random.uniform(keys[2], minval=lo, maxval=hi)
            sy = jax.random.uniform(keys[3], minval=lo, maxval=hi)
            dy = jnp.floor(jax.random.uniform(keys[4])
                           * (jnp.floor(h * sy) - h))
            dx = jnp.floor(jax.random.uniform(keys[5])
                           * (jnp.floor(w * sx) - w))
        k1, k2, k3, k4 = jax.random.split(keys[6], 4)
        noise_key, blur_key, sigma_key = jax.random.split(keys[7], 3)
        cols["jitter"].append([np.asarray(jax.random.normal(k, (m,)))
                               for k in (k1, k2, k3, k4)])
        cols["nf"].append(jax.random.uniform(sigma_key, minval=-1.0,
                                             maxval=1.0))
        cols["noise"].append(jax.random.normal(noise_key, shape))
        mb = cfg.blur_augmentation_max_sigma
        cols["blur"].append(jax.random.uniform(blur_key, minval=-mb,
                                               maxval=mb))
        for n, v in (("rx", rx), ("ry", ry), ("sx", sx), ("sy", sy),
                     ("dx", dx), ("dy", dy)):
            cols[n].append(v)

    def t(name, dtype=torch.float32):
        return torch.from_numpy(np.stack([np.asarray(v, np.float32)
                                          for v in cols[name]])).to(dtype)

    return T.AugmentDraws(
        t("rx", torch.bool), t("ry", torch.bool), t("sx"), t("sy"), t("dx"),
        t("dy"), t("jitter").permute(1, 0, 2).contiguous(),
        t("nf") if cfg.noise_augmentation_severity > 0 else None,
        t("noise") if cfg.noise_augmentation_severity > 0 else None,
        t("blur") if cfg.blur_augmentation_max_sigma > 0 else None)


def random_boxes(rng, b, n_max, size=64, m=M):
    boxes = np.zeros((b, m, 5), np.float32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        for j in range(rng.integers(0, n_max + 1)):
            w, h = rng.integers(4, size - 4, 2)
            x, y = rng.integers(0, size - w + 1), rng.integers(0, size - h + 1)
            boxes[i, j] = [x, y, w, h, rng.integers(0, 2)]
            valid[i, j] = True
    return boxes, valid


def jax_augment(images, boxes, valid, key, cfg):
    keys = jax.random.split(key, images.shape[0])
    out = jax.jit(jax.vmap(lambda i, bx, v, k: J._augment_one(
        i, bx, v, k, cfg)))(jnp.asarray(images), jnp.asarray(boxes),
                            jnp.asarray(valid), keys)
    return [np.asarray(o) for o in out]


def test_warp_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (4, *SIZE)).astype(np.float32)
    sy = np.float32([1.0, 1.07, 1.0312, 1.0999])
    sx = np.float32([1.0, 1.0, 1.0841, 1.052])
    dy = np.float32([0, 3, 1, 5])
    dx = np.float32([0, 0, 4, 2])
    rx = np.array([False, True, False, True])
    ry = np.array([False, False, True, True])
    want = jax.jit(jax.vmap(J._warp_image))(*map(jnp.asarray, (
        img, sy, sx, dy, dx, rx, ry)))
    got = T._warp_image(*map(torch.from_numpy, (img, sy, sx, dy, dx, rx,
                                                ry)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STAGE_ATOL)
    # no scale, no offset, no flip: the identity, exactly
    np.testing.assert_array_equal(got[0].numpy(), img[0])


@pytest.mark.parametrize("channels", [1, 3])
def test_blur_matches_jax(channels):
    """One batch, a sigma per image: < 0, 0, small and large; over H, W
    and C (with C = 3 the channel axis takes 2 taps a side, renormalised;
    with C = 1 none)."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (4, 64, 48, channels)).astype(np.float32)
    sigma = np.float32([-0.7, 0.0, 0.4, 1.9])
    want = jax.jit(jax.vmap(lambda i, s: J._gaussian_blur(i, s, 2.0)))(
        jnp.asarray(img), jnp.asarray(sigma))
    got = T._gaussian_blur(torch.from_numpy(img), torch.from_numpy(sigma),
                           2.0).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=BLUR_ATOL)
    np.testing.assert_array_equal(got[:2], img[:2])  # sigma <= 0: identity
    assert np.abs(got[3] - img[3]).max() > 1.0


def test_noise_step_matches_jax():
    """The noise alone: sigma = factor * severity * the warped image's
    dynamic range, times a normal field."""
    cfg = AugmentConfig(reflection_flag=False, scale_augmentation_severity=0,
                        blur_augmentation_max_sigma=0,
                        box_size_augmentation_severity=0,
                        box_location_jitter_severity=0)
    jcfg = JAugmentConfig(**vars(cfg))
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (4, *SIZE)).astype(np.float32)
    boxes, valid = random_boxes(rng, 4, 3)
    key = jax.random.PRNGKey(3)
    want = jax_augment(img, boxes, valid, key, jcfg)
    draws = jax_draws(key, 4, SIZE, M, cfg)
    assert draws.blur_sigma is None
    got = T.augment_batch(torch.from_numpy(img), torch.from_numpy(boxes),
                          torch.from_numpy(valid), draws, cfg)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=STAGE_ATOL)
    assert np.abs(got[0].numpy() - img).max() > 1.0
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_jitter_boxes_matches_jax():
    """Large severities, so that the truncations move the boxes; the
    normals are JAX's own under `_jitter_boxes`' key split."""
    rng = np.random.default_rng(4)
    boxes, valid = random_boxes(rng, 6, 20)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    f = jax.jit(jax.vmap(lambda bx, v, k: J._jitter_boxes(
        bx, v, 0.3, 0.5, (64, 48), k)))
    want = np.asarray(f(jnp.asarray(boxes), jnp.asarray(valid), keys))
    normals = np.stack([[np.asarray(jax.random.normal(k, (M,)))
                         for k in jax.random.split(kb, 4)] for kb in keys],
                       axis=1)
    got = T._jitter_boxes(torch.from_numpy(boxes), 0.3, 0.5, (64, 48),
                          torch.from_numpy(normals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want[..., :4], boxes[..., :4])


def test_affine_boxes_matches_jax():
    rng = np.random.default_rng(5)
    boxes, valid = random_boxes(rng, 8, 30, size=512)
    boxes[:, :, :2] -= 40  # some boxes off the image, some thin
    sx = rng.uniform(1.0, 1.1, 8).astype(np.float32)
    sy = rng.uniform(1.0, 1.1, 8).astype(np.float32)
    dx = np.floor(rng.uniform(0, 1, 8) * (np.floor(512 * sx) - 512))
    dy = np.floor(rng.uniform(0, 1, 8) * (np.floor(512 * sy) - 512))
    rx = rng.uniform(size=8) > 0.5
    ry = rng.uniform(size=8) > 0.5
    args = (sx, sy, dx.astype(np.float32), dy.astype(np.float32), rx, ry)
    wb, wv = jax.jit(jax.vmap(
        lambda bx, v, *a: J._affine_boxes(bx, v, (512, 512), *a)))(
        *map(jnp.asarray, (boxes, valid, *args)))
    gb, gv = T._affine_boxes(torch.from_numpy(boxes), torch.from_numpy(valid),
                             (512, 512), *map(torch.from_numpy, args))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < gv.sum() < valid.sum()  # the culls took some boxes


def test_affine_boxes_contraction_edges():
    """x * s - d where the float32 product rounds up to an integer n but
    the exact product lies just below it, and d = n - 1: XLA's fused
    multiply-add leaves 1 - delta, which truncates to 0; a separately
    rounded product gives exactly 1."""
    edges = []
    for a in range(13, 400):
        for n in range(a + 1, int(a * 1.1)):
            s = np.float32(n / a)
            if (float(a) * float(s) < n
                    and np.float32(np.float32(a) * s) == n):
                edges.append((a, s, n))
    edges = edges[::max(1, len(edges) // 64)][:64]
    a = np.float32([e[0] for e in edges])
    s = np.float32([e[1] for e in edges])
    d = np.float32([e[2] - 1 for e in edges])
    boxes = np.zeros((len(edges), 1, 5), np.float32)
    boxes[:, 0] = np.stack([a, a, np.full_like(a, 30), np.full_like(a, 30),
                            np.zeros_like(a)], -1)
    valid = np.ones((len(edges), 1), bool)
    flags = np.zeros(len(edges), bool)
    args = (s, s, d, d, flags, flags)
    wb, wv = jax.jit(jax.vmap(
        lambda bx, v, *x: J._affine_boxes(bx, v, (1024, 1024), *x)))(
        *map(jnp.asarray, (boxes, valid, *args)))
    gb, gv = T._affine_boxes(torch.from_numpy(boxes), torch.from_numpy(valid),
                             (1024, 1024), *map(torch.from_numpy, args))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert (np.asarray(wb)[:, 0, :2] == 0).all()
    assert (np.trunc(np.float32(a * s) - d) == 1).all()


def encode_case(name):
    """(boxes [M,5], valid [M]) of one encoder case at 64 px."""
    boxes = np.zeros((M, 5), np.float32)
    valid = np.zeros(M, bool)
    if name == "empty":
        return boxes, valid
    if name == "overlap":  # one slot: coordinates of the last, both classes
        boxes[:3] = [[10, 10, 14, 14, 0], [11, 9, 15, 16, 1],
                     [40, 40, 30, 30, 1]]
        valid[:3] = True
        valid[2] = False  # an invalid box never writes
        return boxes, valid
    if name == "out_of_grid":  # centres clamp to the border cells
        boxes[:4] = [[-30, -20, 10, 12, 1], [70, 5, 20, 20, 0],
                     [5, 90, 40, 8, 1], [200, 200, 33, 31, 0]]
        valid[:4] = True
        return boxes, valid
    if name == "bad_class":  # no class bit, but coordinates and object
        boxes[:2] = [[8, 8, 16, 16, 5], [40, 8, 16, 16, -1]]
        valid[:2] = True
        return boxes, valid
    rng = np.random.default_rng(7)
    w, h = rng.integers(2, 60, (2, M))
    x, y = rng.integers(-8, 60, (2, M))
    boxes[:] = np.stack([x, y, w, h, rng.integers(0, 2, M)], -1)
    valid[:] = True  # "overflow": 64 boxes on 64 s8 cells, many shared
    if name == "random":
        valid[:] = rng.uniform(size=M) > 0.4
    return boxes, valid


@pytest.mark.parametrize("case", ["empty", "overlap", "out_of_grid",
                                  "bad_class", "overflow", "random"])
def test_encode_labels_matches_jax(case):
    cases = [encode_case(case), encode_case("random")]
    boxes = np.stack([c[0] for c in cases])
    valid = np.stack([c[1] for c in cases])
    want = jax.jit(jax.vmap(lambda b, v: J.encode_labels_device(
        b, v, SIZE, ANCHORS, 2)))(jnp.asarray(boxes), jnp.asarray(valid))
    got = T.encode_labels_device(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), SIZE, ANCHORS, 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "overlap":
        cell = got[2][0].reshape(-1, 7)
        hit = cell[cell[:, 4] == 1]
        assert hit.shape[0] == 1 and hit[0, 5] == hit[0, 6] == 1
        assert hit[0, 2:4].tolist() == [15, 16]


@pytest.mark.parametrize("augment", [True, False])
def test_preprocess_batch_matches_jax(augment):
    check_preprocess_batch(SIZE, augment)


@pytest.mark.parametrize("size", [(64, 96, 3), (96, 64, 3)])
@pytest.mark.parametrize("augment", [True, False])
def test_preprocess_batch_nonsquare_matches_jax(size, augment):
    """H != W (tests/test_nonsquare.py), at the bounds above."""
    check_preprocess_batch(size, augment)


def check_preprocess_batch(size, augment):
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (4, *size), dtype=np.uint8)
    boxes, valid = random_boxes(rng, 4, 12, size=min(size[:2]))
    key = jax.random.PRNGKey(8)
    want = J.preprocess_batch(jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(valid), key, JAugmentConfig(),
                              size, ANCHORS, 2, use_augmentation=augment)
    draws = jax_draws(key, 4, size, M, AugmentConfig()) if augment else None
    got = T.preprocess_batch(torch.from_numpy(images),
                             torch.from_numpy(boxes),
                             torch.from_numpy(valid), None, AugmentConfig(),
                             size, ANCHORS, 2, use_augmentation=augment,
                             draws=draws)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_img = np.asarray(want[0])
    if augment:
        raw = jax_augment(images.astype(np.float32), boxes, valid, key,
                          JAugmentConfig())[0]
        atol = RAW_ATOL / raw.std(axis=(1, 2, 3)) + 1e-6
    else:
        atol = np.full(4, 1e-6)
    for i in range(4):
        np.testing.assert_allclose(got[0][i].numpy(), want_img[i], rtol=0,
                                   atol=atol[i])


def test_augment_batch_raw_pixels_match_jax():
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (4, *SIZE)).astype(np.float32)
    boxes, valid = random_boxes(rng, 4, 12)
    key = jax.random.PRNGKey(9)
    want = jax_augment(images, boxes, valid, key, JAugmentConfig())
    got = T.augment_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                          torch.from_numpy(valid),
                          jax_draws(key, 4, SIZE, M, AugmentConfig()),
                          AugmentConfig())
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=RAW_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_draw_augment_ranges():
    cfg = AugmentConfig()
    gen = torch.Generator().manual_seed(0)
    d = T.draw_augment(gen, 256, (64, 48, 3), 7, cfg)
    assert d.reflect_x.dtype == torch.bool and 40 < d.reflect_x.sum() < 216
    for s, size in ((d.scale_x, 48), (d.scale_y, 64)):
        assert s.min() >= 1.0 and s.max() <= 1.1 and s.std() > 0.02
    for off, s, size in ((d.dx, d.scale_x, 48), (d.dy, d.scale_y, 64)):
        assert torch.equal(off, torch.floor(off)) and off.min() >= 0
        assert (off <= torch.floor(size * s) - size).all() and off.max() > 0
    assert d.jitter.shape == (4, 256, 7)
    assert d.noise.shape == (256, 64, 48, 3)
    assert -1.0 <= d.noise_factor.min() and d.noise_factor.max() < 1.0
    assert -2.0 <= d.blur_sigma.min() and d.blur_sigma.max() <= 2.0
    assert (d.blur_sigma < 0).any() and (d.blur_sigma > 0).any()
    # the same seed gives the same draws; preprocess_batch draws them so
    again = T.draw_augment(torch.Generator().manual_seed(0), 256,
                           (64, 48, 3), 7, cfg)
    assert torch.equal(again.noise, d.noise)
    rng = np.random.default_rng(10)
    images = torch.from_numpy(rng.integers(0, 256, (2, *SIZE),
                                           dtype=np.uint8))
    boxes, valid = map(torch.from_numpy, random_boxes(rng, 2, 5))
    drawn = T.preprocess_batch(images, boxes, valid,
                               torch.Generator().manual_seed(1), cfg, SIZE,
                               ANCHORS, 2)
    given = T.preprocess_batch(
        images, boxes, valid, None, cfg, SIZE, ANCHORS, 2,
        draws=T.draw_augment(torch.Generator().manual_seed(1), 2, SIZE, M,
                             cfg))
    for a, b in zip(drawn, given):
        assert torch.equal(a, b)


def test_draw_augment_steps_off():
    cfg = AugmentConfig(reflection_flag=False, noise_augmentation_severity=0,
                        scale_augmentation_severity=0,
                        blur_augmentation_max_sigma=0)
    d = T.draw_augment(torch.Generator().manual_seed(0), 3, SIZE, M, cfg)
    assert d.noise is None and d.noise_factor is None
    assert d.blur_sigma is None and not d.reflect_x.any()
    assert (d.scale_x == 1).all() and (d.dy == 0).all()
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, *SIZE)).astype(np.float32))
    boxes = torch.zeros((3, M, 5))
    out, _, _ = T.augment_batch(img, boxes, torch.zeros((3, M), dtype=bool),
                                d, cfg)
    assert torch.equal(out, img)
