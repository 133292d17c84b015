"""PyTorch port YOLOv3 model vs the JAX package's Flax model.

Weights come from the port's `init_params` (a numpy seed) in the Flax
tree layout, so both packages run the same numbers; the port receives
them through `params_from_jax`. f32 compute, 64 px, block_count 1,
filter_count 32: tolerance rtol 1e-3 / atol 1e-4, the f32 class of
tests/test_s2d_stem.py. With `use_pallas_pointwise` the JAX side runs its
Pallas kernel in interpret mode and the port its plain version, both with
bf16 matmul operands: rtol = atol = 2e-2, the kernel tests' bound.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models import yolo as jyolo
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models import yolo as tyolo
from yolov3_tpu_torch.utils.checkpoint import init_params, params_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             compute_dtype="float32")


def port_model(cfg, params, stats):
    model = tyolo.YoloV3(cfg)
    model.load_state_dict(params_from_jax(params, stats, cfg))
    return model.eval()


def run_both(kw, x, seed=0):
    cfg = ModelConfig(**kw)
    params, stats = init_params(cfg, seed)
    want = jyolo.YoloV3(JConfig(**kw)).apply(
        {"params": params, "batch_stats": stats}, x, train=False)
    with torch.no_grad():
        got = port_model(cfg, params, stats)(torch.from_numpy(x))
    return [g.float().numpy() for g in got], [np.asarray(w, np.float32)
                                              for w in want]


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("channel_sum", [True, False])
def test_feature_maps_match_jax(s2d, channel_sum):
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    got, want = run_both(dict(SMALL, stem_space_to_depth=s2d,
                              upsample_channel_sum=channel_sum), x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("s2d", [True, False])
def test_pointwise_flag_matches_jax_interpret(s2d):
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    got, want = run_both(dict(SMALL, stem_space_to_depth=s2d,
                              use_pallas_pointwise=True), x, seed=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)


def test_non_square_image():
    kw = dict(SMALL, img_size=(64, 96, 3))
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32)
    got, want = run_both(kw, x, seed=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4)


def test_detector_matches_jax():
    cfg = ModelConfig(**SMALL)
    params, stats = init_params(cfg, 3)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jyolo.YoloV3Detector(JConfig(**SMALL)).apply(
        {"params": {"backbone": params},
         "batch_stats": {"backbone": stats}}, x, train=False))
    det = tyolo.YoloV3Detector(cfg)
    det.backbone.load_state_dict(params_from_jax(params, stats, cfg))
    with torch.no_grad():
        got = det.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, cfg.number_output_boxes, 7)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


class TestGoldenFixtures:
    """The committed TF-reference fixtures, read through the JAX package's
    keras importer and then the port's bridge (tests/test_tf_import.py)."""

    def _run(self, weights, bc, fc, ncls, x):
        from yolov3_tpu.utils import tf_import as T
        params, stats = T.import_keras_weights(weights, block_count=bc)
        cfg = ModelConfig(img_size=(64, 64, 3), number_classes=ncls,
                          anchors=((16, 16), (32, 32)), block_count=bc,
                          filter_count=fc, compute_dtype="float32",
                          upsample_channel_sum=True)
        with torch.no_grad():
            return port_model(cfg, params, stats)(torch.from_numpy(x))

    def test_bc1(self):
        z = np.load(os.path.join(FIXTURES, "tf_golden_bc1.npz"))
        weights = {k: z[k] for k in z.files if not k.startswith("__")}
        fms = self._run(weights, 1, 64, 2, z["__input__"])
        for fm, key in zip(fms, ("__fm1__", "__fm2__", "__fm3__")):
            np.testing.assert_allclose(fm.numpy(), z[key], rtol=2e-3,
                                       atol=2e-3)

    def test_full(self):
        from yolov3_tpu.utils import tf_golden as G
        z = np.load(os.path.join(FIXTURES, "tf_golden_full.npz"))
        seed, ncls, bc, fc = (int(v) for v in z["__meta__"])
        weights = G.make_weights(seed, ncls, ((16, 16), (32, 32)),
                                 block_count=bc, filter_count=fc)
        fms = self._run(weights, bc, fc, ncls, z["__input__"])
        for fm, key in zip(fms, ("__fm1__", "__fm2__", "__fm3__")):
            np.testing.assert_allclose(fm.numpy(), z[key], rtol=1e-2,
                                       atol=1e-2)


def _flax_block_vars(rng, ci, co, k):
    return {"params": {
        "Conv_0": {"kernel": (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)
                              ).astype(np.float32),
                   "bias": (0.1 * rng.randn(co)).astype(np.float32)},
        "BatchNorm_0": {"scale": rng.uniform(0.8, 1.2, co).astype(np.float32),
                        "bias": (0.1 * rng.randn(co)).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": (0.1 * rng.randn(co)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, co).astype(np.float32)}}}


def _load_block(block, v):
    p, s = v["params"], v["batch_stats"]
    block.conv.weight.data = torch.from_numpy(
        p["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy())
    block.conv.bias.data = torch.from_numpy(p["Conv_0"]["bias"])
    block.bn.weight.data = torch.from_numpy(p["BatchNorm_0"]["scale"])
    block.bn.bias.data = torch.from_numpy(p["BatchNorm_0"]["bias"])
    block.bn.running_mean.data = torch.from_numpy(s["BatchNorm_0"]["mean"])
    block.bn.running_var.data = torch.from_numpy(s["BatchNorm_0"]["var"])
    block.prepare()


@pytest.mark.parametrize("k,stride,size", [(3, 1, 8), (3, 2, 8), (3, 2, 7),
                                           (1, 1, 6)])
def test_conv_block_matches_flax(k, stride, size):
    """Conv -> LeakyReLU(0.2) -> BN(eps 1e-3) order, and SAME padding: a
    stride-2 3x3 pads only the bottom/right on an even input."""
    rng = np.random.RandomState(k * 10 + stride + size)
    x = rng.randn(2, size, size + 1, 6).astype(np.float32)
    v = _flax_block_vars(rng, 6, 10, k)
    want = jyolo.ConvBlock(10, k, stride=stride, dtype=jnp.float32).apply(
        v, x, train=False)
    block = tyolo.ConvBlock(6, 10, k, stride=stride, dtype=torch.float32)
    _load_block(block, v)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_prepared_constants_follow_load_state_dict():
    """The forward's derived constants are rebuilt by `load_state_dict`
    and stay out of the state_dict."""
    cfg = ModelConfig(**dict(SMALL, compute_dtype="bfloat16",
                             use_pallas_pointwise=True))
    params, stats = init_params(cfg, 4)
    state = params_from_jax(params, stats, cfg)
    model = port_model(cfg, params, stats)
    assert set(model.state_dict()) == set(state)
    fused, plain = model.necks[0], model.darknet.convs[1]
    assert fused.fused and not plain.fused
    # the kernel's K-major [Co, Ci] layout
    w = state["necks.0.conv.weight"][:, :, 0, 0]
    assert fused.w.dtype == torch.bfloat16 and fused.w.is_contiguous()
    assert torch.equal(fused.w, w.to(torch.bfloat16))
    var, gamma = (state["necks.0.bn.running_var"],
                  state["necks.0.bn.weight"])
    torch.testing.assert_close(fused.mul, gamma / torch.sqrt(var + 1e-3),
                               rtol=0, atol=0)
    assert torch.equal(plain.w, state["darknet.convs.1.conv.weight"].to(
        torch.bfloat16))
    assert torch.equal(model.heads[0].b,
                       state["heads.0.conv.bias"].to(torch.bfloat16))


def test_stride2_pads_bottom_right_only():
    x = torch.zeros(1, 4, 4, 1)
    x[0, 0, 0, 0] = 1.0   # top-left pixel
    w = torch.zeros(1, 1, 3, 3)
    w[0, 0, 0, 0] = 1.0   # top-left tap
    y = tyolo.conv2d_same(x, w, torch.zeros(1), 2)
    # no top/left pad: output (0, 0) reads input (0, 0) through tap (0, 0)
    assert y.shape == (1, 2, 2, 1) and y[0, 0, 0, 0] == 1.0


def test_feature_block_adds_original_input():
    rng = np.random.RandomState(7)
    x = rng.randn(1, 8, 8, 8).astype(np.float32)
    vs = [_flax_block_vars(rng, ci, co, k)
          for ci, co, k in ((8, 4, 1), (4, 8, 3), (8, 4, 1), (4, 8, 3))]
    variables = {c: {f"ConvBlock_{i}": v[c] for i, v in enumerate(vs)}
                 for c in ("params", "batch_stats")}
    ck = dict(alpha=0.2, bn_momentum=0.99, bn_epsilon=1e-3,
              dtype=jnp.float32)
    want = jyolo.FeatureBlock(2, 3, 8, ck).apply(variables, x, train=False)
    block = tyolo.FeatureBlock(2, 3, 8, dict(dtype=torch.float32))
    for conv, v in zip(block.convs, vs):
        _load_block(conv, v)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channel_sum", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_2x_matches_jax(channel_sum, dtype):
    x = np.random.RandomState(8).randn(2, 3, 5, 64).astype(np.float32)
    want = jyolo.upsample_2x(jnp.asarray(x, dtype), channel_sum)
    got = tyolo.upsample_2x(torch.from_numpy(x).to(getattr(torch, dtype)),
                            channel_sum)
    # the f32 channel sum runs in another order than XLA's: a few ulps
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6)
