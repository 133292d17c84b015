"""The port's int8 serving model (`models/quantized.py`) against the JAX
package's `models/quantized.py`.

Weights come from the port's `init_params` (a numpy seed) in the Flax
tree layout, so both packages run the same numbers. 64 px, block_count
1-2, filter_count 32-64, as tests/test_quantized.py and
tests/test_conv3_kernel.py. In int8 mode both sides get the scales of
JAX's `calibrate`. The JAX kernels run in interpret mode, the port's
kernels as their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models import quantized as Q
from yolov3_tpu.ops.decode import decode_detections as jax_decode
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models import quantized as TQ
from yolov3_tpu_torch.models.yolo import YoloV3
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.kernels.pointwise_q import pointwise_conv_block_q
from yolov3_tpu_torch.utils.checkpoint import init_params

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 48), (48, 16)), block_count=1, filter_count=64,
             compute_dtype="float32", stem_space_to_depth=False)
KERNELS = dict(pointwise_pallas=True, conv3_pallas=True, down_pallas=True)


def setup(seed=0, **kw):
    kw = dict(SMALL, **kw)
    cfg = ModelConfig(**kw)
    params, stats = init_params(cfg, seed)
    x = np.random.RandomState(seed + 3).randn(2, 64, 64, 3).astype(
        np.float32)
    return cfg, JConfig(**kw), params, stats, x


def port_maps(model, x):
    with torch.no_grad():
        return [f.float().numpy() for f in model(torch.from_numpy(x))]


def boxes(cfg, fms):
    return np.asarray(jax_decode([jnp.asarray(f) for f in fms], cfg.anchors,
                                 cfg.number_classes, cfg.strides), np.float32)


@pytest.mark.parametrize("s2d", [False, True])
def test_bf16_mode_matches_jax(s2d):
    """The wiring oracle: with no scales both run the reference's math
    (tests/test_quantized.py:34-42 bound)."""
    cfg, jcfg, p, s, x = setup(stem_space_to_depth=s2d)
    got = port_maps(TQ.build_quantized_model(p, s, cfg, "cpu"), x)
    want = Q.forward_feature_maps(p, s, jcfg, x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_matches_jax(percentile):
    cfg, jcfg, p, s, x = setup()
    want = Q.calibrate(p, s, jcfg, x, percentile=percentile)
    got = TQ.calibrate(TQ.build_quantized_model(p, s, cfg, "cpu"),
                       torch.from_numpy(x), percentile)
    # tests/test_quantized.py:112-115: 5 stem + 3 stride-2 + 4 + 2 + 2 + 0
    # feature-block convs + 18 YoloBlock + 2 FPN at block_count 1
    assert set(got) == set(want) and len(got) == 36
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_int8_matches_jax_kernels():
    """The same wiring in both packages: JAX with its three kernel flags
    (interpret mode), the port through its kernels' plain versions; the
    bound of tests/test_conv3_kernel.py:100-101."""
    cfg, jcfg, p, s, x = setup(block_count=2, filter_count=32)
    scales = Q.calibrate(p, s, jcfg, x)
    got = port_maps(TQ.build_quantized_model(p, s, cfg, "cpu", scales), x)
    want = Q.forward_feature_maps(p, s, jcfg, x, act_scales=scales,
                                  fused_interpret=True, **KERNELS)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        d = np.abs(g - w)
        assert d.max() <= 0.15 * w.std() + 1e-6, (d.max(), w.std())
        assert d.mean() <= 0.02 * w.std() + 1e-7


@pytest.mark.parametrize("skip", ["Darknet53_0/FeatureBlock_1/ConvBlock_1",
                                  "Darknet53_0/FeatureBlock_2/ConvBlock_0",
                                  "YoloBlock_1/ConvBlock_3"])
def test_quant_skip_any_conv_matches_jax(skip):
    """`quant_skip` takes any conv block, as the reference's does
    (quantized.py:113, 150, 166-167, 494, 577, 618): the block runs the
    bf16 path and its neighbours stop chaining s8 into and out of it;
    against JAX's wiring with the same skip, at the bound above."""
    cfg, jcfg, p, s, x = setup(block_count=2, filter_count=32)
    scales = Q.calibrate(p, s, jcfg, x)
    skips = TQ.DEFAULT_QUANT_SKIP + (skip,)
    model = TQ.build_quantized_model(p, s, cfg, "cpu", scales,
                                     quant_skip=skips)
    blocks = dict(model.conv_blocks())
    assert not blocks[skip].q_int8
    assert not any(b.q_int8 and b.q_emits_s8 and b.q_inv_next == 0.0
                   for b in blocks.values())
    got = port_maps(model, x)
    want = Q.forward_feature_maps(p, s, jcfg, x, act_scales=scales,
                                  quant_skip=skips, fused_interpret=True,
                                  **KERNELS)
    plain = port_maps(TQ.build_quantized_model(p, s, cfg, "cpu", scales), x)
    assert any(np.abs(g - q).max() > 0 for g, q in zip(got, plain))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        d = np.abs(g - w)
        assert d.max() <= 0.15 * w.std() + 1e-6, (d.max(), w.std())
        assert d.mean() <= 0.02 * w.std() + 1e-7


@pytest.mark.parametrize("s2d,dtype", [(False, "float32"),
                                       (False, "bfloat16"),
                                       (True, "float32")])
def test_int8_decode_fidelity_vs_jax_mirror(s2d, dtype):
    """Against JAX's XLA mirror with its kernels off (the CPU default) and
    at the JAX default stem (space-to-depth, which quantizes its lifted
    kernels): decode fidelity >= 0.95 (tests/test_conv3_kernel.py:132)."""
    cfg, jcfg, p, s, x = setup(stem_space_to_depth=s2d, compute_dtype=dtype)
    scales = Q.calibrate(p, s, jcfg, x)
    got = port_maps(TQ.build_quantized_model(p, s, cfg, "cpu", scales), x)
    want = Q.forward_feature_maps(p, s, jcfg, x, act_scales=scales)
    want = [np.asarray(w, np.float32) for w in want]
    fid = TQ.decode_iou_fidelity(boxes(cfg, want), boxes(cfg, got), top_k=10)
    assert fid >= 0.95, fid
    assert fid == pytest.approx(Q.decode_iou_fidelity(
        boxes(cfg, want), boxes(cfg, got), top_k=10))


def test_int8_tracks_bf16():
    """The port's own quality guard (tests/test_quantized.py:238-254)."""
    cfg, _, p, s, x = setup()
    model = TQ.build_quantized_model(p, s, cfg, "cpu")
    det_f = boxes(cfg, port_maps(model, x))
    model.set_act_scales(TQ.calibrate(model, torch.from_numpy(x)))
    det_q = boxes(cfg, port_maps(model, x))
    assert TQ.decode_iou_fidelity(det_f, det_q, top_k=10) > 0.9


def test_missing_scale_raises():
    cfg, _, p, s, _ = setup()
    with pytest.raises(KeyError, match="no activation scale"):
        TQ.build_quantized_model(p, s, cfg, "cpu", {"bogus": 1.0})


def test_zero_weight_channel_keeps_bias_precision():
    """An all-zero output channel gets weight scale 1.0, so its bias and
    BatchNorm terms pass the b/dq, mul*dq fold exactly
    (tests/test_quantized.py:212-236)."""
    rng = np.random.RandomState(2)
    ci, co = 16, 16
    w = (rng.randn(co, ci, 1, 1) * 0.05).astype(np.float32)
    w[3] = 0.0
    bias = torch.from_numpy(rng.randn(co).astype(np.float32))
    mul, add = torch.ones(co), torch.zeros(co)
    w_t, epi = quant.fold_conv_block(torch.from_numpy(w), bias, mul, add,
                                     0.1)
    x = torch.from_numpy(rng.randn(1, 4, 4, ci).astype(np.float32))
    got = pointwise_conv_block_q(x, w_t, epi, inv_in=quant.reciprocal(0.1),
                                 inv_next=0.0, alpha=0.2, emit_s8=False,
                                 out_dtype=torch.float32)
    want = torch.where(bias >= 0, bias, 0.2 * bias)[3]
    torch.testing.assert_close(got[..., 3], want.expand(1, 4, 4), rtol=1e-6,
                               atol=1e-6)


def test_kernel_launches_per_forward(monkeypatch):
    """At the flagship depth (block_count 8) the int8 forward calls the
    1x1 kernel 34 times, the 3x3 kernel 32 and the stride-2 kernel 5."""
    cfg, _, p, s, x = setup(block_count=8, filter_count=32)
    model = TQ.build_quantized_model(p, s, cfg, "cpu")
    model.set_act_scales(TQ.calibrate(model, torch.from_numpy(x[:1])))
    calls = {}
    for name in ("pointwise_conv_block_q", "conv3x3_block_q",
                 "down_conv_block_q"):
        def counted(*a, _f=getattr(TQ, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(TQ, name, counted)
    port_maps(model, x[:1])
    assert calls == {"pointwise_conv_block_q": 34, "conv3x3_block_q": 32,
                     "down_conv_block_q": 5}


def test_prepared_constants_stay_out_of_the_state_dict():
    cfg, _, p, s, x = setup()
    model = TQ.build_quantized_model(p, s, cfg, "cpu")
    assert set(model.state_dict()) == set(YoloV3(cfg).state_dict())
    model.set_act_scales(TQ.calibrate(model, torch.from_numpy(x)))
    assert set(model.state_dict()) == set(YoloV3(cfg).state_dict())
    blk = dict(model.conv_blocks())["Darknet53_0/FeatureBlock_0/ConvBlock_0"]
    assert blk.q_wt.dtype == torch.int8 and blk.q_wt.is_contiguous()
    assert tuple(blk.q_wt.shape) == (1, 2, 4)  # [taps, Co, Ci] at fc 64
    # the constants are rebuilt when the weights change
    state = model.state_dict()
    key = "darknet.blocks.0.convs.0.conv.weight"
    state[key] = state[key] * 2
    before, before_wt = blk.q_epi.clone(), blk.q_wt.clone()
    model.load_state_dict(state)
    assert torch.equal(blk.q_wt, before_wt)  # same codes, twice the scale
    assert not torch.equal(before[1], blk.q_epi[1])
