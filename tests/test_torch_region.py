"""The port's int8 stem region (`ops/kernels/s2d_region_q.py`,
`s2d_tail_q.py`, `exit_conv_q.py`), the greedy IoU-slab NMS, and the int8
model under the reference's default kernel set, against the JAX package.

64 px, batch 2, weights from the port's `init_params` (a numpy seed) in
the Flax layout, scales from JAX's `calibrate`. The JAX kernels run in
interpret mode on the space-to-depth view of the same s8 tensors the port
takes in the plain layout (`space_to_depth`, channel order (dy, dx, c));
the port runs its plain versions. Each JAX reference is computed once per
module. Kernel-level cases use filter_count 256; the model-level ones 512,
the narrowest width whose region channels (16, 32, 16, 64) the kernels
take.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models import quantized as Q
from yolov3_tpu.models import yolo as Y
from yolov3_tpu.ops.pallas.exit_conv_kernel import exit_conv_block_q as jexit
from yolov3_tpu.ops.pallas.nms_kernel import greedy_suppress_pallas
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models import quantized as TQ
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.kernels import nms_suppress as NMS
from yolov3_tpu_torch.ops.kernels.conv3x3_q import conv3x3_block_q_plain
from yolov3_tpu_torch.ops.kernels.down_conv_q import down_conv_block_q_plain
from yolov3_tpu_torch.ops.kernels.exit_conv_q import exit_conv_block_q
from yolov3_tpu_torch.ops.kernels.pointwise_q import \
    pointwise_conv_block_q_plain
from yolov3_tpu_torch.ops.kernels.s2d_region_q import s2d_region_block_q
from yolov3_tpu_torch.ops.kernels.s2d_tail_q import s2d_tail_block_q
from yolov3_tpu_torch.ops.nms import pairwise_iou
from yolov3_tpu_torch.utils.checkpoint import init_params

D = "Darknet53_0"
CONV_FLAGS = dict(pointwise_pallas=True, conv3_pallas=True, down_pallas=True)
CUDA_SET = TQ.default_serving_kernels("cuda")


@functools.lru_cache(maxsize=None)
def setup(fc=256, dtype="float32", block_count=1):
    kw = dict(img_size=(64, 64, 3), number_classes=2,
              anchors=((16, 48), (48, 16)), block_count=block_count,
              filter_count=fc, compute_dtype=dtype)
    cfg, jcfg = ModelConfig(**kw), JConfig(**kw)
    params, stats = init_params(cfg, 0)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    scales = Q.calibrate(params, stats, jcfg, x)
    return cfg, jcfg, params, stats, x, scales


@functools.lru_cache(maxsize=None)
def stem(fc=256, dtype="float32"):
    """The port's model and the s8 tensors of its stem region: q1 (stem1
    out at ConvBlock_1's scale), q2 (stem2 out at FeatureBlock_0's) and
    q4 (FeatureBlock_0 out at ConvBlock_2's)."""
    cfg, _, p, s, x, scales = setup(fc, dtype)
    model = TQ.build_quantized_model(p, s, cfg, "cpu", scales)
    down1, pw, c3, down2 = model._stem_kernels()
    with torch.no_grad():
        y = model._conv_block(model.darknet.convs[0],
                              torch.from_numpy(x).to(cfg.dtype))
        q2 = model._down_block(down1, y)
        q4 = conv3x3_block_q_plain(
            model._pw_block(pw, q2), c3.q_wt, c3.q_epi,
            cast_bf16=cfg.dtype == torch.bfloat16, residual_q=q2,
            inv_in=c3.q_inv_in, inv_next=down2.q_inv_in, alpha=model.alpha,
            res_scale=c3.q_res_scale)
    return model, y, quant.quantize_act(y, down1.q_inv_in), q2, q4


@functools.lru_cache(maxsize=None)
def for_mode(model, fast=False, affine2=False, rawimg=False):
    """`model`'s weights, scales and quant_skip in a model built for
    {region_full} and the region mode's flags, so its region tables are
    that mode's (`prepare()` builds only the mode the flags select)."""
    m = TQ.QuantizedYoloV3(model.config, quant_skip=tuple(model.quant_skip),
                           kernels=dict(region_full=True, region_fast=fast,
                                        region_affine2=affine2,
                                        region_rawimg=rawimg))
    m.load_state_dict(model.state_dict())
    m.set_act_scales(model.act_scales)
    return m.eval()


def region_args(model, fast=False):
    down1, pw, c3, down2 = model._stem_kernels()
    epi = for_mode(model, fast).q_region_epi
    return (down1.q_wt, pw.q_wt, c3.q_wt, down2.q_wt, epi)


def s2d(t):
    return Y.space_to_depth(jnp.asarray(t.numpy()))


@functools.lru_cache(maxsize=None)
def jax_region(dtype, fast):
    _, jcfg, p, s, _, scales = setup(dtype=dtype)
    ctx = Q._Ctx(jcfg, act_scales=scales, region_full=True,
                 region_fast=fast, fused_interpret=True)
    return np.asarray(Q._s2d_region_fused(ctx, p, s, s2d(stem(256, dtype)[2])))


def port_region(dtype, fast):
    model, _, q1 = stem(256, dtype)[:3]
    with torch.no_grad():
        return s2d_region_block_q(
            q1, *region_args(model, fast), alpha=model.alpha,
            cast_bf16=dtype == "bfloat16", fast=fast).numpy()


def assert_codes(got, want, codes, frac):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= codes, (d.max(), (d > 0).mean())
    assert (d > 0).mean() <= frac, (d > 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
def test_region_matches_jax(dtype, fast):
    """test_s2d_region_kernel.py:58-59: <= 1 code, <= 6% of codes."""
    got, want = port_region(dtype, fast), jax_region(dtype, fast)
    assert got.shape == want.shape == (2, 16, 16, 32)
    assert_codes(got, want, 1, 0.06)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_close_to_exact(dtype):
    """test_s2d_region_kernel.py:102-103: <= 2 codes, <= 25%, at filter
    count 512. (At 256 in bf16 JAX's own fast and exact regions differ by
    3 codes, and the port's by the same codes: ROADMAP Queue C.)"""
    model, _, q1 = stem(512, dtype)[:3]
    with torch.no_grad():
        fast, exact = (s2d_region_block_q(
            q1, *region_args(model, f), alpha=model.alpha,
            cast_bf16=dtype == "bfloat16", fast=f) for f in (True, False))
    assert_codes(fast, exact, 2, 0.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
def test_region_quantizes_a_float_input(dtype, fast):
    """stem1's float output with ConvBlock_1's 1/s gives the codes of the
    region on that output quantized first (`block_input`), and so JAX's."""
    model, y = stem(256, dtype)[:2]
    with torch.no_grad():
        got = s2d_region_block_q(
            y, *region_args(model, fast), alpha=model.alpha,
            cast_bf16=dtype == "bfloat16", fast=fast,
            inv_in=model._stem_kernels()[0].q_inv_in).numpy()
    np.testing.assert_array_equal(got, port_region(dtype, fast))
    assert_codes(got, jax_region(dtype, fast), 1, 0.06)


def test_region_input_contract():
    """The region takes s8, or bf16/f32 with its 1/s; the tail only s8."""
    model, y, q1, q2 = stem()[:4]
    args = region_args(model)
    with pytest.raises(ValueError):
        s2d_region_block_q(y, *args, alpha=0.1, cast_bf16=False)
    with pytest.raises(TypeError):
        s2d_region_block_q(y.double(), *args, alpha=0.1, cast_bf16=False,
                           inv_in=1.0)
    with pytest.raises(TypeError):
        s2d_tail_block_q(q2.float(), *args[1:4], model.q_tail_epi,
                         alpha=0.1, cast_bf16=False)


def test_exact_region_is_the_kernel_chain_in_bf16():
    """In bf16 the exact region computes what the stride-2, 1x1, 3x3 and
    stride-2 kernels compute one after another: equal code for code."""
    model, y = stem(256, "bfloat16")[:2]
    down1, pw, c3, down2 = model._stem_kernels()
    kw = dict(alpha=model.alpha)
    with torch.no_grad():
        q2 = down_conv_block_q_plain(y, down1.q_wt, down1.q_epi,
                                     inv_in=down1.q_inv_in,
                                     inv_next=down1.q_inv_next,
                                     cast_bf16=True, **kw)
        q3 = pointwise_conv_block_q_plain(q2, pw.q_wt, pw.q_epi,
                                          inv_in=pw.q_inv_in,
                                          inv_next=pw.q_inv_next, **kw)
        fb0 = conv3x3_block_q_plain(q3, c3.q_wt, c3.q_epi,
                                    inv_in=c3.q_inv_in, inv_next=0.0,
                                    cast_bf16=True, residual_q=q2,
                                    res_scale=c3.q_res_scale, emit_s8=False,
                                    out_dtype=torch.bfloat16, **kw)
        chain = down_conv_block_q_plain(fb0, down2.q_wt, down2.q_epi,
                                        inv_in=down2.q_inv_in,
                                        inv_next=down2.q_inv_next,
                                        cast_bf16=True, **kw)
    np.testing.assert_array_equal(port_region("bfloat16", False),
                                  chain.numpy())


def test_tail_matches_jax():
    """test_s2d_tail_kernel.py:56-57: <= 1 code, <= 5%."""
    model, _, _, q2, _ = stem()
    _, jcfg, p, s, _, scales = setup()
    down1, pw, c3, down2 = model._stem_kernels()
    with torch.no_grad():
        got = s2d_tail_block_q(q2, pw.q_wt, c3.q_wt, down2.q_wt,
                               model.q_tail_epi, alpha=model.alpha,
                               cast_bf16=False)
    ctx = Q._Ctx(jcfg, act_scales=scales, region_pallas=True,
                 fused_interpret=True)
    want = Q._s2d_tail(ctx, p, s, s2d(q2))
    assert got.shape == want.shape
    assert_codes(got.numpy(), want, 1, 0.05)


def test_exit_matches_jax():
    """test_exit_conv_kernel.py:73-74: <= 1 code, <= 2%. The JAX side packs
    its lifted kernel and epilogue as `_s2d_region` does."""
    model, _, _, _, q4 = stem()
    _, jcfg, p, s, _, scales = setup()
    down2 = model._stem_kernels()[3]
    with torch.no_grad():
        got = exit_conv_block_q(q4, down2.q_wt, model.q_exit_epi,
                                alpha=model.alpha, cast_bf16=False)
    pb, bb = p[D]["ConvBlock_2"], s[D]["ConvBlock_2"]
    wq, sw = Q._quantize_weight(Y._s2d_kernel_stride2_exit(
        pb["Conv_0"]["kernel"]))
    dq = jnp.float32(scales[f"{D}/ConvBlock_2"]) * sw
    mul, add = Q._bn_affine(jcfg, pb, bb)
    inv = jnp.float32(1.0) / jnp.float32(
        scales[f"{D}/FeatureBlock_1/ConvBlock_0"])
    epi = jnp.stack([pb["Conv_0"]["bias"] / dq, mul * dq, add,
                     jnp.full_like(add, inv)])
    want = jexit(s2d(q4), wq.reshape(4, *wq.shape[2:]), epi,
                 alpha=jcfg.leaky_relu_alpha, cast_bf16=False,
                 interpret=True)
    assert got.shape == want.shape
    assert_codes(got.numpy(), want, 1, 0.02)


def port_model(fc=512, block_count=1, **kw):
    cfg, _, p, s, x, scales = setup(fc, block_count=block_count)
    return TQ.build_quantized_model(p, s, cfg, "cpu", scales, **kw), x


def maps(model, x):
    with torch.no_grad():
        return [f.float().numpy() for f in model(torch.from_numpy(x))]


@functools.lru_cache(maxsize=None)
def jax_maps(quant_skip=Q.DEFAULT_QUANT_SKIP):
    _, jcfg, p, s, x, scales = setup(512)
    kernels = dict(CUDA_SET, **CONV_FLAGS)
    return [np.asarray(m, np.float32) for m in Q.forward_feature_maps(
        p, s, jcfg, x, act_scales=scales, quant_skip=quant_skip,
        fused_interpret=True, **kernels)]


def assert_maps_close(got, want):
    """tests/test_conv3_kernel.py:100-101's model bound."""
    for g, w in zip(got, want):
        d = np.abs(g - w)
        assert d.max() <= 0.15 * w.std() + 1e-6, (d.max(), w.std())
        assert d.mean() <= 0.02 * w.std() + 1e-7


def test_model_default_set_matches_jax():
    model, x = port_model(kernels=dict(CUDA_SET, **CONV_FLAGS))
    assert model.region_route(64, 64, model.kernels) == "region"
    assert_maps_close(maps(model, x), jax_maps())


def test_quant_skip_route_matches_jax():
    """ConvBlock_2 kept bf16: no region, tail or exit kernel; stem2 and
    FeatureBlock_0 on the kernels, ConvBlock_2 a bf16 conv."""
    skip = Q.DEFAULT_QUANT_SKIP + (f"{D}/ConvBlock_2",)
    model, x = port_model(kernels=CUDA_SET, quant_skip=skip)
    assert model.region_route(64, 64, CUDA_SET) == "blocks"
    assert_maps_close(maps(model, x), jax_maps(skip))


@pytest.mark.parametrize("kernels,route", [
    (CUDA_SET, "region"),
    ({"region_pallas": True, "exit_pallas": True}, "tail"),
    ({"exit_pallas": True}, "exit"),
    ({}, "blocks")])
def test_routes_agree(kernels, route):
    """Every route computes the same maps as the plain wiring; in f32 only
    the fast epilogue may move codes."""
    model, x = port_model(kernels=kernels)
    assert model.region_route(64, 64, kernels) == route
    base, _ = port_model(kernels={})
    for g, w in zip(maps(model, x), maps(base, x)):
        d = np.abs(g - w)
        assert d.max() <= 0.15 * w.std() + 1e-6


@pytest.mark.parametrize("kernels,want", [
    (CUDA_SET, {"pointwise_conv_block_q": 33, "conv3x3_block_q": 31,
                "down_conv_block_q": 3, "s2d_region_block_q": 1}),
    ({"region_pallas": True, "exit_pallas": True},
     {"pointwise_conv_block_q": 33, "conv3x3_block_q": 31,
      "down_conv_block_q": 4, "s2d_tail_block_q": 1}),
    ({"exit_pallas": True},
     {"pointwise_conv_block_q": 34, "conv3x3_block_q": 32,
      "down_conv_block_q": 4, "exit_conv_block_q": 1})])
def test_launches_per_forward(monkeypatch, kernels, want):
    """At the flagship depth (block_count 8)."""
    model, x = port_model(block_count=8, kernels=kernels)
    calls = {}
    for name in ("pointwise_conv_block_q", "conv3x3_block_q",
                 "down_conv_block_q", "s2d_region_block_q",
                 "s2d_tail_block_q", "exit_conv_block_q"):
        def counted(*a, _f=getattr(TQ, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(TQ, name, counted)
    maps(model, x[:1])
    assert calls == want


def test_ineligible_routes():
    model, _ = port_model(256)  # region channels 8, 16, 8, 32
    assert model.region_route(64, 64, CUDA_SET) == "exit"
    model, _ = port_model(128)  # exit channels 4 -> 16
    assert model.region_route(64, 64, CUDA_SET) == "blocks"
    model, _ = port_model()
    assert model.region_route(66, 64, CUDA_SET) == "exit"  # H % 4 != 0
    skip = Q.DEFAULT_QUANT_SKIP + (f"{D}/ConvBlock_1",)
    model, _ = port_model(quant_skip=skip)
    assert model.region_route(64, 64, dict(CUDA_SET,
                                           region_pallas=True)) == "tail"
    cfg, _, p, s, _, scales = setup(512)
    plain = TQ.build_quantized_model(
        p, s, dataclasses.replace(cfg, stem_space_to_depth=False), "cpu",
        scales)
    assert plain.region_route(64, 64, CUDA_SET) == "blocks"
    # a bf16 block inside the region: every fused route needs it int8
    model, _ = port_model(quant_skip=(f"{D}/FeatureBlock_0/ConvBlock_0",))
    assert model.region_route(64, 64, dict(CUDA_SET,
                                           region_pallas=True)) == "blocks"


@pytest.mark.parametrize("c1,c,cm,co,region,tile,total", [
    (32, 64, 32, 128, True, 8, 224192),    # the flagship region
    (0, 64, 32, 128, False, 8, 155040),    # the flagship tail
    (16, 32, 16, 64, True, 8, 93664),     # the card tests' widths
    (16, 16, 32, 48, True, 8, 74640)])
def test_region_plan_and_layout(c1, c, cm, co, region, tile, total):
    """The kernel's shared memory (`csrc/s2d_region_block_q.cu::layout90`):
    1 KB of alignment slack; every stage's weights resident in 32-byte K
    steps (a 16-channel K padded to 32); q2, the input tile, q3 and q4
    unpadded; the epi table. The flagship keeps T = 8 within the card's
    227 KB."""
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as R
    assert R.plan_tile(c1, c, cm, co, region) == tile
    got = R.smem_bytes(tile, c1, c, cm, co, region)
    assert got == total <= R.SMEM_LIMIT
    k32 = lambda k: -(-k // 32) * 32  # noqa: E731
    weights = ((9 * c * k32(c1) if region else 0) + cm * k32(c)
               + 9 * c * k32(cm) + 9 * co * k32(c))
    qw, q4w, xw = 2 * tile + 3, 2 * tile + 1, 4 * tile + 7
    bufs = (qw * qw * c + (xw * xw * c1 if region else 0) + qw * qw * cm
            + q4w * q4w * c + (17 if region else 13) * max(c, cm, co) * 4)
    assert got == 1024 + weights + bufs
    # the first design's layout is its own
    assert R.plan_tile(c1, c, cm, co, region, twin=True) == tile
    assert R.smem_bytes(8, 32, 64, 32, 128, True, twin=True) == 200400
    # at the flagship a 16 x 16 tile would not fit
    assert R.smem_bytes(16, 32, 64, 32, 128, True) > R.SMEM_LIMIT


def test_region_plan_refuses_channels_it_cannot_take():
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as R
    assert R.plan_tile(24, 64, 32, 128) == 0
    assert R.plan_tile(32, 64, 32, 120) == 0
    # channels too wide for any tile's shared memory
    assert R.plan_tile(512, 512, 512, 512) == 0


def test_flags():
    backend = jax.default_backend
    try:
        jax.default_backend = lambda: "tpu"
        assert CUDA_SET == Q.default_serving_kernels()
    finally:
        jax.default_backend = backend
    assert TQ.default_serving_kernels("cpu") == Q.default_serving_kernels()
    assert TQ.default_serving_kernels(torch.device("cpu")) == {}
    with pytest.raises(KeyError):
        port_model(kernels={"region_fullest": True})
    # every kernel flag of the reference's _Ctx is accepted
    ref = {n for n, p in inspect.signature(Q._Ctx).parameters.items()
           if p.default is False} - {"fused_interpret", "bn_batch_stats"}
    assert ref == set(TQ.WIRING_FLAGS + TQ.NO_OP_FLAGS)
    everything = dict.fromkeys(ref, True)
    assert TQ.check_kernels(everything) == everything
    port_model(kernels=everything)
    model, x = port_model(kernels=dict(CUDA_SET, region_affine2=False))
    same, _ = port_model(kernels=dict(
        CUDA_SET, **{n: True for n in TQ.NO_OP_FLAGS}))
    for g, w in zip(maps(model, x), maps(same, x)):
        np.testing.assert_array_equal(g, w)
    # None: the default of the device the forward runs on (the CPU here)
    default, _ = port_model()
    base, _ = port_model(kernels={})
    for g, w in zip(maps(default, x), maps(base, x)):
        np.testing.assert_array_equal(g, w)


# --- the affine2 epilogue ------------------------------------------------


@functools.lru_cache(maxsize=None)
def negative_m_setup(fc=256):
    """setup()'s weights with the BatchNorm scale of every third channel of
    stem2, FB0's 1x1 and FB0's 3x3 negated (test_s2d_region_kernel.py:
    128-152): those channels' M < 0 in all three two-affine stages."""
    cfg, jcfg, params, stats, x, _ = setup(fc)
    params = jax.tree_util.tree_map(np.copy, params)
    d = params[D]
    for blk in (d["ConvBlock_1"], d["FeatureBlock_0"]["ConvBlock_0"],
                d["FeatureBlock_0"]["ConvBlock_1"]):
        sc = blk["BatchNorm_0"]["scale"]
        sc[np.arange(sc.shape[0]) % 3 == 0] *= -1
    scales = Q.calibrate(params, stats, jcfg, x)
    return cfg, jcfg, params, stats, x, scales


def affine2_case(negative, dtype="float32", fc=256):
    """(port model built for the affine2 mode, its q1, the JAX setup) for
    the affine2 tests."""
    if not negative:
        return (for_mode(stem(fc, dtype)[0], True, True), stem(fc, dtype)[2],
                setup(fc, dtype))
    cfg, jcfg, p, s, x, scales = negative_m_setup(fc)
    model = TQ.build_quantized_model(p, s, cfg, "cpu", scales, kernels=dict(
        region_full=True, region_fast=True, region_affine2=True))
    with torch.no_grad():
        y = model._conv_block(model.darknet.convs[0], torch.from_numpy(x))
    q1 = quant.quantize_act(y, model._stem_kernels()[0].q_inv_in)
    return model, q1, (cfg, jcfg, p, s, x, scales)


def port_affine2(model, q1, cast):
    down1 = model._stem_kernels()[0]
    with torch.no_grad():
        return s2d_region_block_q(
            q1, down1.q_wt, model.q_affine2_w_pw, model.q_affine2_w_fb0,
            model.q_affine2_w_ex, model.q_region_epi,
            alpha=model.alpha, cast_bf16=cast, fast=True,
            affine2=True).numpy()


@functools.lru_cache(maxsize=None)
def jax_affine2(negative, dtype):
    model, q1, (_, jcfg, p, s, _, scales) = affine2_case(negative, dtype)
    ctx = Q._Ctx(jcfg, act_scales=scales, region_full=True,
                 region_fast=True, region_affine2=True, fused_interpret=True)
    return np.asarray(Q._s2d_region_fused(ctx, p, s, s2d(q1)))


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine2_matches_jax(negative, dtype):
    """The plain affine2 region against JAX's affine2 region (interpret
    mode) on the same s8 input, with every third channel of the three
    two-affine stages at M < 0 or none. JAX's own bound is against the
    exact region (test_s2d_region_kernel.py:125-126, <= 2 codes on <= 25%);
    against JAX's affine2 region the codes observed are equal, code for
    code (both round each product and add on its own)."""
    model, q1, _ = affine2_case(negative, dtype)
    if negative:  # the packing flipped channels of each stage
        assert (model.q_affine2_w_pw < 0).sum() != (
            model._stem_kernels()[1].q_wt < 0).sum()
    got = port_affine2(model, q1, dtype == "bfloat16")
    want = jax_affine2(negative, dtype)
    assert got.shape == want.shape == (2, 16, 16, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("negative", [False, True])
def test_affine2_close_to_exact(negative):
    """test_s2d_region_kernel.py:106-152: the affine2 region within 2 codes
    on 25% of the exact one (f32, filter count 256; with negative M as
    there)."""
    model, q1, _ = affine2_case(negative)
    with torch.no_grad():
        exact = s2d_region_block_q(q1, *region_args(model), alpha=model.alpha,
                                   cast_bf16=False)
    assert_codes(port_affine2(model, q1, False), exact, 2, 0.25)


def test_affine2_packing():
    """`region_epi_affine2`: rows (m1, c1, m2, c2) = sign * (M/s, M/s * b +
    A/s, alpha M/s, alpha M/s * b + A/s) with the sign of M/s, and max of
    the two affines equals the exact epilogue before its rounding; the
    consumers' weights flip where the producing stage's sign is
    negative."""
    model, _, (_, _, _, _, _, scales) = affine2_case(True)
    down1, pw, c3, down2 = model._stem_kernels()
    t, fast = model.q_region_epi, for_mode(model, True).q_region_epi
    assert t.shape == fast.shape
    c = down1.q_wt.shape[1]
    rng = np.random.RandomState(0)
    acc = torch.from_numpy(rng.randint(-3000, 3000, (64, c)).astype(
        np.float32))
    b, m, a = down1.q_epi
    s2 = np.float32(scales[f"{D}/FeatureBlock_0/ConvBlock_0"])
    sgn = torch.where(m / torch.tensor(s2) >= 0, 1.0, -1.0)
    y = acc + b
    want = (torch.where(y >= 0, y, model.alpha * y) * m + a) / s2 * sgn
    got = torch.maximum(acc * t[13, :c] + t[14, :c], acc * t[15, :c]
                        + t[16, :c])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert (sgn < 0).any() and (sgn > 0).any()
    flip = model.q_affine2_w_pw
    torch.testing.assert_close(flip * sgn[None, None, :].to(torch.int8),
                               pw.q_wt)
    # the exit keeps the fast rows
    torch.testing.assert_close(t[9:12], fast[9:12])


def slab_case(seed, c, k, sparse):
    rng = np.random.RandomState(seed)
    xy = rng.rand(c, k, 2).astype(np.float32) * 100
    wh = rng.rand(c, k, 2).astype(np.float32) * 40 + 1
    cand = np.concatenate([xy, xy + wh], axis=-1)
    counts = rng.randint(0, k + 1, c) if sparse else np.full(c, k)
    return cand, np.arange(k)[None, :] < counts[:, None]


@pytest.mark.parametrize("c,k,sparse", [
    (6, 64, True), (3, 40, False),
    # the 64-slot mask words' edges
    (3, 1, False), (3, 63, True), (2, 64, False), (3, 65, False),
    (2, 129, True)])
def test_greedy_suppress_matches_jax(c, k, sparse):
    cand, valid = slab_case(c + k, c, k, sparse)
    iou = pairwise_iou(torch.from_numpy(cand))
    got = NMS.greedy_suppress(iou, torch.from_numpy(valid), 0.3)
    want = greedy_suppress_pallas(jnp.asarray(iou.numpy()),
                                  jnp.asarray(valid), 0.3, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, NMS.suppress_boxes_plain(
        torch.from_numpy(cand), torch.from_numpy(valid), 0.3))
    # an asymmetric slab: both read row i for candidate i
    rnd = np.random.RandomState(c).rand(c, k, k).astype(np.float32)
    got = NMS.greedy_suppress(torch.from_numpy(rnd),
                              torch.from_numpy(valid), 0.9)
    want = greedy_suppress_pallas(jnp.asarray(rnd), jnp.asarray(valid), 0.9,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 63, 64, 65, 129])
def test_greedy_suppress_nan_and_ties_match_jax(k):
    """An asymmetric slab holding NaNs and entries exactly at the
    threshold (float32(0.3)), on sparse valid rows: neither a NaN nor a
    tie suppresses (`>` is false on both), in the plain version and in
    JAX's kernel (interpret mode) alike."""
    rng = np.random.RandomState(k + 7)
    c, thr = 3, 0.3
    rnd = rng.rand(c, k, k).astype(np.float32)
    rnd[rng.rand(c, k, k) < 0.2] = np.nan
    rnd[rng.rand(c, k, k) < 0.3] = np.float32(thr)
    valid = rng.rand(c, k) < 0.8
    got = NMS.greedy_suppress(torch.from_numpy(rnd), torch.from_numpy(valid),
                              thr)
    want = greedy_suppress_pallas(jnp.asarray(rnd), jnp.asarray(valid), thr,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the slab's NaNs and ties change the answer: with them read as
    # suppressing, fewer slots are kept
    hot = torch.from_numpy(np.where(np.isnan(rnd) | (rnd == np.float32(thr)),
                                    np.float32(1.0), rnd))
    assert int(NMS.greedy_suppress(hot, torch.from_numpy(valid),
                                   thr).sum()) < int(got.sum()) or k == 1
