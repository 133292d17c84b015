"""The region kernel's `rawimg` mode (stem1 in the kernel, from the image)
and the kernel flags with no kernel of their own (`region_rawin`,
`head_matmul`, `head_pad`), against the JAX package, and the int8 model
under the kernel sets that take the `rawimg` and `affine2` modes.

The setup is tests/test_torch_region.py's: 64 px, batch 2, weights from
the port's `init_params` in the Flax layout, scales from JAX's
`calibrate`; JAX's kernels in interpret mode, the port's plain versions.
Each JAX reference is computed once per module.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_region import (CONV_FLAGS, CUDA_SET, assert_codes,
                               assert_maps_close, for_mode, maps, port_model,
                               port_region, setup, stem)
from yolov3_tpu.models import quantized as Q
from yolov3_tpu_torch.models import quantized as TQ
from yolov3_tpu_torch.ops.kernels import s2d_region_q as R

MODES = [(False, False), (True, False), (True, True)]  # (fast, affine2)
SETS = {
    "rawimg": {"region_full": True, "region_fast": True,
               "region_rawimg": True},
    "affine2": {"region_full": True, "region_fast": True,
                "region_affine2": True},
    "both": {"region_full": True, "region_fast": True,
             "region_rawimg": True, "region_affine2": True},
}


def region_kw(model, fast, affine2, rawimg):
    """The region's weights, table and mode arguments as the forward of
    `model` built for the mode passes them."""
    model = for_mode(model, fast, affine2, rawimg)
    down1, pw, c3, down2 = model._stem_kernels()
    tail = ((model.q_affine2_w_pw, model.q_affine2_w_fb0,
             model.q_affine2_w_ex) if affine2
            else (pw.q_wt, c3.q_wt, down2.q_wt))
    epi = model.q_region_epi_img if rawimg else model.q_region_epi
    kw = dict(alpha=model.alpha, fast=fast, affine2=affine2,
              cast_bf16=model.config.dtype == torch.bfloat16)
    if rawimg:
        kw["w_s1"] = model.q_w_s1
    else:
        kw["inv_in"] = down1.q_inv_in
    return (down1.q_wt, *tail, epi), kw


def port_rawimg(dtype, fast, affine2):
    model = stem(256, dtype)[0]
    x = torch.from_numpy(setup(dtype=dtype)[4]).to(model.config.dtype)
    args, kw = region_kw(model, fast, affine2, True)
    with torch.no_grad():
        return R.s2d_region_block_q(x, *args, **kw).numpy()


@functools.lru_cache(maxsize=None)
def jax_rawimg(dtype, fast, affine2):
    """JAX's rawimg region on the image, with its spy (test_s2d_region_
    kernel.py:311-336): the kernel took the 3-channel image."""
    _, jcfg, p, s, x, scales = setup(dtype=dtype)
    seen, orig = [], Q._s2d_region_fused

    def spy(ctx, p, bs, conv_in, rawin=False, rawimg=False):
        seen.append((rawimg, conv_in.shape[-1]))
        return orig(ctx, p, bs, conv_in, rawin=rawin, rawimg=rawimg)

    Q._s2d_region_fused = spy
    try:
        out = Q._s2d_region(Q._Ctx(
            jcfg, act_scales=scales, region_full=True, region_rawimg=True,
            region_fast=fast, region_affine2=affine2, fused_interpret=True),
            p, s, jnp.asarray(x))
    finally:
        Q._s2d_region_fused = orig
    assert seen == [(True, 3)], seen
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast,affine2", MODES)
def test_rawimg_matches_jax(dtype, fast, affine2):
    """test_s2d_region_kernel.py:339-343: <= 1 code on <= 10% (stem1's
    sums run in another order than JAX's lifted matmul)."""
    got, want = port_rawimg(dtype, fast, affine2), jax_rawimg(dtype, fast,
                                                              affine2)
    assert got.shape == want.shape == (2, 16, 16, 32)
    assert_codes(got, want, 1, 0.10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True])
def test_rawimg_close_to_the_region_on_stem1(dtype, fast):
    """Against the port's region on stem1's output (the default route):
    with the exact epilogue only stem1's sum order differs, <= 1 code on
    <= 10% as above; with `fast` stem1's epilogue is the fast one too,
    the fast-vs-exact class (test_s2d_region_kernel.py:102-103, <= 2
    codes on <= 25%)."""
    assert_codes(port_rawimg(dtype, fast, False), port_region(dtype, fast),
                 *((2, 0.25) if fast else (1, 0.10)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem1_plain_is_stem1(dtype):
    """The plain stem1 with the exact epilogue against the model's stem1
    (conv, epilogue, the quantize to ConvBlock_1's scale): only the conv's
    sum order differs, <= 1 code on <= 1%."""
    model, y, q1 = stem(256, dtype)[:3]
    x = torch.from_numpy(setup(dtype=dtype)[4]).to(model.config.dtype)
    rawimg = for_mode(model, rawimg=True)
    got = R.stem1_plain(x, rawimg.q_w_s1, rawimg.q_region_epi_img[17:21],
                        alpha=model.alpha,
                        cast_bf16=dtype == "bfloat16", fast=False)
    assert got.shape == q1.shape
    assert_codes(got.numpy(), q1.numpy(), 1, 0.01)


def test_rawimg_contract():
    """The image's weights must match it; an image takes no inv_in; the
    first design and the tail take neither mode."""
    model = stem()[0]
    x = torch.from_numpy(setup()[4])
    args, kw = region_kw(model, False, False, True)
    with pytest.raises(ValueError):  # stem1's weights of another type
        R.s2d_region_block_q(x, *args, **dict(kw, w_s1=kw["w_s1"].double()))
    with pytest.raises(ValueError):
        R.s2d_region_block_q(x, *args, **kw, inv_in=1.0)
    with pytest.raises(TypeError):  # the image is float
        R.s2d_region_block_q(x.to(torch.int8), *args,
                             **dict(kw, w_s1=kw["w_s1"].to(torch.int8)))
    with pytest.raises(ValueError):  # 17 rows: no stem1 rows
        R.s2d_region_block_q(x, *args[:-1], for_mode(model).q_region_epi,
                             **kw)
    with pytest.raises(ValueError):
        R.launch(R.NAME, x, args[:-1], args[-1], alpha=0.2, cast_bf16=False,
                 twin=True, w_s1=kw["w_s1"])


def test_rawimg_plan():
    """The rawimg layout with stem1 on CUDA cores (`layout90` with ci, an
    f32 image's and the `_cores` twin's): stem1's f32 weights, q2, one
    buffer for the x tile with the f32 image patch, then q3 and q4; 21 epi
    rows. The flagship keeps T = 8, as it does on tensor cores (a bf16
    image's layout, tests/test_torch_region_stem1.py)."""
    t, c1, c, cm, co, ci = 8, 32, 64, 32, 128, 3
    xw, qw, q4w = 4 * t + 7, 2 * t + 3, 2 * t + 1
    weights = 9 * c * c1 + cm * c + 9 * c * cm + 9 * co * c
    shared = max(xw * xw * c1 + (xw + 2) ** 2 * ci * 4,
                 qw * qw * cm + q4w * q4w * c)
    want = (1024 + weights + 9 * ci * c1 * 4 + qw * qw * c
            + -(-shared // 16) * 16 + 21 * co * 4)
    assert R.smem_bytes(t, c1, c, cm, co, True, ci=ci,
                        cores=True) == want == 219824
    assert R.plan_tile(c1, c, cm, co, ci=ci, cores=True) == 8
    assert R.plan_tile(c1, c, cm, co, ci=ci) == 8
    assert R.plan_tile(c1, c, cm, co, ci=R.MAX_IMAGE_CHANNELS + 1) == 0
    assert R.plan_tile(c1, c, cm, co, ci=ci, twin=True) == 0


# --- the model under the new kernel sets ----------------------------------

@functools.lru_cache(maxsize=None)
def jax_set_maps(name):
    _, jcfg, p, s, x, scales = setup(512)
    return [np.asarray(m, np.float32) for m in Q.forward_feature_maps(
        p, s, jcfg, x, act_scales=scales, fused_interpret=True,
        **SETS[name], **CONV_FLAGS)]


def spied_maps(monkeypatch, model, x):
    """The model's maps, with each region launch's (image channels, rawimg,
    affine2) and the conv blocks run outside the kernels recorded."""
    launches, blocks = [], []
    orig_region, orig_block = TQ.s2d_region_block_q, model._conv_block

    def region(x, *a, **kw):
        launches.append((x.shape[-1], kw.get("w_s1") is not None,
                         kw.get("affine2", False)))
        return orig_region(x, *a, **kw)

    def block(blk, y):
        blocks.append(blk.q_name)
        return orig_block(blk, y)

    monkeypatch.setattr(TQ, "s2d_region_block_q", region)
    monkeypatch.setattr(model, "_conv_block", block)
    return maps(model, x), launches, blocks


@pytest.mark.parametrize("name", list(SETS))
def test_model_sets_match_jax(monkeypatch, name):
    """Each set's int8 model against JAX's under the same flags, within
    the reference's full-model bound (test_s2d_region_kernel.py:305-308,
    0.15 std); one region launch in the mode the flags ask for, and on the
    rawimg route no stem1 outside the kernel."""
    kernels = SETS[name]
    model, x = port_model(kernels=kernels)
    rawimg = kernels.get("region_rawimg", False)
    assert model.region_route(64, 64, kernels) == ("rawimg" if rawimg
                                                   else "region")
    got, launches, blocks = spied_maps(monkeypatch, model, x)
    assert launches == [(3 if rawimg else 16, rawimg,
                         kernels.get("region_affine2", False))]
    assert ("Darknet53_0/ConvBlock_0" in blocks) != rawimg
    assert_maps_close(got, jax_set_maps(name))


def test_rawimg_falls_back_to_the_region_route(monkeypatch):
    """Where the rawimg kernel has no plan (here: none for any image), the
    flags take the default region route, on stem1's output."""
    kernels = SETS["rawimg"]
    model, x = port_model(kernels=kernels)
    plan = TQ.plan_tile
    monkeypatch.setattr(TQ, "plan_tile", lambda *a, ci=0, **k: 0 if ci
                        else plan(*a, **k))
    assert model.region_route(64, 64, kernels) == "region"
    got, launches, blocks = spied_maps(monkeypatch, model, x)
    assert launches == [(16, False, False)]
    assert "Darknet53_0/ConvBlock_0" in blocks
    base, _ = port_model(kernels=dict(CUDA_SET))
    for g, w in zip(got, maps(base, x)):
        np.testing.assert_array_equal(g, w)


def test_rawimg_needs_stem1_in_bf16():
    """With stem1 int8 (not in quant_skip) there are no stem1 rows: the
    rawimg flags take the region route."""
    model, _ = port_model(kernels=SETS["rawimg"], quant_skip=())
    assert model.q_w_s1 is None and model.q_region_epi_img is None
    assert model.region_route(64, 64, SETS["rawimg"]) == "region"


def test_rawin_is_the_region_route(monkeypatch):
    """{region_full, region_rawin}: the default route's launches and codes
    (the port's region already quantizes stem1's raw output as it loads
    it)."""
    model, x = port_model(kernels=dict(CUDA_SET, region_rawin=True))
    base, _ = port_model(kernels=dict(CUDA_SET))
    with monkeypatch.context() as m:
        got, launches, blocks = spied_maps(m, model, x)
    with monkeypatch.context() as m:
        want, base_launches, base_blocks = spied_maps(m, base, x)
    assert launches == base_launches == [(16, False, False)]
    assert blocks == base_blocks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_flags(dtype):
    """head_matmul gives the conv heads' detections within the heads'
    rounding: the matmul rounds its product to the compute type before
    the bias add, the conv adds the bias first (one ulp of the type, two
    with the sum order: 2 * 2^-7 relative in bf16, 1e-5 in f32).
    head_pad changes nothing."""
    cfg, _, p, s, x, scales = setup(512, dtype)
    xt = torch.from_numpy(x)
    runs = {}
    for flags in ({}, {"head_matmul": True}, {"head_pad": True}):
        model = TQ.build_quantized_model(p, s, cfg, "cpu", scales,
                                         kernels=dict(CUDA_SET, **flags))
        with torch.no_grad():
            runs[tuple(flags)] = [f.float().numpy() for f in model(xt)]
    rel = 2 * 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for g, w in zip(runs[("head_matmul",)], runs[()]):
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= rel * np.abs(w) + rel), \
            np.abs(g - w).max()
    for g, w in zip(runs[("head_pad",)], runs[()]):
        np.testing.assert_array_equal(g, w)
