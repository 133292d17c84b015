"""The port's int8 primitives and int8 ConvBlock kernels (plain versions,
on the CPU) against the JAX package's.

Each kernel's plain version gets the same s8 weights and the same folded
epilogue constants as the JAX Pallas kernel, which runs in interpret
mode, so what is compared is the kernel's arithmetic. The bounds are the
JAX kernel tests' own: s8 codes within 1 with at most 5% differing
(tests/test_down_conv.py:51-59), the 1x1 residual variant within 2 codes
and 15% (tests/test_pointwise_kernel.py:104-105), bf16 outputs within
0.1 std (tests/test_conv3_kernel.py:75). The cause of the flips: XLA on
the CPU contracts the epilogue's `y * mul + add` into a fused multiply-add
and may skip bf16 round trips, where the port rounds each op (ROADMAP
Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models import quantized as Q
from yolov3_tpu.ops.pallas.conv3x3_kernel import conv3x3_block_q as j_conv3
from yolov3_tpu.ops.pallas.down_conv_kernel import down_conv_block_q as j_down
from yolov3_tpu.ops.pallas.pointwise_kernel import (
    pointwise_conv_block_q as j_pw)
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.kernels import _conv_q
from yolov3_tpu_torch.ops.kernels.conv3x3_q import conv3x3_block_q
from yolov3_tpu_torch.ops.kernels.down_conv_q import down_conv_block_q
from yolov3_tpu_torch.ops.kernels.pointwise_q import pointwise_conv_block_q

CFG = JConfig(img_size=(64, 64, 3), number_classes=2)
ALPHA = 0.2


def assert_codes_close(got, want, max_diff=1, max_frac=0.05):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= max_diff, (d.max(), (d > 0).mean())
    assert (d > 0).mean() <= max_frac, (d > 0).mean()


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 0.1 * want.std() + 1e-5


def block(rng, k, ci, co):
    """Flax-shaped (p, bs) of one ConvBlock (tests/test_down_conv.py:18)."""
    p = {"Conv_0": {"kernel": rng.randn(k, k, ci, co).astype(np.float32)
                    * 0.05, "bias": rng.randn(co).astype(np.float32) * 0.1},
         "BatchNorm_0": {"scale": 1 + 0.1 * rng.randn(co).astype(np.float32),
                         "bias": rng.randn(co).astype(np.float32) * 0.1}}
    bs = {"BatchNorm_0": {"mean": rng.randn(co).astype(np.float32) * 0.1,
                          "var": 1 + 0.1 * np.abs(rng.randn(co)).astype(
                              np.float32)}}
    return p, bs


def jax_consts(p, bs, sx, s_next, res_scale=0.0):
    """wq and the epi rows as models/quantized.py::_pw_block builds them."""
    w = jnp.asarray(p["Conv_0"]["kernel"])
    k, _, ci, co = w.shape
    wq, sw = Q._quantize_weight(w)
    dq = jnp.float32(sx) * sw
    mul, add = Q._bn_affine(CFG, jax.tree_util.tree_map(jnp.asarray, p),
                            jax.tree_util.tree_map(jnp.asarray, bs))
    cmax = max(ci, co)

    def pad(v, n):
        return jnp.zeros((cmax,), jnp.float32).at[:n].set(v)

    b = jnp.asarray(p["Conv_0"]["bias"])
    epi = jnp.stack([pad(b / dq, co), pad(mul * dq, co), pad(add, co),
                     pad(jnp.full((co,), 1.0 / jnp.float32(s_next)), co),
                     pad(jnp.full((cmax,), 1.0 / jnp.float32(sx)), cmax),
                     pad(jnp.full((cmax,), jnp.float32(res_scale)), cmax)])
    return wq.reshape(k * k, ci, co), epi


def port_consts(wq, epi):
    """The same constants in the port kernels' layout."""
    t, ci, co = wq.shape
    w_t = torch.from_numpy(np.asarray(wq).transpose(0, 2, 1).copy())
    e = np.asarray(epi)
    return w_t, torch.from_numpy(e[:3, :co].copy()), dict(
        inv_in=float(e[4, 0]), inv_next=float(e[3, 0]),
        res_scale=float(e[5, 0]))


def bf16_input(rng, shape, scale=0.5):
    x = (rng.randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def s8_input(rng, shape):
    q = rng.randint(-127, 128, shape).astype(np.int8)
    return jnp.asarray(q), torch.from_numpy(q)


class TestPrimitives:
    def test_quantize_weight_bit_equal(self):
        rng = np.random.RandomState(0)
        w = rng.randn(3, 3, 16, 32).astype(np.float32) * 0.05
        w[..., 3] = 0.0  # all-zero channel: scale 1.0
        jq, js = Q._quantize_weight(jnp.asarray(w))
        tq, ts = quant.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts[3] == 1.0

    @pytest.mark.parametrize("scale", [0.0123, 0.02, 1 / 127.0, 0.5])
    def test_quantize_act_bit_equal(self, scale):
        rng = np.random.RandomState(1)
        x = (rng.randn(2, 8, 8, 16) * 3).astype(np.float32)
        x[0, 0, 0, :4] = np.float32([0.5, 1.5, -0.5, -2.5]) * scale  # ties
        for dt in (np.float32, jnp.bfloat16):
            xj = jnp.asarray(x, dt)
            want = Q._quantize_act(xj, jnp.float32(scale))
            got = quant.quantize_act(
                torch.from_numpy(np.array(xj, np.float32)),
                quant.reciprocal(scale))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("pct", [99.9, 99.0, 50.0])
    def test_hist_percentile_bit_equal(self, pct):
        rng = np.random.RandomState(2)
        vals = [np.abs(rng.randn(5000)).astype(np.float32),
                rng.lognormal(0.0, 1.0, 3000).astype(np.float32)]
        counts, m = quant.abs_histogram([torch.from_numpy(v) for v in vals])
        mj = jnp.maximum(jnp.max(jnp.asarray(np.concatenate(vals))), 1e-30)
        cj = jnp.zeros((Q._HIST_BINS,), jnp.int32)
        for v in vals:
            idx = jnp.minimum((jnp.asarray(v) * (Q._HIST_BINS / mj)).astype(
                jnp.int32), Q._HIST_BINS - 1)
            cj = cj.at[idx].add(1)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(cj))
        want = jax.jit(lambda c, m: Q._hist_percentile(c, m, pct))(cj, mj)
        assert float(quant.hist_percentile(counts, m, pct)) == float(want)
        assert quant.HIST_BINS == Q._HIST_BINS

    def test_bn_affine_within_an_ulp(self):
        """Not bit-equal: XLA's CPU rsqrt is an approximation refined by
        one Newton step (neither 1/sqrt nor correctly rounded), and XLA
        contracts `offset - mean * mul` into a fused multiply-add. The
        port computes `scale * rsqrt(var + eps)` and rounds each op: mul
        within 2 ulps, add within 2 ulps of its terms (ROADMAP Queue C)."""
        rng = np.random.RandomState(3)
        c = 4096
        p, bs = block(rng, 1, 8, c)
        p["BatchNorm_0"]["scale"] = rng.randn(c).astype(np.float32)
        jm, ja = Q._bn_affine(CFG, p, bs)
        tm, ta = quant.bn_affine(*(torch.from_numpy(v) for v in (
            p["BatchNorm_0"]["scale"], p["BatchNorm_0"]["bias"],
            bs["BatchNorm_0"]["mean"], bs["BatchNorm_0"]["var"])), 1e-3)
        jm, ja = np.asarray(jm), np.asarray(ja)
        ulp = 2.0 ** -23
        assert np.all(np.abs(tm.numpy() - jm) <= 2 * ulp * np.abs(jm))
        terms = np.abs(p["BatchNorm_0"]["bias"]) + np.abs(
            bs["BatchNorm_0"]["mean"] * jm)
        assert np.all(np.abs(ta.numpy() - ja) <= 2 * ulp * terms)
        assert (tm.numpy() != jm).any()  # the cause above still holds

    def test_fold_matches_jax_consts(self):
        """The port's kernel constants from a block's parameters: the s8
        weights bit-equal, epi within the bn_affine ulps."""
        rng = np.random.RandomState(4)
        p, bs = block(rng, 3, 16, 32)
        wq, epi = jax_consts(p, bs, 0.02, 0.03)
        mul, add = quant.bn_affine(*(torch.from_numpy(v) for v in (
            p["BatchNorm_0"]["scale"], p["BatchNorm_0"]["bias"],
            bs["BatchNorm_0"]["mean"], bs["BatchNorm_0"]["var"])), 1e-3)
        weight = torch.from_numpy(p["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
                                  .copy())
        w_t, e = quant.fold_conv_block(
            weight, torch.from_numpy(p["Conv_0"]["bias"]), mul, add, 0.02)
        want_w, want_e, _ = port_consts(wq, epi)
        np.testing.assert_array_equal(w_t.numpy(), want_w.numpy())
        np.testing.assert_allclose(e.numpy(), want_e.numpy(), rtol=5e-7,
                                   atol=1e-7)


class TestPointwise:
    @pytest.mark.parametrize("x_kind,emit_bf16", [
        ("s8", False), ("bf16", False), ("bf16", True), ("s8", True)])
    def test_matches_jax_kernel(self, x_kind, emit_bf16):
        rng = np.random.RandomState(10 + len(x_kind) + emit_bf16)
        ci, co = 64, 32
        p, bs = block(rng, 1, ci, co)
        wq, epi = jax_consts(p, bs, 0.11, 0.07)
        shape = (2, 8, 6, ci)
        xj, xt = (s8_input(rng, shape) if x_kind == "s8"
                  else bf16_input(rng, shape, 4.0))
        want = j_pw(xj, wq.reshape(ci, co), epi, alpha=ALPHA,
                    emit_bf16=emit_bf16, interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = pointwise_conv_block_q(
            xt, w_t, e, inv_in=kw["inv_in"], inv_next=kw["inv_next"],
            alpha=ALPHA, out_dtype=torch.bfloat16 if emit_bf16 else None)
        if emit_bf16:
            assert_codes_close(got[0], want[0])
            assert got[1].dtype == torch.bfloat16
            assert_bf16_close(got[1].float(), want[1])
        else:
            assert got.dtype == torch.int8 and got.shape == (2, 8, 6, co)
            assert_codes_close(got, want)

    def test_residual_variant(self):
        rng = np.random.RandomState(9)
        ci, co = 32, 16
        p, bs = block(rng, 1, ci, co)
        wq, epi = jax_consts(p, bs, 0.13, 0.06, res_scale=0.21)
        yj, yt = bf16_input(rng, (2, 8, 8, ci), 1.0)
        rj, rt = s8_input(rng, (2, 8, 8, ci))
        want = j_pw(yj, wq.reshape(ci, co), epi, rj, alpha=ALPHA,
                    interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = pointwise_conv_block_q(yt, w_t, e, alpha=ALPHA, residual_q=rt,
                                     **kw)
        assert_codes_close(got, want, max_diff=2, max_frac=0.15)

    def test_float_output_is_the_plain_conv_block(self):
        """The bf16/f32-output mode is `_conv_block` of an int8 1x1."""
        rng = np.random.RandomState(11)
        ci, co = 32, 16
        p, bs = block(rng, 1, ci, co)
        cfg = JConfig(img_size=(64, 64, 3), number_classes=2,
                      compute_dtype="float32")
        x = rng.randn(2, 6, 6, ci).astype(np.float32)
        pj = jax.tree_util.tree_map(jnp.asarray, (p, bs))
        want = Q._conv_block(Q._Ctx(cfg, act_scales={"c": 0.02}), "c",
                             *pj, jnp.asarray(x))
        wq, epi = jax_consts(p, bs, 0.02, 1.0)
        w_t, e, kw = port_consts(wq, epi)
        got = pointwise_conv_block_q(torch.from_numpy(x), w_t, e,
                                     inv_in=kw["inv_in"], inv_next=0.0,
                                     alpha=ALPHA, emit_s8=False,
                                     out_dtype=torch.float32)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


class TestConv3x3:
    @pytest.mark.parametrize("cin,cout,h,x_kind", [
        (16, 32, 8, "s8"), (32, 16, 10, "s8"), (16, 32, 8, "bf16")])
    def test_matches_jax_kernel(self, cin, cout, h, x_kind):
        rng = np.random.RandomState(cin + h)
        p, bs = block(rng, 3, cin, cout)
        wq, epi = jax_consts(p, bs, 0.02, 0.03)
        shape = (2, h, h, cin)
        xj, xt = (s8_input(rng, shape) if x_kind == "s8"
                  else bf16_input(rng, shape))
        want = j_conv3(xj, wq, epi, alpha=ALPHA, interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = conv3x3_block_q(xt, w_t, e, alpha=ALPHA, cast_bf16=True,
                              inv_in=kw["inv_in"], inv_next=kw["inv_next"])
        assert got.shape == (2, h, h, cout)
        assert_codes_close(got, want)

    @pytest.mark.parametrize("cast_bf16", [True, False])
    def test_residual_and_both_outputs(self, cast_bf16):
        rng = np.random.RandomState(5)
        cin, cout, h = 16, 32, 8
        p, bs = block(rng, 3, cin, cout)
        wq, epi = jax_consts(p, bs, 0.02, 0.03, res_scale=0.04)
        xj, xt = s8_input(rng, (2, h, h, cin))
        rj, rt = s8_input(rng, (2, h, h, cout))
        want_q, want_f = j_conv3(xj, wq, epi, rj, alpha=ALPHA, emit_s8=True,
                                 emit_bf16=True, cast_bf16=cast_bf16,
                                 interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got_q, got_f = conv3x3_block_q(xt, w_t, e, alpha=ALPHA,
                                       cast_bf16=cast_bf16, residual_q=rt,
                                       out_dtype=torch.bfloat16, **kw)
        assert_codes_close(got_q, want_q)
        assert_bf16_close(got_f.float(), want_f)

    def test_bf16_only_emit(self):
        rng = np.random.RandomState(6)
        p, bs = block(rng, 3, 16, 16)
        wq, epi = jax_consts(p, bs, 0.02, 1.0)
        xj, xt = s8_input(rng, (1, 6, 6, 16))
        want = j_conv3(xj, wq, epi, alpha=ALPHA, emit_s8=False,
                       emit_bf16=True, interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = conv3x3_block_q(xt, w_t, e, alpha=ALPHA, cast_bf16=True,
                              emit_s8=False, out_dtype=torch.bfloat16, **kw)
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float(), want)


class TestDownConv:
    @pytest.mark.parametrize("cin,cout,h", [(32, 64, 8), (16, 48, 12),
                                            (8, 8, 32)])
    def test_matches_jax_kernel(self, cin, cout, h):
        rng = np.random.RandomState(cin + h)
        p, bs = block(rng, 3, cin, cout)
        wq, epi = jax_consts(p, bs, 0.02, 0.02)
        xj, xt = bf16_input(rng, (2, h, h, cin))
        want = j_down(xj, wq, epi[:5], alpha=ALPHA, interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = down_conv_block_q(xt, w_t, e, alpha=ALPHA, cast_bf16=True,
                                inv_in=kw["inv_in"], inv_next=kw["inv_next"])
        assert got.shape == (2, h // 2, h // 2, cout)
        assert_codes_close(got, want)

    def test_edge_padding_bottom_right(self):
        """Only the (2, 2) tap is non-zero: it reads the bottom/right pad
        row and column, and must read zeros there."""
        rng = np.random.RandomState(7)
        p, bs = block(rng, 3, 8, 16)
        k = np.zeros((3, 3, 8, 16), np.float32)
        k[2, 2] = rng.randn(8, 16) * 0.1
        p["Conv_0"]["kernel"] = k
        wq, epi = jax_consts(p, bs, 0.02, 0.02)
        xj, xt = bf16_input(rng, (2, 8, 8, 8), 1.0)
        want = j_down(xj, wq, epi[:5], alpha=ALPHA, interpret=True)
        w_t, e, kw = port_consts(wq, epi)
        got = down_conv_block_q(xt, w_t, e, alpha=ALPHA, cast_bf16=True,
                                inv_in=kw["inv_in"], inv_next=kw["inv_next"])
        assert_codes_close(got, want)

    def test_odd_input_pads_both_sides(self):
        """An odd input has XLA's (1, 1) padding: the plain int8 stride-2
        block of the reference (`_conv_block`, its fallback there)."""
        rng = np.random.RandomState(8)
        p, bs = block(rng, 3, 8, 16)
        cfg = JConfig(img_size=(64, 64, 3), number_classes=2,
                      compute_dtype="float32")
        x = rng.randn(1, 7, 9, 8).astype(np.float32)
        pj = jax.tree_util.tree_map(jnp.asarray, (p, bs))
        want = Q._conv_block(Q._Ctx(cfg, act_scales={"c": 0.02}), "c", *pj,
                             jnp.asarray(x), stride=2)
        wq, epi = jax_consts(p, bs, 0.02, 1.0)
        w_t, e, kw = port_consts(wq, epi)
        got = down_conv_block_q(torch.from_numpy(x), w_t, e, alpha=ALPHA,
                                cast_bf16=False, inv_in=kw["inv_in"],
                                inv_next=0.0, emit_s8=False,
                                out_dtype=torch.float32)
        want = np.asarray(want)
        assert got.shape == want.shape == (1, 4, 5, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    def test_rejects_s8_input(self):
        w_t = torch.zeros(9, 16, 16, dtype=torch.int8)
        with pytest.raises(TypeError):
            down_conv_block_q(torch.zeros(1, 4, 4, 16, dtype=torch.int8),
                              w_t, torch.zeros(3, 16), inv_in=1.0,
                              inv_next=1.0, alpha=ALPHA, cast_bf16=True)


def test_plain_sums_are_exact_in_int32():
    """A 3x3 x 1024 contraction of +-127 codes reaches 9*1024*127^2 ~ 1.5e8,
    beyond f32's exact integers: the plain version is exact."""
    x = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8)
    w_t = torch.full((9, 16, 1024), 127, dtype=torch.int8)
    w_t[0, 0, 0] = 126
    epi = torch.stack([torch.zeros(16), torch.ones(16), torch.zeros(16)])
    y = _conv_q.conv_block_q_plain(
        x, w_t, epi, ksize=3, stride=1, inv_in=1.0, inv_next=1.0, alpha=0.2,
        cast_bf16=False, emit_s8=False, out_dtype=torch.float32)
    want = np.float32(9 * 1024 * 127 * 127 - 127)
    assert y[0, 1, 1, 0].item() == want
    assert y[0, 1, 1, 1].item() == np.float32(9 * 1024 * 127 * 127)
