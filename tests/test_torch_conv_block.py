"""PyTorch port fused 1x1 ConvBlock vs the JAX Pallas kernel (interpret).

Both round x and W to bf16 and sum the products in f32, then apply the
f32 epilogue; the sums run in different orders, so the bound is the JAX
kernel test's rtol = atol = 2e-2 (tests/test_pallas_conv_block.py:38).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.pallas.conv_block_kernel import (
    fused_pointwise_conv_block as jax_fused)
from yolov3_tpu_torch.models import yolo as tyolo
from yolov3_tpu_torch.ops.kernels import conv_block as K


def block_params(rng, ci, co):
    return dict(
        kernel=(rng.randn(ci, co) / np.sqrt(ci)).astype(np.float32),
        bias=(0.1 * rng.randn(co)).astype(np.float32),
        scale=rng.uniform(0.8, 1.2, co).astype(np.float32),
        offset=(0.1 * rng.randn(co)).astype(np.float32),
        mean=(0.1 * rng.randn(co)).astype(np.float32),
        var=rng.uniform(0.5, 1.5, co).astype(np.float32))


@pytest.mark.parametrize("n,h,w,ci,co,out", [
    (1, 4, 4, 8, 16, "float32"), (2, 9, 7, 64, 32, "float32"),
    (1, 16, 16, 96, 48, "bfloat16")])
def test_matches_jax_kernel(n, h, w, ci, co, out):
    """Ragged M (2*9*7 = 126 rows) and non-power-of-two Ci/Co included."""
    rng = np.random.RandomState(ci + co)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    p = block_params(rng, ci, co)
    want = jax_fused(x, p["kernel"], p["bias"], p["scale"], p["offset"],
                     p["mean"], p["var"], out_dtype=getattr(jnp, out),
                     interpret=True)
    got = K.fused_pointwise_conv_block(
        torch.from_numpy(x), *(torch.from_numpy(p[k]) for k in
                               ("kernel", "bias", "scale", "offset", "mean",
                                "var")), out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (n, h, w, co)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_conv_block_flag_close_to_standard_path():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 8, 32).astype(np.float32))
    std = tyolo.ConvBlock(32, 64, 1, dtype=torch.float32)
    fused = tyolo.ConvBlock(32, 64, 1, dtype=torch.float32,
                            use_pallas_pointwise=True)
    p = block_params(rng, 32, 64)
    for blk in (std, fused):
        blk.conv.weight.data = torch.from_numpy(p["kernel"].T.copy())[:, :, None, None]
        blk.conv.bias.data = torch.from_numpy(p["bias"])
        blk.bn.weight.data = torch.from_numpy(p["scale"])
        blk.bn.bias.data = torch.from_numpy(p["offset"])
        blk.bn.running_mean.data = torch.from_numpy(p["mean"])
        blk.bn.running_var.data = torch.from_numpy(p["var"])
        blk.prepare()
    assert fused.fused and not std.fused
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), std(x).numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_flag_ignored_off_1x1_stride1():
    assert not tyolo.ConvBlock(8, 16, 3, use_pallas_pointwise=True).fused
    assert not tyolo.ConvBlock(8, 16, 1, stride=2,
                               use_pallas_pointwise=True).fused


def test_wrapper_rejects_mismatched_shapes():
    # x [M, 8] against w [Co = 8, Ci = 16]
    with pytest.raises(ValueError):
        K.pointwise_conv_block(torch.zeros(4, 8), torch.zeros(8, 16),
                               torch.zeros(8), torch.ones(8), torch.zeros(8),
                               0.2, torch.float32)
