"""The TPU MXU's bf16 training arithmetic, G1's experiment
(scripts/qg512_probe.py `--mxu 1`), on the CPU: `mxu_conv` (bf16 conv
operands, f32 sums, f32 out; its VJP rounds the cotangent to bf16 and
returns f32 gradients) against JAX's `lax.conv_general_dilated` in f32 at
HIGHEST on the bf16-rounded operands and cotangent, forward and VJP,
within 1e-5 of each output's largest |value| (the f32 summation order
alone). The probe serves the gate's export with its patches still on, so
the eval forward must be the port's serving arithmetic: bit-equal to the
bf16 `conv2d_same` path with the patches on or off.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models import yolo as tyolo
from yolov3_tpu_torch.parallel import train_step as T

_spec = importlib.util.spec_from_file_location(
    "qg512_probe", os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts", "qg512_probe.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)
MXU = probe.arithmetic_patches(mxu=True)

TOL = 1e-5
SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             stem_space_to_depth=False)
BATCH = 2
LR = 1e-4


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def jax_conv(x, w_oihw, stride):
    return jax.lax.conv_general_dilated(
        x, jnp.transpose(w_oihw, (2, 3, 1, 0)), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("shape", [
    (2, 9, 9, 16, 24, 3, 1),    # 3x3 stride 1
    (2, 9, 6, 16, 24, 3, 2),    # 3x3 stride 2, H != W: SAME's uneven pad
    (2, 8, 8, 16, 8, 1, 1),     # 1x1
])
def test_mxu_conv_matches_jax(shape):
    n, h, w, ci, co, k, s = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(n, h, w, ci).astype(np.float32)
    wt = (rng.randn(co, ci, k, k) / np.sqrt(ci * k * k)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jax_conv(a, b, s), jnp.asarray(bf16(x)),
                     jnp.asarray(bf16(wt)))
    dy = rng.randn(*y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(bf16(dy)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    ty = probe.mxu_conv(tx, tw, s)
    ty.backward(torch.from_numpy(dy))
    assert ty.dtype == tx.grad.dtype == tw.grad.dtype == torch.float32
    close(ty.detach(), y, TOL, "forward")
    close(tx.grad, dx, TOL, "dx")
    close(tw.grad, dw, TOL, "dw")
    # a bf16 input gets a bf16 gradient (the QAT blocks' outputs)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    probe.mxu_conv(xb, tw, s).backward(torch.from_numpy(dy))
    assert xb.grad.dtype == torch.bfloat16


# --- serving stays the port's -------------------------------------------

def make_batch(seed=0):
    from yolov3_tpu.data.encoder import encode_boxes
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, 64, 64, 3).astype(np.float32)
    grids = [[], [], []]
    for b in range(BATCH):
        boxes = np.array([[8 + 20 * b, 8, 20, 24, b % 2],
                          [30, 34 - 10 * b, 28, 16, 1]], np.int32)
        for g, grid in zip(grids, encode_boxes(boxes, (64, 64, 3),
                                               SMALL["anchors"], 2)):
            g.append(grid)
    return (images, *[np.stack(g) for g in grids])


def test_eval_forward_is_the_bf16_conv2d_same_path():
    """Serving is untouched by the experiment: after a train step under
    `--mxu 1`, every ConvBlock and head of the eval forward, with the
    patches on and off, gives bit for bit `conv2d_same` in bf16 on its
    input with its derived constants, then LeakyReLU and the
    running-statistics BatchNorm; and the outputs equal a fresh model's
    on the same state_dict."""
    cfg = ModelConfig(**dict(SMALL, compute_dtype="bfloat16"))
    state = T.create_train_state(cfg, TrainConfig(), device="cpu")
    step = T.make_train_step(cfg, TrainConfig(), BATCH)
    with probe.patched(MXU):
        step(state, [torch.from_numpy(a) for a in make_batch()], LR)
    model = state.model.eval()
    tyolo.prepare_all(model)
    seen = []

    def check(m, inputs, out):
        x = inputs[0].to(torch.bfloat16)
        stride = getattr(m, "stride", 1)
        want = tyolo.conv2d_same(x, m.w, m.b, stride)
        if isinstance(m, tyolo.ConvBlock):
            want = m.bn(torch.nn.functional.leaky_relu(want, m.alpha))
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, want)
        seen.append(m)
    blocks = [m for m in model.modules()
              if isinstance(m, (tyolo.ConvBlock, tyolo.DetectionHead))]
    for m in blocks:
        m.register_forward_hook(check)
    images = torch.from_numpy(make_batch(1)[0])
    with torch.no_grad():
        got = model(images)
        with probe.patched(MXU):
            patched = model(images)
        fresh = tyolo.YoloV3(cfg)
        fresh.load_state_dict(model.state_dict())
        again = fresh(images)
    assert len(seen) == 2 * len(blocks)
    for g, p, w in zip(got, patched, again):
        assert torch.equal(g, p) and torch.equal(g, w)

