"""Quantization-aware training in the port (`ModelConfig.int8_train`,
`int8_train_static`) against the JAX package's on the CPU: the STE convs
(`models/yolo.py::int8_ste_conv`, `int8_ste_conv_static`), the exact
int32 sums (`ops/quant.py::int8_conv_sums`), the QAT train forward and
step, the static scales (`act_scale` buffers, `calibrate(train_mode=True)`,
`scales_to_buffers`) and the trainer's flags. 64 px, block_count 1,
filter_count 32, f32, both sides from one JAX `init`.

Bounds:
- one STE conv: rtol = atol = 1e-5 against JAX's forward
  (tests/test_int8_train.py:34-49); the sums exactly equal to a float64
  reference; with a summed output the gradients within 1e-6 of the plain
  conv's VJP (the JAX test's bound), and with a random cotangent within
  1e-5 of each operand's largest |g| of JAX's;
- the QAT train forward: feature maps within 0.15 of JAX's std (the
  whole-model int8 bound of tests/test_torch_quantized.py: an upstream
  ulp can flip a code on a .5 boundary), BatchNorm statistics within
  4e-5, the loss within 1e-4 relative;
- one QAT step: gradients within 2e-3 of each leaf's largest |g| of
  JAX's (tests/test_torch_train_step.py's bound). One leaf misses it
  with the stem quantized (no space-to-depth, dynamic scales): stem1's
  BatchNorm scale, whose gradient sum(dy * x_hat) cancels to ~0.04,
  measured 2.7e-3. JAX against itself with the batch's two images
  swapped (the same math, another summation order) differs there by
  5.3e-3, so in that case (`SPREAD_CASES`) that leaf alone
  (`SPREAD_LEAVES`) is held to JAX's own spread instead, and the spread
  to at most `SPREAD_CAP` (1e-2);
- `calibrate(train_mode=True)`: each scale within 1e-5 relative of JAX's.

The whole-model bound fails in one case, (no space-to-depth, static,
96x64): a code on a .5 boundary rounds one way in the port and the other
in JAX (op by op, JAX's x / s at the exit conv's input is -9.5 exactly,
the port's -9.499997; jitted, JAX flips two others inside
FeatureBlock_0), and at this toy width one code moves the feature maps
by up to 1.14 of their std and the loss by 1.8%. That case
(`KNOWN_FLIPS`) is held block by block instead (`assert_blocks`) up to
the exit conv, where the two part: each ConvBlock of the port, fed the
input the port's own forward gave it, against JAX's `ConvBlock` on the
same input, forward within 1e-4 and its VJP for a random cotangent
within 2e-3 of each leaf's largest |g| (the same input makes the same
codes); and its divergence is asserted as measured, so a change in it
shows.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models import quantized as Q
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.models.yolo import int8_ste_conv as j_ste
from yolov3_tpu.models.yolo import int8_ste_conv_static as j_ste_static
from yolov3_tpu.ops.loss import compute_loss
from yolov3_tpu_torch import train
from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models import quantized as TQ
from yolov3_tpu_torch.models import yolo as Y
from yolov3_tpu_torch.ops import quant
from yolov3_tpu_torch.ops.kernels._conv_q import same_pads
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils import checkpoint as ckpt
from yolov3_tpu_torch.utils.checkpoint import flax_path, params_to_jax

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             compute_dtype="float32")
BATCH = 2
GRAD_BOUND = 2e-3
# (space-to-depth stem, static scales, H, W): every mode, and H != W
# (tests/test_nonsquare.py) in both orientations
CASES = [(True, False, 64, 64), (False, False, 64, 64), (True, True, 64, 64),
         (False, True, 96, 64), (True, False, 64, 96)]
# the case whose whole-model forward diverges from JAX's through a code on
# a .5 boundary (see above): (the block where they part, the feature
# maps' largest error over their std)
KNOWN_FLIPS = {(False, True, 96, 64): ("Darknet53_0/ConvBlock_2", 1.14)}
# the case whose step gradients are held to JAX's own spread on named
# leaves (see above), and that spread's cap, of each leaf's largest |g|
SPREAD_CASES = {(False, False, 64, 64)}
SPREAD_LEAVES = ("params/Darknet53_0/ConvBlock_0/BatchNorm_0/scale",)
SPREAD_CAP = 1e-2
DN = ("NHWC", "HWIO", "NHWC")


def make_batch(h=64, w=64, seed=0):
    from yolov3_tpu.data.encoder import encode_boxes
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, h, w, 3).astype(np.float32)
    grids = [[], [], []]
    for b in range(BATCH):
        boxes = np.array([[8 + 20 * b, 8, 20, 24, b % 2],
                          [30, 34 - 10 * b, 28, 16, 1]], np.int32)
        for g, grid in zip(grids, encode_boxes(boxes, (h, w, 3),
                                               SMALL["anchors"], 2)):
            g.append(grid)
    return (images, *[np.stack(g) for g in grids])


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix):
    return {"/".join([prefix] + [p.key for p in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_grads(model):
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach().numpy()
        out[flax_path(name)] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return out


def jconv(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                                         DN))


# --- one STE conv ------------------------------------------------------------

CONVS = [(k, s, size) for k, s in ((1, 1), (3, 1), (3, 2))
         for size in (8, 9)]


def conv_case(k, size, seed=0):
    rng = np.random.RandomState(seed + 10 * k + size)
    x = rng.randn(2, size, size + 2, 16).astype(np.float32)
    w = rng.randn(k, k, 16, 24).astype(np.float32)
    return x, w, torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("k,stride,size", CONVS)
def test_int8_conv_sums_exact(k, stride, size):
    """Both of the port's routes (the CPU's float64 conv and the card's
    im2col for `torch._int_mm`, run here on the CPU) equal JAX's int32
    conv of the same codes, and a float64 reference."""
    rng = np.random.RandomState(size + k)
    qx = rng.randint(-127, 128, (2, size, size + 3, 16)).astype(np.int8)
    qw = rng.randint(-127, 128, (k, k, 16, 24)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(qx), jnp.asarray(qw), (stride, stride), "SAME",
        dimension_numbers=jax.lax.conv_dimension_numbers(qx.shape, qw.shape,
                                                         DN),
        preferred_element_type=jnp.int32))
    x_t = torch.from_numpy(qx)
    w_t = torch.from_numpy(qw.transpose(3, 2, 0, 1).copy())
    ref = np.asarray(jconv(jnp.asarray(qx, jnp.float32),
                           jnp.asarray(qw, jnp.float32), stride))
    np.testing.assert_array_equal(want, ref.astype(np.int64))
    got = quant.int8_conv_sums(x_t, w_t, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    pads = (same_pads(size, k, stride) + same_pads(size + 3, k, stride))
    np.testing.assert_array_equal(
        quant._int_mm_sums(x_t, w_t, stride, pads).numpy(), want)


@pytest.mark.parametrize("k,stride,size", CONVS)
def test_ste_conv_matches_jax(k, stride, size):
    x, w, w_t = conv_case(k, size)
    want = np.asarray(j_ste(jnp.asarray(x), jnp.asarray(w),
                            (stride, stride), "SAME", jnp.float32, None))
    xt = torch.from_numpy(x).requires_grad_()
    wt = w_t.clone().requires_grad_()
    got = Y.int8_ste_conv(xt, wt, stride, torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # a random cotangent: JAX's straight-through gradients
    dy = np.random.RandomState(size).randn(*want.shape).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(j_ste(
        a, b, (stride, stride), "SAME", jnp.float32, None) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    (got * torch.from_numpy(dy)).sum().backward()
    for g, j in ((xt.grad.numpy(), gx),
                 (wt.grad.numpy().transpose(2, 3, 1, 0), gw)):
        j = np.asarray(j)
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * np.abs(j).max())
    # a summed output: exactly the plain conv's gradients
    xt.grad = wt.grad = None
    Y.int8_ste_conv(xt, wt, stride, torch.float32).sum().backward()
    xp, wp = (torch.from_numpy(x).requires_grad_(),
              w_t.clone().requires_grad_())
    Y.conv2d_same(xp, wp, None, stride).sum().backward()
    for a, b in ((xt.grad, xp.grad), (wt.grad, wp.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_static_conv_equals_dynamic_at_the_true_scale():
    """tests/test_int8_train.py:122-147: bit-equal forward, the plain
    conv's gradients, zero gradient to the scale; and JAX's forward."""
    x, w, w_t = conv_case(3, 8)
    sx = np.float32(np.abs(x).max() / 127.0)
    xt = torch.from_numpy(x).requires_grad_()
    wt = w_t.clone().requires_grad_()
    st = torch.tensor(sx).requires_grad_()
    dyn = Y.int8_ste_conv(torch.from_numpy(x), w_t, 1, torch.float32)
    got = Y.int8_ste_conv_static(xt, wt, st, 1, torch.float32)
    assert torch.equal(got, dyn)
    want = j_ste_static(jnp.asarray(x), jnp.asarray(w), jnp.float32(sx),
                        (1, 1), "SAME", jnp.float32, None)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    xp, wp = (torch.from_numpy(x).requires_grad_(),
              w_t.clone().requires_grad_())
    Y.conv2d_same(xp, wp, None, 1).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), wp.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float(st.grad) == 0.0


def test_static_conv_saturates():
    """tests/test_int8_train.py:148-155: a too-small frozen scale clips
    at +-127."""
    x = torch.full((1, 4, 4, 8), 10.0)
    w = torch.eye(8).reshape(8, 8, 1, 1)
    y = Y.int8_ste_conv_static(x, w, torch.tensor(0.01), 1, torch.float32)
    np.testing.assert_allclose(y.numpy(), 127 * 0.01, rtol=1e-5)


# --- the QAT model -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_weights():
    """One JAX `init` of the plain model: every case's weights, since no
    mode and no H, W changes the parameter or statistics trees."""
    jm = JYoloV3(JConfig(**SMALL))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)),
                                  train=False))(jax.random.PRNGKey(0))
    return host(v["params"]), host(v["batch_stats"])


def jax_init(s2d, static, h=64, w=64):
    return _jax_init(s2d, static, h, w)


@functools.lru_cache(maxsize=None)
def _jax_init(s2d, static, h, w):
    """The case's JAX model on `jax_weights` (its own `init`'s trees, by
    shape, are checked equal to them), the batch and, under static QAT,
    the scales of JAX's `calibrate(train_mode=True)` on it."""
    kw = dict(SMALL, img_size=(h, w, 3), stem_space_to_depth=s2d,
              int8_train=True, int8_train_static=static)
    jcfg = JConfig(**kw)
    jm = JYoloV3(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, h, w, 3)),
                                              train=False),
                            jax.random.PRNGKey(0))
    params, stats = jax_weights()
    for tree, want in ((params, shapes["params"]),
                       (stats, shapes["batch_stats"])):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(want))
        assert all(a.shape == b.shape for a, b in zip(
            jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)))
    batch = make_batch(h, w)
    qs = None
    if static:
        scales = Q.calibrate(params, stats, jcfg, batch[0], train_mode=True)
        qs = host(Q.scales_to_collection(scales, shapes["quant_scales"]))
    return dict(cfg=ModelConfig(**kw), jcfg=jcfg, jm=jm, params=params,
                stats=stats, qs=qs, batch=batch)


def jax_case(s2d, static, h=64, w=64):
    return _jax_case(s2d, static, h, w)


@functools.lru_cache(maxsize=None)
def _jax_case(s2d, static, h, w):
    """`jax_init` and one jitted JAX train forward with its loss and
    gradients on the batch: feature maps, batch statistics, loss,
    gradients; for the case that needs it (module docstring), JAX's own
    gradients with the batch's two images swapped."""
    case = dict(jax_init(s2d, static, h, w))
    jcfg, jm, batch = case["jcfg"], case["jm"], case["batch"]
    fixed = {"batch_stats": case["stats"]}
    if case["qs"] is not None:
        fixed["quant_scales"] = case["qs"]

    def loss_fn(p, b):
        fms, mutated = jm.apply(dict(fixed, params=p), b[0], train=True,
                                mutable=["batch_stats"])
        loss = compute_loss(fms, b[1:], jcfg.anchors, jcfg.number_classes,
                            jcfg.strides).total / float(BATCH)
        return loss, (fms, mutated["batch_stats"])

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (fms, new_stats)), g = run(case["params"], batch)
    spread = None
    if (s2d, static, h, w) in SPREAD_CASES:
        swapped = tuple(np.ascontiguousarray(a[::-1]) for a in batch)
        spread = flat(host(run(case["params"], swapped)[1]), "params")
    case.update(fms=[np.asarray(f) for f in fms], loss=float(loss),
                stats_after=flat(host(new_stats), "s"),
                grads=flat(host(g), "params"), spread=spread)
    return case


def port_state(case):
    return T.create_train_state(case["cfg"], TrainConfig(), device="cpu",
                                params=case["params"],
                                batch_stats=case["stats"],
                                quant_scales=case["qs"])


def tensors(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def subtree(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def assert_blocks(case, last):
    """Each ConvBlock up to `last`, in forward order, on the input the
    port's forward gave it: the port's block against JAX's `ConvBlock`,
    forward and VJP (module docstring)."""
    import copy

    from yolov3_tpu.models.yolo import ConvBlock as JConvBlock
    state = port_state(case)
    inputs = {}
    for name, m in state.model.named_modules():
        if isinstance(m, Y.ConvBlock):
            m.register_forward_pre_hook(
                lambda mod, a, n=name: inputs.__setitem__(
                    n, a[0].detach().clone()) and None)
    state.model(torch.from_numpy(case["batch"][0]))
    cfg, rng = case["cfg"], np.random.RandomState(1)
    for name, x in inputs.items():
        blk = copy.deepcopy(state.model.get_submodule(name))
        path = ckpt.flax_module_path(name)
        variables = {"params": subtree(case["params"], path),
                     "batch_stats": subtree(case["stats"], path)}
        if hasattr(blk, "act_scale"):
            variables["quant_scales"] = subtree(case["qs"], path)
        jb = JConvBlock(blk.conv.weight.shape[0], blk.conv.weight.shape[-1],
                        stride=blk.stride, alpha=cfg.leaky_relu_alpha,
                        bn_epsilon=cfg.bn_epsilon, dtype=jnp.float32,
                        int8_ste=blk.int8_ste,
                        int8_static=hasattr(blk, "act_scale"))

        def f(xx, p, jb=jb, variables=variables):
            return jb.apply(dict(variables, params=p), xx, train=True,
                            mutable=["batch_stats"])[0]
        want, vjp = jax.vjp(f, x.numpy(), variables["params"])
        ct = rng.randn(*want.shape).astype(np.float32)
        want_dx, want_dp = vjp(ct)
        xt = x.clone().requires_grad_()
        got = blk(xt)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
        (got * torch.from_numpy(ct)).sum().backward()
        got_dp = port_grads(blk)
        grads = {"x": (xt.grad.numpy(), want_dx)}
        grads.update((k, (got_dp[k], w))
                     for k, w in flat(want_dp, "params").items())
        for k, (g, w) in grads.items():
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_BOUND * np.abs(w).max(),
                                       err_msg=f"{path} {k}")
        if path == last:
            return
    raise AssertionError(f"no block {last}")


def assert_forward(case):
    state = port_state(case)
    got = state.model(torch.from_numpy(case["batch"][0]))
    for g, w in zip(got, case["fms"]):
        d = np.abs(g.detach().numpy() - w)
        assert d.max() <= 0.15 * w.std(), (d.max(), w.std())
    got_stats = flat(params_to_jax(state.model.state_dict())[1], "s")
    assert got_stats.keys() == case["stats_after"].keys()
    for k, w in case["stats_after"].items():
        np.testing.assert_allclose(got_stats[k], w, rtol=4e-5, atol=4e-5,
                                   err_msg=k)


def assert_step(case):
    state = port_state(case)
    b = tensors(case["batch"])
    loss, _ = T._loss(state.model, case["cfg"], TrainConfig(), BATCH, b[0],
                      b[1:])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), case["loss"], rtol=1e-4)
    got, want = port_grads(state.model), case["grads"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = np.abs(w).max()
        bound = GRAD_BOUND * scale
        if case["spread"] is not None and k in SPREAD_LEAVES:
            own = np.abs(case["spread"][k] - w).max()
            assert own <= SPREAD_CAP * scale, (k, own, scale)
            bound = max(bound, own)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=bound, err_msg=k)
    return float(loss.detach())


@pytest.mark.parametrize("s2d,static,h,w", CASES)
def test_qat_train_forward_matches_jax(s2d, static, h, w):
    case = jax_case(s2d, static, h, w)
    if (s2d, static, h, w) not in KNOWN_FLIPS:
        assert_forward(case)
        return
    last, divergence = KNOWN_FLIPS[s2d, static, h, w]
    assert_blocks(case, last)
    got = port_state(case).model(torch.from_numpy(case["batch"][0]))
    worst = max(float(np.abs(g.detach().numpy() - w).max() / w.std())
                for g, w in zip(got, case["fms"]))
    assert worst == pytest.approx(divergence, abs=0.01)


@pytest.mark.parametrize("s2d,static,h,w", CASES)
def test_qat_step_gradients_match_jax(s2d, static, h, w):
    case = jax_case(s2d, static, h, w)
    if (s2d, static, h, w) not in KNOWN_FLIPS:
        assert_step(case)
        return
    # the blocks' VJPs are held in the forward test; the step's loss moves
    # with the flipped code
    state = port_state(case)
    b = tensors(case["batch"])
    loss, _ = T._loss(state.model, case["cfg"], TrainConfig(), BATCH, b[0],
                      b[1:])
    assert abs(float(loss) / case["loss"] - 1) == pytest.approx(0.018,
                                                                abs=0.002)


def test_qat_fields_change_the_step():
    """The fault the QAT port repairs: with `int8_train` (alone or with
    `int8_train_static`) the first step's loss is the QAT one, not the
    plain one; `int8_train_static` alone changes nothing, as in JAX."""
    case = jax_case(True, False)
    b = tensors(case["batch"])

    def first_loss(**kw):
        cfg = ModelConfig(**dict(SMALL, **kw))
        state = T.create_train_state(cfg, TrainConfig(), device="cpu",
                                     params=case["params"],
                                     batch_stats=case["stats"])
        _, m = T.make_train_step(cfg, TrainConfig(), BATCH)(state, b, 1e-4)
        return float(m["loss"])

    plain = first_loss()
    dynamic = first_loss(int8_train=True)
    assert dynamic != plain
    np.testing.assert_allclose(dynamic, case["loss"], rtol=1e-4)
    assert first_loss(int8_train=True, int8_train_static=True) != plain
    assert first_loss(int8_train_static=True) == plain


def test_eval_path_unaffected():
    """tests/test_int8_train.py::test_eval_path_unaffected: the QAT
    model's eval forward is the plain one, bit for bit."""
    case = jax_init(True, True)
    x = torch.from_numpy(case["batch"][0])
    out = []
    for kw in ({}, dict(int8_train=True, int8_train_static=True)):
        model = Y.YoloV3(ModelConfig(**dict(SMALL, **kw)))
        model.load_state_dict(ckpt.params_from_jax(
            case["params"], case["stats"], model.config, None))
        with torch.no_grad():
            out.append([f.numpy() for f in model.eval()(x)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


# --- the static scales -------------------------------------------------------

@pytest.mark.parametrize("s2d", [True, False])
def test_static_scale_keys_match_jax(s2d):
    """The `act_scale` buffers are JAX's `quant_scales` leaves, path for
    path (no stem1 scale under space-to-depth), each a key of both
    packages' `calibrate`; the weight bridge carries them both ways
    (tests/test_int8_train.py:157-177)."""
    case = jax_init(s2d, True)
    state = port_state(case)
    want = flat(case["qs"], "quant_scales")
    got = {flax_path(k): v.numpy() for k, v in state.model.state_dict().items()
           if k.endswith(".act_scale")}
    assert got.keys() == want.keys() and len(got) > 10
    assert ("quant_scales/Darknet53_0/ConvBlock_0/act_scale" in got) != s2d
    for k, w in want.items():
        assert got[k] == w, k
    assert flat(ckpt.scales_to_jax(state.model.state_dict()),
                "quant_scales").keys() == want.keys()
    jcfg = JConfig(**dict(SMALL, stem_space_to_depth=s2d))
    cal_j = Q.calibrate(case["params"], case["stats"], jcfg,
                        case["batch"][0], train_mode=True)
    mirror = TQ.build_quantized_model(case["params"], case["stats"],
                                      case["cfg"], "cpu", kernels={})
    cal = TQ.calibrate(mirror, torch.from_numpy(case["batch"][0]),
                       train_mode=True)
    assert cal.keys() == cal_j.keys()
    assert {k.split("/", 1)[1].rsplit("/", 1)[0] for k in got} <= cal.keys()


def test_calibrate_train_mode_matches_jax_and_leaves_the_model():
    """`calibrate(train_mode=True)` (quantized.py:1288-1322): each scale
    within 1e-5 relative of JAX's on the same weights; every parameter
    and running statistic bit-unchanged; `scales_to_buffers` writes the
    scales and raises KeyError for a declared scale without a value."""
    case = jax_init(True, True)
    # JAX's weights, carried into the port; a batch whose statistics are
    # far from the running ones, so the two calibrations differ
    params = case["params"]
    x = case["batch"][0] * 3.0 + 0.5
    want = Q.calibrate(params, case["stats"], JConfig(**SMALL), x,
                       train_mode=True)
    plain = Q.calibrate(params, case["stats"], JConfig(**SMALL), x)
    model = TQ.build_quantized_model(params, case["stats"], case["cfg"],
                                     "cpu", kernels={})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = TQ.calibrate(model, torch.from_numpy(x), train_mode=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert any(abs(want[k] - plain[k]) > 1e-3 * plain[k] for k in want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    state = port_state(case)
    TQ.scales_to_buffers(got, state.model)
    for name, m in state.model.named_modules():
        if hasattr(m, "act_scale"):
            key = ckpt.flax_module_path(name)
            assert float(m.act_scale) == np.float32(got[key])
    with pytest.raises(KeyError, match="no calibrated scale"):
        TQ.scales_to_buffers({k: v for k, v in got.items()
                              if "YoloBlock_2" not in k}, state.model)


@pytest.mark.parametrize("static", [False, True])
def test_qat_loss_falls(static):
    """tests/test_int8_train.py:179-238: eight steps on one batch at lr
    1e-3, finite and falling, the static scales calibrated first."""
    case = jax_init(True, static)
    state = port_state(case)
    if static:
        TQ.qat_recalibrator(case["cfg"], "cpu")(
            state.model, torch.from_numpy(case["batch"][0]))
    step = T.make_train_step(case["cfg"], TrainConfig(), BATCH)
    losses = [float(step(state, tensors(case["batch"]), 1e-3)[1]["loss"])
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- the trainer -------------------------------------------------------------

@pytest.fixture
def stores(tmp_path, monkeypatch):
    from test_torch_train import write_store
    monkeypatch.setattr(train, "ModelConfig", functools.partial(
        ModelConfig, block_count=1, filter_count=32))
    write_store(tmp_path / "train.ydb", 8, 0)
    write_store(tmp_path / "test.ydb", 4, 1)
    return tmp_path


def cli(tmp, out, *extra, epochs=2):
    return ["--train_database", str(tmp / "train.ydb"),
            "--test_database", str(tmp / "test.ydb"),
            "--output_dir", str(tmp / out), "--batch_size", "2",
            "--test_every_n_steps", "2", "--max_epochs", str(epochs),
            "--anchors", "16x16,32x32", "--compute_dtype", "float32",
            "--use_augmentation", "0", "--device", "cpu", *extra]


@pytest.mark.parametrize("flags", [["--int8_train", "1"],
                                   ["--int8_train", "1", "--int8_static",
                                    "1"]])
def test_trainer_qat_flags(stores, monkeypatch, flags):
    """The CLI trains with QAT for 2 epochs (static: one recalibration an
    epoch, the checkpoint holding the scales), resumes, and exports a
    model whose config has both flags cleared."""
    static = "--int8_static" in flags
    calls, made = [], []
    make = train.qat_recalibrator

    def counting(*args):
        recal = make(*args)

        def run(model, images):
            calls.append(images.shape[0])
            return recal(model, images)
        return run
    monkeypatch.setattr(train, "qat_recalibrator", counting)
    orig = T.create_train_state

    def spy(cfg, *a, **kw):
        made.append(cfg)
        return orig(cfg, *a, **kw)
    monkeypatch.setattr(train, "create_train_state", spy)
    train.main(cli(stores, "out", *flags, epochs=1))
    out = str(stores / "out")
    assert made[-1].int8_train and made[-1].int8_train_static == static
    assert calls == ([2] if static else [])
    saved = ckpt._load_checkpoint(out, "cpu")["model"]
    scales = {k: float(v) for k, v in saved.items()
              if k.endswith(".act_scale")}
    assert bool(scales) == static
    assert all(np.isfinite(v) and v > 0 and v != 1.0
               for v in scales.values())
    train.main(cli(stores, "out", *flags, "--resume", epochs=2))
    assert calls == ([2, 2] if static else [])
    with open(os.path.join(out, "test_loss.csv")) as fh:
        assert len([v for v in fh if v.strip()]) == 2
    _, _, cfg = ckpt.load_model(os.path.join(out, "saved_model"))
    assert not cfg.int8_train and not cfg.int8_train_static


def test_trainer_static_flag_alone_is_a_plain_run(stores, monkeypatch):
    """`--int8_static 1` without `--int8_train 1` passes no overrides
    (yolov3_tpu/train.py:461-464): the model is the plain run's, with no
    scales and no recalibration. (The reader workers seed from their pid,
    so two runs' weights are not compared.)"""
    made = []
    orig = T.create_train_state

    def spy(cfg, *a, **kw):
        made.append(cfg)
        return orig(cfg, *a, **kw)
    monkeypatch.setattr(train, "create_train_state", spy)
    monkeypatch.setattr(train, "qat_recalibrator", None)
    train.main(cli(stores, "static", "--int8_static", "1", epochs=1))
    plain = train.ModelConfig(img_size=(64, 64, 3), number_classes=2,
                              anchors=((16.0, 16.0), (32.0, 32.0)),
                              compute_dtype="float32")
    assert made == [plain]
    saved = ckpt._load_checkpoint(str(stores / "static"), "cpu")["model"]
    assert saved.keys() == Y.YoloV3(plain).state_dict().keys()
