"""The port's train and eval steps (`yolov3_tpu_torch/parallel/
train_step.py`, the train-mode forward of `models/yolo.py`) against the
JAX package's on the CPU: 64 px, block_count 1, filter_count 32, f32
(tests/test_train_step.py's size), both sides from one JAX `init`
through `params_from_jax`, the same seeded batch.

Tolerances, each from the f32 summation order (XLA's and oneDNN's
convolutions and reductions add in different orders; nothing else
differs):
- feature maps rtol 1e-4 / atol 1e-4 (measured: 4e-5 on values up to
  5) and BatchNorm statistics rtol 1e-5 / atol 1e-6 (measured: 1.2e-7);
- gradients within 2e-3 of each leaf's largest |g| (measured: 8.9e-4,
  on a BatchNorm scale, whose gradient sum(dy * x_hat) cancels; the JAX
  package's own two stems, the same math, differ by 3.7e-4 there);
- Adam fed JAX's gradients: m and v rtol 1e-6 plus 1e-6 of the leaf's
  largest value (lerp against a multiply-add; m's terms of either sign
  cancel), parameters rtol 1e-6 plus 1e-5 of lr per step: optax
  takes the bias correction 1 - b2^t in f32, where b2 = 0.999 rounds
  1.3e-5 off in 1 - b2, torch in double, so the update u differs by up
  to ~7e-6 relative;
- a whole step: loss and metrics rtol 1e-5; parameters where |g| is not
  tiny (Adam's first step moves every parameter by about lr * sign(g),
  so where |g| is within rounding of 0 the sign may differ) within 1e-3
  of lr.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.config import TrainConfig as JTrainConfig
from yolov3_tpu.data.encoder import encode_boxes
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.ops.loss import compute_loss as j_compute_loss
from yolov3_tpu.parallel import (make_eval_step as j_make_eval_step,
                                 make_mesh,
                                 make_train_step as j_make_train_step,
                                 replicate_to_mesh, shard_batch)
from yolov3_tpu.parallel.train_step import TrainState as JTrainState
from yolov3_tpu.parallel.train_step import _loss_and_metrics, make_optimizer
from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.models.yolo import YoloV3
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils.checkpoint import (adam_state_from_jax,
                                               flax_path, params_to_jax,
                                               set_adam_state)

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             compute_dtype="float32")
BATCH = 2
LR = 1e-4
# the leaves held to JAX's own spread at H != W, and that spread's cap,
# relative to each leaf's largest |g| (test_nonsquare_step_matches_jax)
SPREAD_LEAVES = ("params/Darknet53_0/ConvBlock_0/BatchNorm_0/scale",
                 "params/Darknet53_0/FeatureBlock_0/ConvBlock_0/Conv_0/kernel")
SPREAD_CAP = 1e-2


def make_batch(seed=0, h=64, w=64):
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


def to_torch(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join([prefix] + [p.key for p in path])] = np.asarray(leaf)
    return out


def port_grads(model):
    """Parameter gradients keyed by Flax path, kernels HWIO."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach().numpy()
        out[flax_path(name)] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
    return out


@pytest.fixture(scope="module")
def init():
    model = JYoloV3(JConfig(**SMALL))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    return host(variables["params"]), host(variables["batch_stats"])


def port_state(init, tcfg=None, **kw):
    cfg = ModelConfig(**dict(SMALL, **kw))
    return cfg, T.create_train_state(cfg, tcfg or TrainConfig(), device="cpu",
                                     params=init[0], batch_stats=init[1])


@pytest.mark.parametrize("s2d", [True, False])
def test_train_forward_and_batch_stats_match_jax(init, s2d):
    params, stats = init
    jmodel = JYoloV3(JConfig(**dict(SMALL, stem_space_to_depth=s2d)))
    images = make_batch()[0]
    want, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, images)
    _, state = port_state(init, stem_space_to_depth=s2d)
    got = state.model(torch.from_numpy(images))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)
    got_stats = flat(params_to_jax(state.model.state_dict())[1], "s")
    want_stats = flat(host(mutated["batch_stats"]), "s")
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_gradients_match_jax(init, jax_grads):
    want_loss, want = jax_grads
    cfg, state = port_state(init)
    batch = to_torch(make_batch())
    loss, _ = T._loss(state.model, cfg, TrainConfig(), BATCH, batch[0],
                      batch[1:])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = port_grads(state.model)
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2e-3 * scale, err_msg=k)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_nonsquare_step_matches_jax(init, hw):
    """H != W (tests/test_nonsquare.py): one train-mode forward's feature
    maps and BatchNorm statistics, the loss and the gradients against
    JAX's, at the bounds above. Two leaves (`SPREAD_LEAVES`) are held to
    the larger of 2e-3 and JAX's own spread when the batch's two images
    are swapped (the same math, another summation order), and that spread
    to at most `SPREAD_CAP`: stem1's BatchNorm scale, a one-channel
    sum(dy * x_hat) that cancels to ~0.02, and the two-weight 1x1 kernel
    fed by that channel (measured at 96x64, of each leaf's largest |g|:
    the port 5.5e-3 and 2.03e-3, JAX's own spread 6.3e-3 and 3.7e-3)."""
    params, stats = init
    h, w = hw
    jcfg = JConfig(**dict(SMALL, img_size=(h, w, 3)))
    jmodel = JYoloV3(jcfg)
    batch = make_batch(0, h, w)

    def loss_fn(p, b):
        fms, mutated = jmodel.apply({"params": p, "batch_stats": stats}, b[0],
                                    train=True, mutable=["batch_stats"])
        loss = j_compute_loss(fms, b[1:], jcfg.anchors, jcfg.number_classes,
                              jcfg.strides).total / float(BATCH)
        return loss, (fms, mutated["batch_stats"])

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (want_loss, (want_fms, want_stats)), want = run(params, batch)
    # JAX against itself with the batch's two images swapped
    spread = flat(host(run(params, tuple(np.ascontiguousarray(a[::-1])
                                         for a in batch))[1]), "params")
    cfg, state = port_state(init, img_size=(h, w, 3))
    b = to_torch(batch)
    fms = state.model(b[0])
    for g, wf in zip(fms, want_fms):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wf),
                                   rtol=1e-4, atol=1e-4)
    got_stats = flat(params_to_jax(state.model.state_dict())[1], "s")
    for k, ws in flat(host(want_stats), "s").items():
        np.testing.assert_allclose(got_stats[k], ws, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    loss = T.compute_loss(fms, b[1:], cfg.anchors, cfg.number_classes,
                          cfg.strides).total / float(BATCH)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = port_grads(state.model)
    for k, wg in flat(host(want), "params").items():
        scale = np.abs(wg).max()
        atol = 2e-3 * scale
        if k in SPREAD_LEAVES:
            own = np.abs(spread[k] - wg).max()
            assert own <= SPREAD_CAP * scale, (own, scale)
            atol = max(atol, own)
        np.testing.assert_allclose(got[k], wg, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_fed_jax_gradients_matches_optax(init, steps):
    """Adam alone: the same gradients into optax's `scale_by_adam` (the
    JAX step's optimizer) and the port's, at the warm-up lr."""
    tcfg = TrainConfig()
    lr = tcfg.learning_rate / tcfg.warmup_lr_divisor
    params = init[0]
    opt = optax.scale_by_adam(b1=tcfg.adam_b1, b2=tcfg.adam_b2,
                              eps=tcfg.adam_eps)
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    _, state = port_state(init)
    by_path = {flax_path(n): p for n, p in state.model.named_parameters()}
    rng = np.random.RandomState(steps)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-8, 0)
                       ).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        for k, g in flat(grads, "params").items():
            p = by_path[k]
            p.grad = torch.from_numpy(
                g.transpose(3, 2, 0, 1).copy() if g.ndim == 4 else g)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
    want = {"p": flat(host(params), "params"),
            "m": flat(host(opt_state.mu), "params"),
            "v": flat(host(opt_state.nu), "params")}
    for k, p in by_path.items():
        st = state.optimizer.state[p]
        for key, t in (("p", p), ("m", st["exp_avg"]),
                       ("v", st["exp_avg_sq"])):
            g = t.detach().numpy()
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
            # a parameter moves by lr * u a step, u within 1e-5 (the
            # bias correction) of optax's; m's sum of rounded terms may
            # cancel
            w = want[key][k]
            atol = (1e-5 * lr * steps if key == "p"
                    else 1e-6 * np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol,
                                       err_msg=f"{key} {k}")


def test_adam_state_bridge_matches_optax(init):
    """optax's Adam state after two steps, carried into the port's Adam by
    `adam_state_from_jax` / `set_adam_state`, then one more step from the
    same gradients on both sides: the parameters and moments agree at
    test_adam_fed_jax_gradients_matches_optax's bounds for one step."""
    tcfg = TrainConfig()
    lr = tcfg.learning_rate
    opt = optax.scale_by_adam(b1=tcfg.adam_b1, b2=tcfg.adam_b2,
                              eps=tcfg.adam_eps)
    params = init[0]
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    rng = np.random.RandomState(7)

    def draw():
        return jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-6, 0)
                       ).astype(np.float32), params)

    def apply(params, opt_state, grads):
        updates, opt_state = update(grads, opt_state, params)
        return optax.apply_updates(params, jax.tree_util.tree_map(
            lambda u: -lr * u, updates)), opt_state

    for _ in range(2):
        params, opt_state = apply(params, opt_state, draw())
    params, opt_state = host(params), host(opt_state)
    cfg, state = port_state((params, init[1]))
    set_adam_state(state.optimizer, state.model, adam_state_from_jax(
        opt_state.mu, opt_state.nu, opt_state.count, cfg))
    grads = draw()
    params, opt_state = apply(params, opt_state, grads)
    by_path = {flax_path(n): p for n, p in state.model.named_parameters()}
    for k, g in flat(grads, "params").items():
        by_path[k].grad = torch.from_numpy(
            g.transpose(3, 2, 0, 1).copy() if g.ndim == 4 else g)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    want = {"p": flat(host(params), "params"),
            "m": flat(host(opt_state.mu), "params"),
            "v": flat(host(opt_state.nu), "params")}
    assert int(opt_state.count) == 3
    for k, p in by_path.items():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 3
        for key, t in (("p", p), ("m", st["exp_avg"]),
                       ("v", st["exp_avg_sq"])):
            got = t.detach().numpy()
            got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
            w = want[key][k]
            atol = 1e-5 * lr if key == "p" else 1e-6 * np.abs(w).max()
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=atol,
                                       err_msg=f"{key} {k}")


@pytest.fixture(scope="module")
def jax_grads(init):
    """JAX's loss and parameter gradients on the batch (train mode)."""
    params, stats = init
    jcfg, batch = JConfig(**SMALL), make_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: _loss_and_metrics(JYoloV3(jcfg), jcfg, JTrainConfig(),
                                    BATCH, p, stats, batch[0], batch[1:],
                                    True), has_aux=True))(params)
    return float(loss), flat(host(grads), "params")


@pytest.fixture(scope="module")
def jax_step(init):
    """The JAX package's jitted train and eval steps on a one-device
    mesh, from the shared init."""
    params, stats = init
    jmodel, jcfg = JYoloV3(JConfig(**SMALL)), JConfig(**SMALL)
    tcfg, mesh = JTrainConfig(), make_mesh(n_devices=1)
    state0 = host(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats,
                              opt_state=make_optimizer(tcfg).init(params)))
    batch = make_batch()
    step = j_make_train_step(jmodel, jcfg, tcfg, mesh, BATCH)
    new, metrics = step(replicate_to_mesh(state0, mesh),
                        shard_batch(batch, mesh), jnp.float32(LR))
    evaluate = j_make_eval_step(jmodel, jcfg, tcfg, mesh, BATCH)
    eval_metrics = evaluate(replicate_to_mesh(state0, mesh),
                            shard_batch(batch, mesh))
    return (host(new), {k: float(v) for k, v in metrics.items()},
            {k: float(v) for k, v in eval_metrics.items()})


def test_whole_train_step_matches_jax(init, jax_grads, jax_step):
    (new, want, _), grads = jax_step, jax_grads[1]
    cfg, state = port_state(init)
    step = T.make_train_step(cfg, TrainConfig(), BATCH)
    state, metrics = step(state, to_torch(make_batch()), LR)
    assert state.step == 1 and int(new.step) == 1
    assert set(metrics) == set(want) == {
        "loss", "loss_sum", "loss_xy", "loss_wh", "loss_obj", "loss_class"}
    for k in want:
        np.testing.assert_allclose(float(metrics[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    got_params = flat(params_to_jax(state.model.state_dict())[0], "params")
    want_params = flat(new.params, "params")
    for k, w in want_params.items():
        sure = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
        np.testing.assert_allclose(got_params[k][sure], w[sure], rtol=0,
                                   atol=1e-3 * LR, err_msg=k)
    got_stats = flat(params_to_jax(state.model.state_dict())[1], "s")
    for k, w in flat(new.batch_stats, "s").items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_eval_step_matches_jax(init, jax_step):
    want = jax_step[2]
    cfg, state = port_state(init)
    got = T.make_eval_step(cfg, TrainConfig(), BATCH)(state,
                                                      to_torch(make_batch()))
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


def snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def assert_same(a, b):
    for x, y in zip(a[0].values(), b[0].values()):
        assert torch.equal(x, y)
    assert len(a[1]["state"]) == len(b[1]["state"])
    for k, v in a[1]["state"].items():
        for name, t in v.items():
            assert torch.equal(t, b[1]["state"][k][name])
    assert a[2] == b[2]


def test_eval_step_keeps_state_and_reprepares(init):
    """The eval step changes no state and restores the model's mode; after
    a train step it serves the new weights: with the fused 1x1 (whose
    constants are bf16 copies, stale after a step) its loss equals a
    model freshly loaded from the state's weights."""
    cfg, state = port_state(init, use_pallas_pointwise=True)
    batch = to_torch(make_batch())
    evaluate = T.make_eval_step(cfg, TrainConfig(), BATCH)
    before = snapshot(state)
    m0 = evaluate(state, batch)
    assert state.model.training
    assert_same(before, snapshot(state))

    state, _ = T.make_train_step(cfg, TrainConfig(), BATCH)(state, batch, LR)
    after = snapshot(state)
    m1 = evaluate(state, batch)
    assert_same(after, snapshot(state))
    fresh = YoloV3(cfg)
    fresh.load_state_dict(state.model.state_dict())
    fresh.eval()
    with torch.no_grad():
        want, _ = T._loss(fresh, cfg, TrainConfig(), BATCH, batch[0],
                          batch[1:])
    assert float(m1["loss"]) == float(want)
    assert float(m1["loss"]) != float(m0["loss"])


def test_unported_train_config_raises(init):
    """`packed_loss`, a TPU formulation, stays refused; `shard_optimizer`
    is ported (ZeRO-1, tests/test_torch_parallel.py), and over one rank
    its optimizer is Adam itself, whose step is the plain one."""
    with pytest.raises(NotImplementedError, match="packed_loss"):
        T.make_train_step(ModelConfig(**SMALL),
                          TrainConfig(packed_loss=True), BATCH)
    tcfg = TrainConfig(shard_optimizer=True)
    cfg, state = port_state(init, tcfg)
    assert type(state.optimizer) is torch.optim.Adam
    _, plain = port_state(init)
    batch = to_torch(make_batch())
    state, _ = T.make_train_step(cfg, tcfg, BATCH)(state, batch, LR)
    plain, _ = T.make_train_step(cfg, TrainConfig(), BATCH)(plain, batch, LR)
    for a, b in zip(state.model.state_dict().values(),
                    plain.model.state_dict().values()):
        assert torch.equal(a, b)
