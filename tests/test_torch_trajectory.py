"""A short training trajectory, the port against the JAX package (ROADMAP
G1): 10 steps of tests/test_quality_e2e.py's recipe (8 planted 24 px
squares in 64 px images, RandomState(42); 1 block, 32 filters, f32; one
fixed batch; lr 5e-3) from JAX's init, each package on its own state.
Each step's loss and, per scale, the largest |objectness logit| and the
largest wh logit of the cells without an object (the statistics of
scripts/g1_trajectory.py, which runs the same comparison at the 512 px
gate's full depth) are held to JAX's.

The trajectory is chaotic: Adam's first steps move each parameter by
about lr * sign(g), and where g is within rounding of 0 the sign is the
rounding's. JAX against itself, with the batch's order reversed (the
same math in another summation order), parts by up to 4.4e-3 of the
loss and 1.11 on a logit within these 10 steps; the port against JAX by
up to 3.8e-3 and 0.67 (measured on a CPU). So the tolerance is JAX's
own spread: at each step the port's distance from JAX is at most
`FACTOR` times the largest distance of JAX's reversed run up to that
step, plus a floor (1e-5 of the loss, 1e-4 on a logit). A fault in a
step's arithmetic shows at once: at step 1 the port is 6.1e-6 of the
loss from JAX and the reversed run 1.4e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.config import TrainConfig as JTrainConfig
from yolov3_tpu.data.encoder import encode_boxes as j_encode
from yolov3_tpu.data.imaging import zscore_normalize as j_zscore
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.parallel import (make_mesh, make_train_step,
                                 replicate_to_mesh, shard_batch)
from yolov3_tpu.parallel.train_step import TrainState as JTrainState
from yolov3_tpu.parallel.train_step import make_optimizer
from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.data.encoder import encode_boxes
from yolov3_tpu_torch.data.imaging import zscore_normalize
from yolov3_tpu_torch.parallel import train_step as T

SIZE, BOX, N, STEPS, LR = 64, 24, 8, 10, 5e-3
KW = dict(img_size=(SIZE, SIZE, 3), number_classes=1,
          anchors=((24, 24), (12, 12)), block_count=1, filter_count=32,
          compute_dtype="float32")
FACTOR, LOSS_FLOOR, LOGIT_FLOOR = 3.0, 1e-5, 1e-4


def planted():
    rng = np.random.RandomState(42)
    images, gts = [], []
    for _ in range(N):
        img = (rng.rand(SIZE, SIZE, 3) * 40).astype(np.float32)
        x = rng.randint(0, SIZE - BOX)
        y = rng.randint(0, SIZE - BOX)
        img[y:y + BOX, x:x + BOX] += 180 + rng.rand() * 40
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        gts.append(np.array([[x, y, BOX, BOX, 0]], np.float32))
    return images, gts


def batch_of(zscore, encode):
    images, gts = planted()
    grids = [encode(g, KW["img_size"], KW["anchors"], 1) for g in gts]
    return [np.stack([zscore(im.astype(np.float32)) for im in images])] + [
        np.stack([g[i] for g in grids]).astype(np.float32) for i in range(3)]


def stats(fms, labels):
    """Per scale: largest |objectness logit|, largest wh logit where the
    label grid has no object."""
    obj, wh = [], []
    for fm, lab in zip(fms, labels):
        fm = np.asarray(fm, np.float32).reshape(*fm.shape[:3], 2, -1)
        empty = np.asarray(lab)[..., 4] == 0
        obj.append(np.abs(fm[..., 4]).max())
        wh.append(fm[..., 2:4][empty].max())
    return np.array(obj + wh)


def jax_runs(params, stats0, batches):
    """JAX's make_train_step on a one-device mesh, from the init on each
    of `batches`: per step the loss and the statistics of its train-mode
    forward."""
    jcfg = JConfig(**KW)
    jmodel = JYoloV3(jcfg)
    tcfg, mesh = JTrainConfig(batch_size=N), make_mesh(n_devices=1)
    step = make_train_step(jmodel, jcfg, tcfg, mesh, N)
    forward = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"])[0])
    runs = []
    for batch in batches:
        state = replicate_to_mesh(jax.tree_util.tree_map(
            np.asarray, JTrainState(
                step=jnp.zeros((), jnp.int32), params=params,
                batch_stats=stats0,
                opt_state=make_optimizer(tcfg).init(params))), mesh)
        out = []
        for _ in range(STEPS):
            fms = forward(state.params, state.batch_stats, batch[0])
            state, metrics = step(state, shard_batch(tuple(batch), mesh),
                                  jnp.float32(LR))
            out.append((float(metrics["loss"]), stats(fms, batch[1:])))
        runs.append(out)
    return runs


@pytest.fixture(scope="module")
def trajectories():
    """(port, JAX, JAX on the reversed batch) trajectories."""
    jmodel = JYoloV3(JConfig(**KW))
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
    params, stats0 = (jax.tree_util.tree_map(np.asarray, variables[k])
                      for k in ("params", "batch_stats"))
    jbatch = batch_of(j_zscore, j_encode)
    want, rev = jax_runs(params, stats0, [
        jbatch, [np.ascontiguousarray(a[::-1]) for a in jbatch]])

    cfg = ModelConfig(**KW)
    pstate = T.create_train_state(cfg, TrainConfig(batch_size=N),
                                  device="cpu", params=params,
                                  batch_stats=stats0)
    pstep = T.make_train_step(cfg, TrainConfig(batch_size=N), N)
    captured = []
    pstate.model.register_forward_hook(
        lambda m, i, out: captured.__setitem__(slice(None), out))
    pbatch = [torch.from_numpy(a) for a in batch_of(zscore_normalize,
                                                    encode_boxes)]
    got = []
    for _ in range(STEPS):
        pstate, metrics = pstep(pstate, pbatch, LR)
        got.append((float(metrics["loss"]), stats(
            [f.detach().numpy() for f in captured], jbatch[1:])))
    return got, want, rev


def spread_bounds(want, rev, distance, floor):
    """Per step: FACTOR times the largest distance of JAX's reversed run
    from JAX up to that step, plus `floor`."""
    return FACTOR * np.maximum.accumulate(
        [distance(r, w) for r, w in zip(rev, want)]) + floor


def test_losses_follow_jax(trajectories):
    got, want, rev = trajectories
    loss = [w[0] for w in want]
    assert loss[-1] < loss[0]

    def rel(a, b):
        return abs(a[0] - b[0]) / abs(b[0])

    bound = spread_bounds(want, rev, rel, LOSS_FLOOR)
    dist = np.array([rel(g, w) for g, w in zip(got, want)])
    assert (dist <= bound).all(), (dist, bound)


def test_largest_logits_follow_jax(trajectories):
    got, want, rev = trajectories

    def dist(a, b):
        return float(np.abs(a[1] - b[1]).max())

    bound = spread_bounds(want, rev, dist, LOGIT_FLOOR)
    d = np.array([dist(g, w) for g, w in zip(got, want)])
    assert (d <= bound).all(), (d, bound)
