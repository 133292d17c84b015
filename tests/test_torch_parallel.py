"""Multi-device in the port (`yolov3_tpu_torch/parallel/distributed.py`,
the data-parallel `parallel/train_step.py`, the reader's shard, sharded
serving, `remat_blocks`) on the CPU: ranks are spawned processes joined
by gloo, at the reference tests' small size (64 px, block_count 1,
filter_count 32, f32), against the JAX package's 2-device mesh
(conftest's 8 virtual CPU devices) on the same params and batch.

One process group runs every step case (`dp_run`, shared by the tests
that read it); each spawn has its own timeout, so a hung rank fails the
case. Tolerances are the step tests' (tests/test_torch_train_step.py):
losses and metrics rtol 1e-5, gradients within 2e-3 of each leaf's
largest |g|, BatchNorm statistics rtol 1e-5 / atol 1e-6, parameters
after a step within 1e-3 of lr where |g| is not tiny; ZeRO-1 against
the replicated Adam at the reference's rtol 2e-6 / atol 1e-7
(tests/test_train_step.py:131-165).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.config import TrainConfig as JTrainConfig
from yolov3_tpu.data.encoder import encode_boxes
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.parallel import (make_eval_step as j_make_eval_step,
                                 make_mesh,
                                 make_train_step as j_make_train_step,
                                 replicate_to_mesh, shard_batch)
from yolov3_tpu.parallel.train_step import TrainState as JTrainState
from yolov3_tpu.parallel.train_step import _loss_and_metrics, make_optimizer
from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.data import records
from yolov3_tpu_torch.data.reader import DatasetReader, ShmBatchReader
from yolov3_tpu_torch.data.store import RecordWriter
from yolov3_tpu_torch.inference import make_detector_fn
from yolov3_tpu_torch.models.quantized import make_quantized_detector_fn
from yolov3_tpu_torch.parallel import distributed as D
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils import checkpoint as ckpt

import torch_parallel_ranks as R

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             compute_dtype="float32")
WORLD = 2
GLOBAL_BATCH = 4
LR = 1e-4
STEPS = 3
ANCHORS = [(16, 16), (32, 32)]


def make_batch(n=GLOBAL_BATCH, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, 64, 64, 3).astype(np.float32)
    grids = [[], [], []]
    for b in range(n):
        boxes = np.array([[8 + 10 * b, 8, 20, 24, b % 2],
                          [30, 34 - 6 * b, 28, 16, 1]], np.int32)
        for g, grid in zip(grids, encode_boxes(boxes, (64, 64, 3),
                                               SMALL["anchors"], 2)):
            g.append(grid)
    return (images, *[np.stack(g).astype(np.float32) for g in grids])


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix):
    return {"/".join([prefix] + [p.key for p in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def init():
    model = JYoloV3(JConfig(**SMALL))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0))
    return host(variables["params"]), host(variables["batch_stats"])


@pytest.fixture(scope="module")
def dp_run(init, tmp_path_factory):
    """Each rank's results of `torch_parallel_ranks.dp_cases` over one
    2-rank gloo group, and the directory of its ZeRO-1 checkpoint."""
    out_dir = str(tmp_path_factory.mktemp("zero_ckpt"))
    results = D.spawn(R.dp_cases, WORLD, SMALL, init, make_batch(), LR,
                      STEPS, out_dir, backend="gloo", timeout_s=240.0)
    return results, out_dir


@pytest.fixture(scope="module")
def jax_mesh_step(init):
    """JAX's train and eval steps on a 2-device mesh from the init, and
    the summed gradients (the psum: the sum of each half's gradients of
    its local loss over the global batch)."""
    params, stats = init
    jcfg, tcfg = JConfig(**SMALL), JTrainConfig()
    jmodel = JYoloV3(jcfg)
    mesh = make_mesh(n_devices=WORLD)
    state0 = host(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats,
                              opt_state=make_optimizer(tcfg).init(params)))
    batch = make_batch()
    step = j_make_train_step(jmodel, jcfg, tcfg, mesh, GLOBAL_BATCH)
    new, metrics = step(replicate_to_mesh(state0, mesh),
                        shard_batch(batch, mesh), jnp.float32(LR))
    evaluate = j_make_eval_step(jmodel, jcfg, tcfg, mesh, GLOBAL_BATCH)
    eval_metrics = evaluate(replicate_to_mesh(state0, mesh),
                            shard_batch(batch, mesh))
    grad = jax.jit(jax.grad(lambda p, b: _loss_and_metrics(
        jmodel, jcfg, tcfg, GLOBAL_BATCH, p, stats, b[0], b[1:], True)[0]))
    half = GLOBAL_BATCH // WORLD
    grads = [flat(host(grad(params, tuple(a[r * half:(r + 1) * half]
                                          for a in batch))), "params")
             for r in range(WORLD)]
    summed = {k: grads[0][k] + grads[1][k] for k in grads[0]}
    return (host(new), {k: float(v) for k, v in metrics.items()},
            {k: float(v) for k, v in eval_metrics.items()}, summed)


# -- the reader's shard (tests/test_reader.py:155-203) -----------------------

def build_store(path, n, classes_per_img=None, seed=0):
    rng = np.random.RandomState(seed)
    with RecordWriter(str(path)) as w:
        for i in range(n):
            img = rng.randint(0, 255, (64, 64, 1)).astype(np.uint8)
            cls = classes_per_img[i] if classes_per_img else [i % 2]
            boxes = np.array([[4, 4, 20, 20, c] for c in cls], np.int32)
            w.put(records.make_record_key(i, f"img{i}", boxes),
                  records.encode_record(img, boxes))
    return str(path)


@pytest.mark.parametrize("cls", [DatasetReader, ShmBatchReader])
def test_shard_disjoint_equal_cover(tmp_path, cls):
    db = build_store(tmp_path / "db", 10)
    kw = {"batch_size": 2} if cls is ShmBatchReader else {}
    readers = [cls(db, ANCHORS, num_workers=1, shard=(r, 3), **kw)
               for r in range(3)]
    try:
        assert [r.get_image_count() for r in readers] == [3, 3, 3]
        seen = [set(r.keys_flat) for r in readers]
        assert not (seen[0] & seen[1] or seen[1] & seen[2]
                    or seen[0] & seen[2])
        assert len(seen[0] | seen[1] | seen[2]) == 9
        # rank r takes every 3rd key from r of the truncated store
        full = cls(db, ANCHORS, num_workers=1, **kw)
        assert readers[1].keys_flat == full.keys_flat[1:9:3]
        full.shutdown()
    finally:
        for r in readers:
            r.shutdown()


def test_shard_census_spans_the_store(tmp_path):
    # class 3 only in an image rank 0 never reads
    db = build_store(tmp_path / "db", 12, [[0]] * 11 + [[3]])
    full = DatasetReader(db, ANCHORS, num_workers=1)
    r0 = DatasetReader(db, ANCHORS, num_workers=1, shard=(0, 2))
    assert r0.get_number_classes() == full.get_number_classes() == 4
    assert r0.label_shapes() == full.label_shapes()


def test_shard_world_one_is_noop(tmp_path):
    db = build_store(tmp_path / "db", 5)
    r = DatasetReader(db, ANCHORS, num_workers=1, shard=(0, 1))
    assert r.shard is None and r.get_image_count() == 5


@pytest.mark.parametrize("shard,match", [((0, 4), "fewer than"),
                                         ((2, 2), "rank"),
                                         ((-1, 2), "rank")])
def test_shard_errors(tmp_path, shard, match):
    db = build_store(tmp_path / "db", 2)
    with pytest.raises(ValueError, match=match):
        DatasetReader(db, ANCHORS, num_workers=1, shard=shard)


def test_sharded_examples_flow(tmp_path):
    db = build_store(tmp_path / "db", 8)
    r = DatasetReader(db, ANCHORS, shuffle=True, num_workers=1,
                      shard=(1, 2))
    with r:
        img, l32, _, _ = r.get_example()
    assert np.isfinite(img).all() and l32.ndim == 4


# -- the data-parallel step against JAX's 2-device mesh step ------------------

def test_dp_step_metrics_match_jax_mesh(dp_run, jax_mesh_step):
    """`loss` is the ranks' mean and `loss_sum` their sum, as the mesh
    step's pmean and psum; every rank reports the same."""
    results, _ = dp_run
    _, want, want_eval, _ = jax_mesh_step
    for res in results:
        assert set(res["metrics"]) == set(want)
        for k in want:
            np.testing.assert_allclose(res["metrics"][k], want[k],
                                       rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(res["eval"][k], want_eval[k],
                                       rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(want["loss_sum"], WORLD * want["loss"],
                               rtol=1e-6)


def test_dp_step_sums_gradients(dp_run, jax_mesh_step):
    """The gradients are summed over the ranks (lax.psum), not averaged,
    and every rank holds the same sum."""
    results, _ = dp_run
    summed = jax_mesh_step[3]
    for res in results:
        got = res["grads"]
        assert got.keys() == summed.keys()
        for k, w in summed.items():
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=2e-3 * np.abs(w).max(),
                                       err_msg=k)
    for k in summed:
        np.testing.assert_array_equal(results[0]["grads"][k],
                                      results[1]["grads"][k])


def test_dp_step_averages_batch_stats_and_updates_params(dp_run,
                                                         jax_mesh_step):
    """Per-rank BatchNorm statistics, their running values averaged
    (lax.pmean), and the parameters after the step, against the mesh
    step's state; both ranks' states are identical."""
    results, _ = dp_run
    new, summed = jax_mesh_step[0], jax_mesh_step[3]
    got = results[0]["state"]
    for k, w in flat(new.batch_stats, "batch_stats").items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k, w in flat(new.params, "params").items():
        sure = np.abs(summed[k]) > 1e-3 * np.abs(summed[k]).max()
        np.testing.assert_allclose(got[k][sure], w[sure], rtol=0,
                                   atol=1e-3 * LR, err_msg=k)
    for k in got:
        np.testing.assert_array_equal(got[k], results[1]["state"][k])


def test_zero1_matches_replicated_adam(dp_run):
    """ZeRO-1 (`shard_optimizer`): after 3 steps the parameters and
    statistics equal the replicated optimizer's at the reference's
    bound; each rank holds a disjoint share of the moments, together all
    of them, equal to the replicated run's."""
    results, _ = dp_run
    assert results[0]["optimizer_type"] == "ZeroRedundancyOptimizer"
    for res in results:
        for k, w in res["replicated"].items():
            np.testing.assert_allclose(res["zero"][k], w, rtol=2e-6,
                                       atol=1e-7, err_msg=k)
    shares = [set(res["zero_moments"]) for res in results]
    assert shares[0] and shares[1] and not shares[0] & shares[1]
    want = results[0]["replicated_moments"]
    assert shares[0] | shares[1] == set(want)
    for res in results:
        for k, (m, v) in res["zero_moments"].items():
            np.testing.assert_allclose(m, want[k][0], rtol=2e-6, atol=1e-7)
            np.testing.assert_allclose(v, want[k][1], rtol=2e-6, atol=1e-7)


def test_zero1_checkpoint_resumes_at_any_world_size(dp_run, init):
    """The ZeRO-1 checkpoint holds the consolidated moments: the 2-rank
    group resumed from it holds the shares it saved, and one process's
    plain Adam loads every moment."""
    results, out_dir = dp_run
    for res in results:
        assert res["resumed_moments"].keys() == res["zero_moments"].keys()
        for k, (m, v) in res["resumed_moments"].items():
            np.testing.assert_array_equal(m, res["zero_moments"][k][0])
            np.testing.assert_array_equal(v, res["zero_moments"][k][1])
    cfg = ModelConfig(**SMALL)
    state = T.create_train_state(cfg, TrainConfig(), device="cpu",
                                 params=init[0], batch_stats=init[1])
    state = ckpt.restore_checkpoint(out_dir, state)
    assert state.step == STEPS
    got = R.moments(state.optimizer, state.model)
    want = results[0]["replicated_moments"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=2e-6,
                                   atol=1e-7)


def test_dp_batch_must_divide():
    batch = [torch.zeros(5, 2), torch.zeros(5, 3)]
    with pytest.raises(ValueError, match="does not divide"):
        D.shard_batch(batch, 0, 2)
    assert [t.shape[0] for t in D.shard_batch(batch[:1] * 2, 1, 5)] == [1, 1]


def test_dryrun_multichip(capsys):
    loss = D.dryrun_multichip(2)
    assert np.isfinite(loss)
    assert f"dryrun_multichip(2): OK, loss={loss:.4f}" in capsys.readouterr(
        ).out


# -- remat_blocks -------------------------------------------------------------

def test_remat_blocks_gradients_equal_plain(init):
    """`remat_blocks` recomputes the FeatureBlocks' and YoloBlocks'
    activations in the backward: the loss, the gradients and the
    BatchNorm statistics (moved once, not again by the recomputation)
    equal the plain step's."""
    batch = [torch.from_numpy(a) for a in make_batch(2)]
    out = []
    for remat in (False, True):
        cfg = ModelConfig(**dict(SMALL, remat_blocks=remat))
        state = T.create_train_state(cfg, TrainConfig(), device="cpu",
                                     params=init[0], batch_stats=init[1])
        loss, _ = T._loss(state.model, cfg, TrainConfig(), 2, batch[0],
                          batch[1:])
        loss.backward()
        out.append((float(loss.detach()), R.flat_grads(state.model),
                    R.flat_state(state.model)))
    assert out[1][0] == out[0][0]
    for k, w in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k], w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    for k, w in out[0][2].items():
        np.testing.assert_array_equal(out[1][2][k], w, err_msg=k)


# -- sharded serving (tests/test_multichip_inference.py) ---------------------

@pytest.fixture(scope="module")
def export(init, tmp_path_factory):
    return ckpt.export_model(str(tmp_path_factory.mktemp("m")), *init,
                             ModelConfig(**SMALL))


@pytest.mark.parametrize("n,devices", [(5, 3), (4, 2)])
def test_sharded_detector_matches_one_device(export, n, devices):
    """A device list repeating the CPU: the batch padded to a multiple of
    the list, split, and the detections gathered in order, equal to one
    device's (bf16 detector and the int8 detector, whose scales
    calibrate once)."""
    x = np.random.RandomState(n).rand(n, 64, 64, 3).astype(np.float32)
    cpus = ["cpu"] * devices
    single, _ = make_detector_fn(export, device="cpu")
    sharded, _ = make_detector_fn(export, devices=cpus)
    a, b = single(x), sharded(x)
    assert b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    calib = torch.from_numpy(x)
    single, _ = make_quantized_detector_fn(export, calib, device="cpu")
    sharded, _ = make_quantized_detector_fn(export, calib, device="cpu",
                                            devices=cpus)
    np.testing.assert_allclose(sharded(x).numpy(), single(x).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_num_devices_maps_to_the_cards(monkeypatch):
    assert D.serving_devices(3, "cpu") == ["cpu"] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.serving_devices(2, "cuda") == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="only 2"):
        D.serving_devices(3, "cuda")
    with pytest.raises(ValueError, match="only 2"):
        make_detector_fn("unused", num_devices=3, device="cuda")


def test_trainer_num_devices_beyond_the_cards_raises(monkeypatch, tmp_path):
    """`--num_devices` larger than the cards present raises before any
    process starts; it never falls back to fewer devices or the CPU."""
    from yolov3_tpu_torch import train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_spawn(*a, **k):
        raise AssertionError("spawned")

    monkeypatch.setattr(D, "spawn", no_spawn)
    with pytest.raises(ValueError, match="only 1 CUDA"):
        train.train_model(2, 2, "t.ydb", "v.ydb", str(tmp_path), 1, 1e-4,
                          False, num_devices=2, device="cuda")
    assert not list(tmp_path.iterdir())
