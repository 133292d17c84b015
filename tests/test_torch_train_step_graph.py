"""The train step as one CUDA graph (`yolov3_tpu_torch/parallel/
train_step.py`): what the capture needs, on the CPU, and the replayed step
against the eager one, on the card.

A graph cannot capture a copy from host memory: such a copy synchronises
the stream. So the train-mode forward and the loss may make no tensor
from host data; a `TorchFunctionMode` fails on every `torch.tensor`,
`Tensor.new_tensor` and `torch.as_tensor` of a non-tensor. The CPU, and a
group of more than one rank, keep the eager step and today's Adam.

On the card (`-m cuda`, skipped elsewhere; no JAX, so it also runs with
`--noconftest`): five replayed steps bit-equal to five eager steps taken
with the same capturable Adam from the same state, cuDNN deterministic
(plain, QAT, static QAT, remat), and a restored checkpoint captured
again.

The benchmark's `graph_replay_pct.train` reader on hand-made traces.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.data.encoder import encode_boxes
from yolov3_tpu_torch.ops.decode import anchor_tensor
from yolov3_tpu_torch.parallel import distributed as D
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils import tracing

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32)
BATCH = 2


def make_batch(seed=0, device="cpu"):
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, 64, 64, 3).astype(np.float32)
    grids = [[], [], []]
    for b in range(BATCH):
        boxes = np.array([[8 + 20 * b, 8, 20, 24, b % 2],
                          [30, 34 - 10 * b, 28, 16, 1]], np.int32)
        for g, grid in zip(grids, encode_boxes(boxes, (64, 64, 3),
                                               SMALL["anchors"], 2)):
            g.append(grid)
    return tuple(torch.from_numpy(np.asarray(a)).to(device)
                 for a in (images, *[np.stack(g) for g in grids]))


class NoHostData(TorchFunctionMode):
    """Fails on a tensor made from host data."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.new_tensor:
            data = args[1] if len(args) > 1 else kwargs.get("data")
        elif func in (torch.tensor, torch.as_tensor):
            data = args[0] if args else kwargs.get("data")
        else:
            return func(*args, **kwargs)
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"{func.__name__} of host data {data!r}")
        return func(*args, **kwargs)


def test_guard_catches_host_data():
    x = torch.zeros(2)
    with NoHostData():
        x.new_zeros(())
        torch.as_tensor(x)
        for make in (lambda: torch.tensor(0.0), lambda: x.new_tensor(0.0),
                     lambda: torch.as_tensor([1.0])):
            with pytest.raises(AssertionError, match="host data"):
                make()


MODES = {"plain": {}, "int8_train": {"int8_train": True},
         "int8_static": {"int8_train": True, "int8_train_static": True},
         "remat": {"remat_blocks": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("weight_decay", [False, True])
def test_forward_and_loss_make_no_tensor_from_host_data(mode, compute_dtype,
                                                        weight_decay):
    """The train-mode forward (plain, QAT, static QAT, remat) and the
    loss, given the anchors as a tensor made once (as the step makes
    them), and the backward."""
    cfg = ModelConfig(**SMALL, compute_dtype=compute_dtype, **MODES[mode])
    tcfg = TrainConfig(apply_weight_decay=weight_decay)
    state = T.create_train_state(cfg, tcfg, 0, "cpu")
    images, *labels = make_batch()
    anchors = anchor_tensor(cfg.anchors, "cpu")
    with NoHostData():
        fms = state.model(images)
        loss, _ = T._loss_of(fms, state.model, cfg, tcfg, BATCH, labels,
                             anchors)
        loss.backward()
    assert torch.isfinite(loss)


def test_step_after_the_first_makes_no_tensor_from_host_data():
    """The whole eager step once Adam has its state: forward, loss,
    backward and the update."""
    cfg = ModelConfig(**SMALL, compute_dtype="bfloat16")
    tcfg = TrainConfig()
    state = T.create_train_state(cfg, tcfg, 0, "cpu")
    step = T.make_train_step(cfg, tcfg, BATCH)
    batch = make_batch()
    step(state, batch, 1e-4)
    with NoHostData():
        _, metrics = step(state, batch, 1e-4)
    assert torch.isfinite(metrics["loss"])


def test_cpu_keeps_the_eager_step_and_adam():
    """On the CPU: not graphable, today's Adam (a float lr, not
    capturable), and each step counted eager with its phase spans."""
    cfg = ModelConfig(**SMALL, compute_dtype="bfloat16")
    tcfg = TrainConfig()
    state = T.create_train_state(cfg, tcfg, 0, "cpu")
    assert not T.graphable(state.model)
    group = state.optimizer.param_groups[0]
    assert not group["capturable"] and isinstance(group["lr"], float)
    step = T.make_train_step(cfg, tcfg, BATCH)
    tracing.clear()
    with tracing.recording():
        for _ in range(3):
            step(state, make_batch(), 1e-4)
    assert tracing.counters() == {"step.eager": 3.0}
    names = [s[0] for s in tracing.spans()]
    assert names.count("yolo.step") == 3
    assert names.count("yolo.step.forward") == 3
    tracing.clear()


class _CudaModel:
    """What `graphable` reads of a model: its config and its parameters'
    device."""

    def __init__(self, **overrides):
        self.config = ModelConfig(**dict(SMALL, **overrides))

    def parameters(self):
        yield _OnCuda()


class _OnCuda:
    is_cuda = True


@pytest.mark.parametrize("world,overrides,want", [
    (1, {}, True), (2, {}, False), (4, {}, False),
    (1, {"int8_train": True}, True),
    (1, {"int8_train": True, "int8_train_static": True}, True),
    (1, {"remat_blocks": True}, True), (2, {"remat_blocks": True}, False)])
def test_graph_rule(monkeypatch, world, overrides, want):
    """One CUDA device with no group of more than one rank replays, QAT
    and remat too; a group of more than one rank (NCCL, gloo, ZeRO-1)
    keeps the eager step."""
    monkeypatch.setattr(D, "world_size", lambda group=None: world)
    assert T.graphable(_CudaModel(**overrides), group=object()) is want


def test_multi_rank_keeps_todays_adam(monkeypatch):
    """Over a group of more than one rank `make_optimizer` makes the Adam
    it made before (ZeRO-1 only with `shard_optimizer`)."""
    monkeypatch.setattr(D, "world_size", lambda group=None: 2)
    model = T.create_train_state(ModelConfig(**SMALL), TrainConfig(), 0,
                                 "cpu").model
    opt = T.make_optimizer(model, TrainConfig(learning_rate=3e-4))
    assert type(opt) is torch.optim.Adam
    group = opt.param_groups[0]
    assert group["lr"] == 3e-4 and not group["capturable"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph is captured only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode,compute_dtype", [
    ("plain", "bfloat16"), ("plain", "float32"), ("int8_train", "bfloat16"),
    ("int8_static", "bfloat16"), ("remat", "bfloat16")])
def test_replayed_steps_bit_equal_to_eager(cuda, monkeypatch, mode,
                                          compute_dtype):
    cfg = ModelConfig(**SMALL, compute_dtype=compute_dtype, **MODES[mode])
    tcfg = TrainConfig()
    batches = [make_batch(seed, cuda) for seed in range(5)]
    runs = {}
    for how in ("eager", "graph"):
        state = T.create_train_state(cfg, tcfg, 0, cuda)
        assert T.graphable(state.model)
        assert state.optimizer.param_groups[0]["capturable"]
        step = T.make_train_step(cfg, tcfg, BATCH)
        with monkeypatch.context() as m:
            if how == "eager":
                m.setattr(T, "graphable", lambda model, group=None: False)
            tracing.clear()
            with tracing.recording():
                losses = [step(state, b, 1e-3 * (i + 1))[1]["loss"].clone()
                          for i, b in enumerate(batches)]
            counts = tracing.counters()
            tracing.clear()
        runs[how] = losses, state_tensors(state)
        want = ({"step.eager": 5.0} if how == "eager" else
                {"step.eager": 1.0, "step.replayed": 4.0})
        assert counts == want
    (le, te), (lg, tg) = runs["eager"], runs["graph"]
    assert torch.equal(torch.stack(le), torch.stack(lg))
    assert te.keys() == tg.keys()
    for k in te:
        assert torch.equal(te[k], tg[k]), k


@pytest.mark.cuda
def test_replaced_state_is_captured_again(cuda, tmp_path):
    """A checkpoint's restore replaces Adam's tensors: the next step runs
    eagerly, the one after captures again, and the restored run matches
    one that never stopped."""
    from yolov3_tpu_torch.utils import checkpoint as ckpt
    cfg = ModelConfig(**SMALL, compute_dtype="bfloat16")
    tcfg = TrainConfig()
    batches = [make_batch(seed, cuda) for seed in range(4)]
    state = T.create_train_state(cfg, tcfg, 0, cuda)
    step = T.make_train_step(cfg, tcfg, BATCH)
    for b in batches[:2]:
        step(state, b, 1e-3)
    ckpt.save_checkpoint(str(tmp_path), state)
    for b in batches[2:]:
        step(state, b, 1e-3)
    want = state_tensors(state)
    ckpt.restore_checkpoint(str(tmp_path), state)
    assert state.optimizer.param_groups[0]["capturable"]
    tracing.clear()
    with tracing.recording():
        for b in batches[2:]:
            step(state, b, 1e-3)
    assert tracing.counters() == {"step.eager": 1.0, "step.replayed": 1.0}
    tracing.clear()
    got = state_tensors(state)
    for k in want:
        assert torch.equal(want[k], got[k]), k


# --- the benchmark's reader of the counters --------------------------------

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
BASE_NS = 1790857026 * 10 ** 9  # the trace's base, whole seconds


def _portbench(name):
    if PORTBENCH not in sys.path:
        sys.path.append(PORTBENCH)
    return importlib.import_module(name)


def _reader():
    spec = importlib.util.spec_from_file_location(
        "metric_graph_replay_pct_train",
        os.path.join(PORTBENCH, "metrics", "graph_replay_pct.train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorder:
    def __init__(self, records, by_call):
        self.records, self.by_call = records, by_call

    def spans(self):
        return list(self.records)

    def counters(self, by_call=False):
        return self.by_call


def _traced_steps(counts):
    """One traced step a counter dict: `bench.step_all` [t, t+500] holds
    `bench.feed` [t, t+100] and `bench.step` [t+100, t+500], the program's
    `yolo.feed` and `yolo.step` inside them, one kernel launched in the
    step; the step's counts under its call id."""
    devtrace = _portbench("devtrace")
    from loops.common import Run
    events, records, by_call = [], [], {}
    for k, c in enumerate(counts):
        t = 10000 + 1000 * k
        events += [
            {"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
             "dur": d} for n, s, d in (("bench.step_all", t, 500),
                                       ("bench.feed", t, 100),
                                       ("bench.step", t + 100, 400))]
        events += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
             "ts": t + 150, "dur": 1, "args": {"correlation": k}},
            {"ph": "X", "cat": "kernel", "name": "k", "ts": t + 200,
             "dur": 100, "args": {"correlation": k}}]
        records += [("yolo.feed", BASE_NS + (t + 2) * 1000,
                     BASE_NS + (t + 90) * 1000, None, 2 * k),
                    ("yolo.step", BASE_NS + (t + 102) * 1000,
                     BASE_NS + (t + 490) * 1000, None, 2 * k + 1)]
        by_call[2 * k + 1] = c
    trace = devtrace.Trace(events)
    run = Run(True, 1, 0, {}, [], 0, {}, trace=trace,
              trace_window=trace.window("bench.step_all"))
    return run, records, by_call


@pytest.mark.parametrize("counts,want", [
    ([{"step.replayed": 1.0}] * 4, 100.0),
    ([{"step.eager": 1.0}] + [{"step.replayed": 1.0}] * 3, 75.0),
    ([{"step.eager": 1.0}] * 2, 0.0),
    ([{}] * 3, None)])
def test_graph_replay_pct_reader(monkeypatch, counts, want):
    """100 x replayed / (replayed + eager) over the slice's steps; None
    where the program counts neither, as a commit before the graph."""
    run, records, by_call = _traced_steps(counts)
    P = _portbench("program_spans")
    monkeypatch.setattr(P, "recorder", lambda: _Recorder(records, by_call))
    got = _reader().read(run)
    assert got == (pytest.approx(want) if want is not None else None)


def test_graph_replay_pct_reader_without_a_trace():
    from types import SimpleNamespace
    _portbench("program_spans")
    assert _reader().read(SimpleNamespace(trace=None)) is None
