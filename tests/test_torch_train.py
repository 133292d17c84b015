"""The port's trainer CLI (`yolov3_tpu_torch/train.py`) end to end on the
CPU: a 64 px store written by the port's own `RecordWriter`, readers,
the train and eval steps, `test_loss.csv`, the best-only checkpoint, the
export, `--resume`, `--profile_dir`, the NaN tripwire and the flags of
a later slice (the device feed's flags: tests/test_torch_feed.py; QAT's:
tests/test_torch_qat.py). The model is cut to block_count 1, filter_count 32 (the
CLI, like the JAX one, has no width flags: the tests narrow its
`ModelConfig`). The export is served by the port's whole-image CLI.
"""

import functools
import glob
import os

import numpy as np
import pytest

from yolov3_tpu_torch import inference, train
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.data import records
from yolov3_tpu_torch.data.imaging import imwrite
from yolov3_tpu_torch.data.store import RecordWriter
from yolov3_tpu_torch.utils import checkpoint as ckpt

ANCHORS = "16x16,32x32"


def write_store(path, n, seed):
    rng = np.random.RandomState(seed)
    with RecordWriter(str(path)) as w:
        for i in range(n):
            img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            img[8:30, 10:34] = 255  # a planted rectangle and its box
            boxes = np.array([[10, 8, 24, 22, i % 2]], np.int32)
            w.put(records.make_record_key(i, f"im{i}", boxes),
                  records.encode_record(img, boxes))


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(train, "ModelConfig", functools.partial(
        ModelConfig, block_count=1, filter_count=32))


@pytest.fixture
def stores(tmp_path):
    write_store(tmp_path / "train.ydb", 8, 0)
    write_store(tmp_path / "test.ydb", 4, 1)
    return tmp_path


def cli(tmp, *extra, epochs=2):
    return ["--train_database", str(tmp / "train.ydb"),
            "--test_database", str(tmp / "test.ydb"),
            "--output_dir", str(tmp / "out"), "--batch_size", "2",
            "--test_every_n_steps", "2", "--max_epochs", str(epochs),
            "--anchors", ANCHORS, "--compute_dtype", "float32",
            "--device", "cpu", *extra]


def read_losses(out):
    with open(os.path.join(out, "test_loss.csv")) as fh:
        return [float(line) for line in fh if line.strip()]


def test_trainer_cli_trains_checkpoints_exports_and_serves(small, stores):
    out = stores / "out"
    train.main(cli(stores, "--profile_dir", str(stores / "prof")))
    losses = read_losses(out)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ckpt.has_checkpoint(str(out))
    assert os.path.exists(stores / "prof" / "trace.json")
    assert len(glob.glob(str(out / "tensorboard-*" / "train" /
                             "scalars.csv"))) == 1
    params, stats, cfg = ckpt.load_model(str(out / "saved_model"))
    assert cfg.img_size == (64, 64, 3) and cfg.number_classes == 2
    assert cfg.anchors == ((16.0, 16.0), (32.0, 32.0))
    assert (cfg.block_count, cfg.filter_count) == (1, 32)
    # the export holds the best checkpoint's weights, in the Flax layout
    want = ckpt.checkpoint_params(str(out))
    for tree, ref in ((params, want[0]), (stats, want[1])):
        flat, flat_ref = {}, {}
        ckpt._flatten(tree, "", flat)
        ckpt._flatten(ref, "", flat_ref)
        assert flat.keys() == flat_ref.keys()
        for k in flat:
            np.testing.assert_array_equal(flat[k], flat_ref[k])

    images = stores / "images"
    images.mkdir()
    rng = np.random.RandomState(2)
    for i in range(3):
        imwrite(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8),
                str(images / f"im{i}.png"))
    inference.main(["--saved-model-filepath", str(out / "saved_model"),
                    "--image-folder", str(images), "--output-folder",
                    str(stores / "csv"), "--image-format", "png",
                    "--min-box-size", "0", "--device", "cpu"])
    csvs = sorted(os.listdir(stores / "csv"))
    assert csvs == [f"im{i}.csv" for i in range(3)]
    for name in csvs:
        with open(stores / "csv" / name) as fh:
            header = fh.readline().strip()
        assert header == "X,Y,W,H,C"


def test_resume_continues_the_epoch_count(small, stores):
    out = str(stores / "out")
    train.main(cli(stores, "--use_augmentation", "0", epochs=1))
    first = read_losses(out)
    step = ckpt._load_checkpoint(out, "cpu")["step"]
    assert len(first) == 1 and step == 3  # warm-up: 2 + 1 steps
    train.main(cli(stores, "--use_augmentation", "0", "--resume", epochs=2))
    second = read_losses(out)
    assert len(second) == 2 and second[0] == first[0]
    if second[1] < second[0]:  # a new best: saved after epoch 1's steps
        assert ckpt._load_checkpoint(out, "cpu")["step"] == 6


@pytest.mark.parametrize("where", ["train", "test"])
def test_nan_loss_raises(small, stores, monkeypatch, where):
    """The tripwires on the summed loss, in training and in test: the
    step's `loss_sum` made NaN on its second call."""
    name = "make_train_step" if where == "train" else "make_eval_step"
    make = getattr(train, name)

    def poisoned(*args):
        step, calls = make(*args), []

        def run(*a):
            out = step(*a)
            calls.append(1)
            metrics = out[1] if where == "train" else out
            if len(calls) == 2:
                metrics["loss_sum"] = metrics["loss_sum"] * float("nan")
            return out
        return run

    monkeypatch.setattr(train, name, poisoned)
    with pytest.raises(RuntimeError, match=f"{where.capitalize()}.*NaN"):
        train.main(cli(stores))
    assert not os.path.exists(stores / "out" / "saved_model")


@pytest.mark.parametrize("flag", [
    ["--num_devices", "2"], ["--shard_optimizer", "1"]])
def test_unported_flags_raise(stores, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(cli(stores, *flag))
    assert not os.path.exists(stores / "out" / "test_loss.csv")


def test_defaults_run_on_the_card():
    import inspect
    assert inspect.signature(train.train_model).parameters[
        "device"].default == "cuda"
    with pytest.raises(SystemExit):
        train.main(["--help"])
