"""The port's device-augment feed on the CPU: the shared-memory ring
(`data/shm_ring.py`), the raw-mode and ring readers (`data/reader.py`)
against the JAX package's raw-mode reader, the native store reader
(`data/store_native.py`, built from `native/yolodb.cpp` into the port's
build directory) against both packages' pure-Python readers, the
prefetcher's transform, and the trainer CLI with `--device_augment 1
--shm_feed 1`. Bytes, keys, batches and orders are held exactly.
"""

import os

import numpy as np
import pytest
import torch

from yolov3_tpu.data import store as jstore
from yolov3_tpu.data.reader import DatasetReader as JReader
from yolov3_tpu_torch import train
from yolov3_tpu_torch.config import AugmentConfig
from yolov3_tpu_torch.data import records as trec
from yolov3_tpu_torch.data import shm_ring
from yolov3_tpu_torch.data import store as tstore
from yolov3_tpu_torch.data import store_native
from yolov3_tpu_torch.data.reader import DatasetReader as TReader
from yolov3_tpu_torch.data.reader import ShmBatchReader
from yolov3_tpu_torch.utils.prefetch import DevicePrefetcher

ANCHORS = ((16, 16), (32, 32))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_store(writer_cls, path, n=7):
    """Images of 64 px with 0-3 boxes each, classes 0 and 2."""
    rng = np.random.RandomState(3)
    with writer_cls(str(path)) as w:
        for i in range(n):
            img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            boxes = np.array([[4 + 3 * i + 9 * j, 6, 20, 18, (i + j) % 3]
                              for j in range(i % 4)], np.int32).reshape(-1, 5)
            w.put(trec.make_record_key(i, f"im{i}", boxes),
                  trec.encode_record(img, boxes))


def test_batch_ring_roundtrip_and_attach():
    ring = shm_ring.BatchRing(batch=2, image_shape=(5, 4, 3),
                              image_dtype=np.uint8, max_boxes=3, num_slots=3)
    try:
        assert ring.path.startswith(shm_ring.ring_dir())
        assert ring.total_bytes == 3 * ring.slot_bytes
        other = shm_ring.BatchRing.attach(ring.spec())
        for slot in range(3):
            imgs, boxes, valid = ring.views(slot)
            imgs[:] = slot + 1
            boxes[:] = np.arange(30, dtype=np.float32).reshape(2, 3, 5) + slot
            valid[:] = [[True, False, slot == 1], [False, True, True]]
        for slot in range(3):
            imgs, boxes, valid = other.views(slot)
            assert imgs.shape == (2, 5, 4, 3) and imgs.dtype == np.uint8
            assert (imgs == slot + 1).all()
            np.testing.assert_array_equal(
                boxes, np.arange(30).reshape(2, 3, 5) + slot)
            assert valid.tolist() == [[True, False, slot == 1],
                                      [False, True, True]]
        with pytest.raises(IndexError):
            ring.views(3)
        del imgs, boxes, valid
        other.close()
    finally:
        ring.close(unlink=True)
    assert not os.path.exists(ring.path)


def test_batch_ring_checks_free_space(monkeypatch):
    monkeypatch.setattr(shm_ring, "free_bytes", lambda path: 1000)
    with pytest.raises(OSError, match=r"needs \d+"):
        shm_ring.BatchRing(batch=16, image_shape=(512, 512, 3),
                           image_dtype=np.uint8, max_boxes=64, num_slots=5)


def test_raw_and_ring_readers_match_jax(tmp_path):
    """One unshuffled worker: the port's raw-mode reader, its ring reader
    and the JAX raw-mode reader give the same uint8 images, padded boxes
    and masks, in the same order (strided sequential, wrapping)."""
    write_store(tstore.RecordWriter, tmp_path / "db")
    kw = dict(use_augmentation=False, shuffle=False, num_workers=1)
    db = str(tmp_path / "db")
    readers = [JReader(db, ANCHORS, raw_mode=True, **kw),
               TReader(db, ANCHORS, raw_mode=True, **kw),
               ShmBatchReader(db, ANCHORS, batch_size=3, **kw)]
    assert readers[1].store_kind == readers[2].store_kind == "native"
    got = []
    for r in readers:
        with r:
            it = r.batches(3)
            got.append([tuple(np.array(a) for a in next(it))
                        for _ in range(3)])
    assert readers[2]._workers is None
    assert not os.path.exists(readers[2]._ring.path)
    for jb, tb, sb in zip(*got):
        assert tb[0].dtype == np.uint8 and tb[0].shape == (3, 64, 64, 3)
        assert tb[1].shape == (3, 64, 5) and tb[2].dtype == bool
        for j, t, s in zip(jb, tb, sb):
            assert j.dtype == t.dtype == s.dtype
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(s, j)
    assert got[1][0][2].sum(1).tolist() == [0, 1, 2]


@pytest.mark.parametrize("writer", ["port", "jax", "native"])
def test_native_reader_bytes_match_python_readers(tmp_path, writer):
    """Keys, `get` and `get_batch` of the native reader against the
    port's and JAX's pure-Python readers, on a store written by the
    port's or JAX's Python writer or the native writer."""
    path = str(tmp_path / "db")
    write_store({"port": tstore.RecordWriter, "jax": jstore.RecordWriter,
                 "native": store_native.NativeRecordWriter}[writer], path)
    native = store_native.NativeRecordReader(path)
    port, jax_reader = tstore.RecordReader(path), jstore.RecordReader(path)
    keys = native.keys()
    assert len(keys) == len(native) == 7
    assert keys == port.keys() == jax_reader.keys()
    for key in keys:
        assert bytes(native.get(key)) == bytes(port.get(key)) == \
            bytes(jax_reader.get(key))
    wanted = keys[::-1] + [b"no_such:0"] + keys[:2]
    batch = native.get_batch(wanted)
    assert batch[len(keys)] is None and native.get(b"no_such:0") is None
    assert [bytes(b) for i, b in enumerate(batch) if i != len(keys)] == \
        [bytes(b) for b in port.get_batch(wanted) if b is not None]
    assert native.get_batch([]) == []
    del batch
    for r in (native, port, jax_reader):
        r.close()


def test_native_library_built_in_the_port_build_dir():
    path = store_native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "yolov3_tpu_torch")
    assert os.path.basename(path).startswith("libyolodb-")
    assert store_native.SOURCE == os.path.join(REPO, "native", "yolodb.cpp")
    store_native.load()
    assert os.path.exists(path)


def test_open_reader_prefers_native(tmp_path, monkeypatch, capsys):
    write_store(tstore.RecordWriter, tmp_path / "db", n=2)
    with tstore.open_reader(str(tmp_path / "db")) as r:
        assert r.kind == "native" and len(r) == 2

    def no_compiler():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(store_native, "load", no_compiler)
    with tstore.open_reader(str(tmp_path / "db")) as r:
        assert r.kind == "python" and len(r) == 2
    assert "pure-Python reader: no C++ compiler" in capsys.readouterr().out


def test_native_load_failure_is_not_retried(monkeypatch):
    calls = []

    def failing_build():
        calls.append(1)
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(store_native, "_LIB", None)
    monkeypatch.setattr(store_native, "_LOAD_ERROR", None)
    monkeypatch.setattr(store_native, "build", failing_build)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            store_native.load()
    assert len(calls) == 1


def test_prefetcher_transform_on_recycled_views():
    """The source reuses one buffer for every batch, as the ring does:
    each batch is copied before the next is pulled, then transformed."""
    buf = np.zeros((2, 3), np.uint8)

    def source():
        for k in range(5):
            buf[:] = k
            yield (buf,)

    pre = DevicePrefetcher(source(), "cpu", depth=2,
                           transform=lambda t: (t[0].float() * 2,))
    out = [b[0] for b in pre]
    assert [float(o[0, 0]) for o in out] == [0, 2, 4, 6, 8]
    assert all(o.dtype == torch.float32 for o in out)


def test_device_feed_repeats_per_batch():
    """One generator per batch, seeded from (seed + 1, batch number): two
    feeds give the same batches, and batches differ from each other."""
    rng = np.random.default_rng(0)
    raw = (torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3),
                                         dtype=np.uint8)),
           torch.zeros((2, 64, 5)), torch.zeros((2, 64), dtype=torch.bool))
    feeds = [train._device_feed(3, "cpu", AugmentConfig(), (64, 64, 3),
                                ANCHORS, 2, True) for _ in range(2)]
    first = [feeds[0](raw), feeds[0](raw)]
    again = [feeds[1](raw), feeds[1](raw)]
    for a, b in zip(first, again):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert not torch.equal(first[0][0], first[1][0])
    g = train.batch_generator(3, 1, "cpu")
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=train.batch_generator(3, 1,
                                                                     "cpu")))
    with pytest.raises(RuntimeError):  # no card here, and no CPU stand-in
        train.batch_generator(3, 1, "cuda")


def test_trainer_cli_device_augment_shm_feed(tmp_path, monkeypatch, capsys):
    import functools

    from yolov3_tpu_torch.config import ModelConfig
    monkeypatch.setattr(train, "ModelConfig", functools.partial(
        ModelConfig, block_count=1, filter_count=32))
    write_store(tstore.RecordWriter, tmp_path / "train.ydb", n=8)
    write_store(tstore.RecordWriter, tmp_path / "test.ydb", n=4)
    out = tmp_path / "out"
    train.main(["--train_database", str(tmp_path / "train.ydb"),
                "--test_database", str(tmp_path / "test.ydb"),
                "--output_dir", str(out), "--batch_size", "2",
                "--test_every_n_steps", "2", "--max_epochs", "1",
                "--anchors", "16x16,32x32", "--compute_dtype", "float32",
                "--device_augment", "1", "--shm_feed", "1",
                "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Feed: device augmentation, shared-memory ring" in printed
    assert "Train Reader has 8 images (native store reader)" in printed
    with open(out / "test_loss.csv") as fh:
        losses = [float(v) for v in fh if v.strip()]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert os.path.exists(out / "saved_model" / "weights.npz")
