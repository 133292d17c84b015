"""The port's training feed (`yolov3_tpu_torch/data/`: the record codec,
the store, the label encoder, augmentation and the reader) against the
JAX package's, on the same seeded inputs.

Everything is exact (bytes, keys, boxes, label grids and their decoding,
the CHW transpose, census, batches) except the single-image z-score
(1e-5: XLA sums in another order) and the augmented image, whose bilinear rescale is the port's own
numpy version of the JAX module's OpenCV call: within 1.5 float32 ulp of
a [0, 255] pixel (4.6e-5) before the noise and blur, which are linear,
so within atol 2e-4 after them.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.data import augment as jaug
from yolov3_tpu.data import isg_ai_pb2
from yolov3_tpu.data import records as jrec
from yolov3_tpu.data import store as jstore
from yolov3_tpu.data.device_pipeline import zscore_image as j_zscore_image
from yolov3_tpu.data.encoder import decode_label_grid as j_decode_label_grid
from yolov3_tpu.data.encoder import encode_boxes as j_encode_boxes
from yolov3_tpu.data.imaging import format_image_chw as j_format_image_chw
from yolov3_tpu.data.reader import DatasetReader as JReader
from yolov3_tpu_torch.data import augment as taug
from yolov3_tpu_torch.data import isg_ai
from yolov3_tpu_torch.data import records as trec
from yolov3_tpu_torch.data import store as tstore
from yolov3_tpu_torch.data import store_native as t_store_native
from yolov3_tpu_torch.data.device_pipeline import (
    zscore_image as t_zscore_image)
from yolov3_tpu_torch.data.encoder import (
    decode_label_grid as t_decode_label_grid)
from yolov3_tpu_torch.data.encoder import encode_boxes as t_encode_boxes
from yolov3_tpu_torch.data.imaging import (
    format_image_chw as t_format_image_chw)
from yolov3_tpu_torch.data.reader import DatasetReader as TReader

ANCHORS = ((16, 16), (32, 32))


def record_cases():
    rng = np.random.RandomState(0)
    boxes = np.array([[4, 5, 20, 21, 1], [30, 2, 9, 40, 0]], np.int32)
    yield rng.randint(0, 256, (16, 12, 3)).astype(np.uint8), boxes
    yield rng.randint(0, 65536, (9, 7, 1)).astype(np.uint16), boxes[:1]
    yield rng.randn(5, 6).astype(np.float32), boxes
    yield rng.randint(-9, 9, (4, 4, 2)).astype(np.int32), np.zeros((0, 5))
    yield rng.randn(3, 3, 4).astype(">f8"), boxes  # big-endian dtype string


@pytest.mark.parametrize("case", range(5))
def test_record_bytes_match_protobuf(case):
    img, boxes = list(record_cases())[case]
    want = jrec.encode_record(img, boxes)
    got = trec.encode_record(img, boxes)
    assert got == want
    for blob in (got, want):
        ti, tb = trec.decode_record(blob)
        ji, jb = jrec.decode_record(blob)
        assert ti.dtype == ji.dtype == (img.dtype if img.ndim == 3 else
                                        img.dtype)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tb, jb)
    msg = isg_ai_pb2.ImageYoloBoxesPair()
    msg.ParseFromString(got)
    assert msg.img_type == img.dtype.str and msg.box_type == "<i4"
    assert trec.encode_record(img, boxes, preserve_dtype=False) == \
        jrec.encode_record(img, boxes, preserve_dtype=False)


def test_record_fields_unknown_and_negative():
    """Every field, a negative int32, and fields of unknown numbers in all
    wire types: parsed as protobuf parses them, serialized to its bytes."""
    msg = isg_ai_pb2.ImageYoloBoxesPair(
        channels=3, img_height=-7, img_width=2 ** 31 - 1, image=b"\x00\x01",
        box_count=0, boxes=b"", img_type="|u1", box_type="<i4", label=-5)
    blob = msg.SerializeToString()
    ours = isg_ai.ImageYoloBoxesPair()
    ours.ParseFromString(blob)
    for name, _ in isg_ai.FIELDS.values():
        assert getattr(ours, name) == getattr(msg, name), name
    assert ours.SerializeToString() == blob
    # unknown fields: varint 10, fixed64 11, length 12, a group 13 holding
    # a varint, fixed32 14, and a varint 300 (a two-byte tag)
    extra = (bytes([10 << 3 | 0, 0x96, 0x01]) + bytes([11 << 3 | 1]) + b"8" * 8
             + bytes([12 << 3 | 2, 3]) + b"abc"
             + bytes([13 << 3 | 3, 1 << 3 | 0, 5, 13 << 3 | 4])
             + bytes([14 << 3 | 5]) + b"4" * 4 + bytes([0xE0, 0x12, 7]))
    for tail in (extra + blob, blob + extra):
        want = isg_ai_pb2.ImageYoloBoxesPair()
        want.ParseFromString(tail)
        got = isg_ai.ImageYoloBoxesPair()
        got.ParseFromString(tail)
        for name, _ in isg_ai.FIELDS.values():
            assert getattr(got, name) == getattr(want, name), name
    # a repeated scalar field: the last occurrence wins
    twice = blob + isg_ai.ImageYoloBoxesPair(label=9).SerializeToString()
    want.ParseFromString(twice)
    got.ParseFromString(twice)
    assert got.label == want.label == 9


def write_store(module, path, n=6):
    rng = np.random.RandomState(1)
    with module.RecordWriter(str(path)) as w:
        for i in range(n):
            img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
            boxes = np.array([[1, 1, 4, 4, i % 3]], np.int32)
            w.put(jrec.make_record_key(i, f"im{i}", boxes),
                  jrec.encode_record(img, boxes))


@pytest.mark.parametrize("writer,reader", [(jstore, tstore), (tstore, jstore)])
@pytest.mark.parametrize("index", [True, False])
def test_store_written_by_one_reads_in_the_other(tmp_path, writer, reader,
                                                 index):
    path = tmp_path / "db"
    write_store(writer, path)
    if not index:  # the reader rescans the log
        os.remove(path / tstore.INDEX_FILE)
    want = jstore.RecordReader(str(path))
    got = reader.RecordReader(str(path))
    assert got.keys() == want.keys()
    for key in want.keys():
        assert bytes(got.get(key)) == bytes(want.get(key))
    with open(path / tstore.DATA_FILE, "rb") as fh:
        data = fh.read()
    write_store(reader, tmp_path / "again")
    with open(tmp_path / "again" / tstore.DATA_FILE, "rb") as fh:
        assert fh.read() == data
    got.close()
    want.close()


@pytest.mark.parametrize("seed", range(3))
def test_encode_boxes_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for img in ((96, 64, 3), (64, 128)):
        n = rng.randint(0, 9)
        boxes = np.stack([rng.randint(0, img[1] // 2, n),
                          rng.randint(0, img[0] // 2, n),
                          rng.randint(5, img[1] // 2, n),
                          rng.randint(5, img[0] // 2, n),
                          rng.randint(0, 3, n)], 1).astype(np.int32)
        for t, j in zip(t_encode_boxes(boxes, img, ANCHORS, 3),
                        j_encode_boxes(boxes, img, ANCHORS, 3)):
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("all_anchors", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_decode_label_grid_matches_jax(seed, all_anchors):
    rng = np.random.RandomState(20 + seed)
    img = (96, 64, 3)
    n = rng.randint(0, 9)
    boxes = np.stack([rng.randint(0, 32, n), rng.randint(0, 48, n),
                      rng.randint(5, 40, n), rng.randint(5, 40, n),
                      rng.randint(0, 3, n)], 1).astype(np.int32)
    for grid in t_encode_boxes(boxes, img, ANCHORS, 3):
        got = t_decode_label_grid(grid, all_anchors)
        want = j_decode_label_grid(grid, all_anchors)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t_decode_label_grid(np.zeros((4, 4, 7), np.float32))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(24, 20, 3), (9, 7, 1)])
def test_image_helpers_match_jax(shape, dtype):
    """format_image_chw, and the single-image zscore_image on a noisy
    and a flat image (the std <= 1 branch) within 1e-5, as
    test_torch_inference_e2e.py holds the batched zscore_images: XLA
    sums in another order and divides by the count as a multiply by its
    f32 reciprocal (a flat image of 7s has mean 7.0000005 there)."""
    rng = np.random.RandomState(sum(shape))
    img = (rng.rand(*shape) * 255).astype(dtype)
    got = t_format_image_chw(img)
    want = j_format_image_chw(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for x in (img, np.full(shape, 7, dtype)):
        z = t_zscore_image(torch.from_numpy(x)).numpy()
        jz = np.asarray(j_zscore_image(jnp.asarray(x)))
        assert z.dtype == jz.dtype == np.float32
        np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compiler", ["g++", "false"])
def test_native_store_available(tmp_path, monkeypatch, compiler):
    """`available()` is whether the port's own library builds and loads
    (so whether `store.open_reader` takes the native reader): True with a
    compiler, the library then at `library_path()`; False when the build
    fails, and still False on a later call, which does not retry. The
    JAX package's `available` asks whether a prebuilt
    `native/build/libyolodb.so` exists, which depends on what was built
    before, so the two are not compared."""
    if compiler == "g++" and shutil.which("g++") is None:
        pytest.skip("no C++ compiler here")
    monkeypatch.setattr(t_store_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_store_native, "_LIB", None)
    monkeypatch.setattr(t_store_native, "_LOAD_ERROR", None)
    monkeypatch.setenv("CXX", compiler)
    builds = compiler != "false"
    assert t_store_native.available() is builds
    assert os.path.exists(t_store_native.library_path()) is builds
    monkeypatch.setenv("CXX", "g++")
    assert t_store_native.available() is builds


def augment_inputs(seed):
    rng = np.random.RandomState(100 + seed)
    img = rng.randint(0, 256, (80, 72, 3)).astype(np.float32)
    n = rng.randint(1, 5)
    boxes = np.stack([rng.randint(0, 50, n), rng.randint(0, 50, n),
                      rng.randint(12, 30, n), rng.randint(12, 30, n),
                      rng.randint(0, 2, n)], 1).astype(np.int32)
    return img, boxes


@pytest.mark.parametrize("seed", range(4))
def test_augment_image_box_pair_matches_jax(seed):
    """The reader's full chain at the default severities (both flips,
    scale, jitter, noise, blur) from the same RandomState."""
    img, boxes = augment_inputs(seed)
    kw = dict(reflection_flag=True, crop_to=(64, 64),
              noise_augmentation_severity=0.03,
              scale_augmentation_severity=0.1,
              blur_augmentation_max_sigma=2.0,
              box_size_augmentation_severity=0.03,
              box_location_jitter_severity=0.03)
    ji, jb = jaug.augment_image_box_pair(
        img, boxes, rng=np.random.RandomState(seed), **kw)
    ti, tb = taug.augment_image_box_pair(
        img, boxes, rng=np.random.RandomState(seed), **kw)
    assert ti.shape == ji.shape == (64, 64, 3) and ti.dtype == ji.dtype
    np.testing.assert_allclose(ti, ji, rtol=0, atol=2e-4)
    if jb is None:
        assert tb is None
    else:
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("shape", [(50, 41, 3), (33, 47), (64, 64, 1)])
@pytest.mark.parametrize("scale", [(0.9, 1.1), (1.07, 0.93), (1.0, 0.97)])
def test_rescale_matches_opencv(shape, scale):
    img = np.random.RandomState(7).rand(*shape).astype(np.float32) * 255
    got = taug._rescale_image(img, *scale)
    want = jaug._rescale_image(img, *scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=4.6e-5 * 1.5)


@pytest.mark.parametrize("seed", range(3))
def test_box_functions_match_jax(seed):
    img, boxes = augment_inputs(seed)
    for fn, args in (
            ("augment_boxes", (boxes, 0.05, 0.05, img.shape)),
            ("apply_affine_transformation_boxes",
             (boxes, (64, 64), True, seed % 2 == 0, 1.08, 0.95, 3, 5))):
        want = getattr(jaug, fn)(*args, **({"rng": np.random.RandomState(
            seed)} if fn == "augment_boxes" else {}))
        got = getattr(taug, fn)(*args, **({"rng": np.random.RandomState(
            seed)} if fn == "augment_boxes" else {}))
        np.testing.assert_array_equal(got, want)
    ji, jb = jaug.crop_to_size(img, boxes, (64, 64),
                               rng=np.random.RandomState(seed))
    ti, tb = taug.crop_to_size(img, boxes, (64, 64),
                               rng=np.random.RandomState(seed))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)


def census_store(path):
    """Classes 0, 2 and images with no boxes (the pseudo-class)."""
    rng = np.random.RandomState(3)
    with tstore.RecordWriter(str(path)) as w:
        for i in range(7):
            img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            cls = [[0], [2], [], [0, 2], [], [2], [0]][i]
            boxes = np.array([[4 + 3 * i, 6, 20, 18, c] for c in cls],
                             np.int32).reshape(-1, 5)
            w.put(trec.make_record_key(i, f"im{i}", boxes),
                  trec.encode_record(img, boxes))


def test_reader_census_and_batches_match_jax(tmp_path):
    """Class census with the empty-image pseudo-class remap, and the
    strided-sequential batches of one unshuffled worker."""
    census_store(tmp_path / "db")
    kw = dict(use_augmentation=False, shuffle=False, num_workers=1)
    readers = [cls(str(tmp_path / "db"), ANCHORS, **kw)
               for cls in (JReader, TReader)]
    j, t = readers
    assert t.get_number_classes() == j.get_number_classes() == 3
    assert t.empty_images_flag and j.empty_images_flag
    assert t.class_counts() == j.class_counts() == [2, 3, 0, 3]
    assert t.keys == j.keys and t.keys_flat == j.keys_flat
    assert t.get_image_size() == j.get_image_size() == [64, 64, 3]
    assert t.label_shapes() == j.label_shapes()
    batches = []
    for r in readers:
        with r:
            it = r.batches(3)
            batches.append([next(it) for _ in range(3)])  # wraps around 7
    for tb, jb in zip(*batches):
        for ta, ja in zip(tb, jb):
            assert ta.dtype == ja.dtype
            np.testing.assert_array_equal(ta, ja)


def test_reader_sampling_matches_jax(tmp_path):
    """Balanced and plain shuffled draws from the same random.Random."""
    import random
    census_store(tmp_path / "db")
    for balance in (True, False):
        picks = []
        for cls in (JReader, TReader):
            r = cls(str(tmp_path / "db"), ANCHORS, shuffle=True,
                    balance_classes=balance, num_workers=1)
            rng = random.Random(5)
            picks.append([r._next_key(rng) for _ in range(40)])
        assert picks[0] == picks[1]


def test_reader_augmented_examples_flow(tmp_path):
    """Two workers with augmentation: z-scored NHWC float32 images and
    label grids of the census's shapes, then a clean shutdown."""
    census_store(tmp_path / "db")
    r = TReader(str(tmp_path / "db"), ANCHORS, use_augmentation=True,
                balance_classes=True, num_workers=2)
    with r:
        images, *labels = next(r.batches(4))
        assert images.shape == (4, 64, 64, 3) and images.dtype == np.float32
        assert abs(float(images.mean())) < 0.2
        for lab, shape in zip(labels, r.label_shapes()):
            assert lab.shape == (4, *shape)
    assert r._workers is None
