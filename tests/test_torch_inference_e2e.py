"""PyTorch port inference CLI vs the JAX CLI on one toy export.

The toy model is exported by the JAX package (Orbax), converted to the
port's artifact through numpy, and both CLIs run on the same PNGs. The
port runs with device="cpu". The X,Y,W,H,C CSVs must be identical byte
for byte. In the scored X,Y,W,H,P,C layout every box and class must be
identical and P (printed to 6 decimals) within 2e-6: the two frameworks'
float32 convolutions sum in different orders, the scores differ in the
7th digit, and that flips the printed last digit of a few of them.
"""

import os

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.inference import inference as jax_inference
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.utils import checkpoint as jckpt
from yolov3_tpu_torch import inference as tinf
from yolov3_tpu_torch.config import InferenceConfig, ModelConfig
from yolov3_tpu_torch.data.imaging import imread, imwrite
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.ops.nms import nms_to_host
from yolov3_tpu_torch.utils import checkpoint as ckpt

CPU = "cpu"


def export_both(tmp_path_factory, **kw):
    out = tmp_path_factory.mktemp("model")
    jcfg = JConfig(img_size=(64, 64, 3), number_classes=2,
                   anchors=((16, 16), (32, 32)), block_count=1,
                   filter_count=32, compute_dtype="float32", **kw)
    v = JYoloV3(jcfg).init(jax.random.PRNGKey(0),
                           np.zeros((1, 64, 64, 3), np.float32), train=False)
    jpath = jckpt.export_model(str(out / "jax"), v["params"],
                               v["batch_stats"], jcfg)
    p, s, cfg = jckpt.load_model(jpath)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tpath = ckpt.export_model(str(out / "port"), to_np(p), to_np(s),
                              ModelConfig.from_json(cfg.to_json()))
    return jpath, tpath


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    return export_both(tmp_path_factory)


@pytest.fixture(scope="module")
def exports_int8(tmp_path_factory):
    """The toy export with the plain stem. The port always runs the plain
    stem; at the space-to-depth stem (the JAX default) JAX quantizes the
    lifted stem kernels, which tests/test_torch_quantized.py holds to its
    decode-fidelity bound instead."""
    return export_both(tmp_path_factory, stem_space_to_depth=False)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("imgs"))
    rng = np.random.RandomState(42)
    for i in range(3):
        imwrite(rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
                os.path.join(folder, f"im{i}.png"))
    return folder


def read_all(folder):
    out = {}
    for fn in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fn)) as fh:
            out[fn] = fh.read()
    return out


@pytest.mark.parametrize("save_scores", [False, True])
@pytest.mark.parametrize("host_nms", [False, True])
def test_same_csvs_as_jax_cli(exports, images, tmp_path, save_scores,
                              host_nms):
    jpath, tpath = exports
    kw = dict(min_box_size=4, batch_size=2, use_host_nms=host_nms,
              save_scores=save_scores)
    jax_inference(images, "png", jpath, str(tmp_path / "jax"), **kw)
    tinf.inference(images, "png", tpath, str(tmp_path / "port"),
                   device=CPU, **kw)
    want, got = read_all(tmp_path / "jax"), read_all(tmp_path / "port")
    assert sorted(got) == sorted(want) == ["im0.csv", "im1.csv", "im2.csv"]
    assert sum(len(t.splitlines()) - 1 for t in want.values()) > 0
    if not save_scores:
        assert got == want
        return
    for fn in want:
        g, w = got[fn].splitlines(), want[fn].splitlines()
        assert g[0] == w[0] == "X,Y,W,H,P,C" and len(g) == len(w)
        g = np.array([line.split(",") for line in g[1:]]).reshape(-1, 6)
        w = np.array([line.split(",") for line in w[1:]]).reshape(-1, 6)
        np.testing.assert_array_equal(g[:, [0, 1, 2, 3, 5]],
                                      w[:, [0, 1, 2, 3, 5]])
        np.testing.assert_allclose(g[:, 4].astype(float),
                                   w[:, 4].astype(float), rtol=0, atol=2e-6)


def test_save_scores_layout(exports, images, tmp_path):
    """The scored layout has the unscored layout's X, Y, W, H and C."""
    _, tpath = exports
    plain, scored = str(tmp_path / "plain"), str(tmp_path / "scored")
    tinf.inference(images, "png", tpath, plain, 4, batch_size=2, device=CPU)
    tinf.inference(images, "png", tpath, scored, 4, batch_size=2,
                   save_scores=True, device=CPU)
    n = 0
    for fn in sorted(os.listdir(scored)):
        with open(os.path.join(scored, fn)) as fh:
            assert fh.readline().strip() == "X,Y,W,H,P,C"
            rows = np.array([[float(v) for v in line.split(",")]
                             for line in fh.read().splitlines()]).reshape(-1, 6)
        want = bbox.load_boxes_to_xywhc(os.path.join(plain, fn))
        assert rows.shape[0] == want.shape[0]
        n += rows.shape[0]
        np.testing.assert_array_equal(rows[:, [0, 1, 2, 3, 5]], want)
        assert np.all(rows[:, 4] > 0.0) and np.all(rows[:, 4] <= 1.0)
    assert n > 0


def test_serving_fn_matches_stepwise(exports):
    """make_serving_fn equals detect -> clip -> filter -> host NMS."""
    _, tpath = exports
    serve, cfg = tinf.make_serving_fn(tpath, min_box_size=4, device=CPU)
    detect, _ = tinf.make_detector_fn(tpath, device=CPU)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    boxes, scores, keep = serve(x)
    dets = detect(x).numpy()
    icfg = InferenceConfig(min_box_size=4)
    for i in range(2):
        got = nms_to_host(boxes[i], scores[i], keep[i])
        want = tinf.detections_to_csv_rows(dets[i], (64, 64), 4, icfg,
                                           use_host_nms=True,
                                           num_classes=cfg.number_classes,
                                           device=CPU)
        if got[0] is None:
            assert want.shape[0] == 0
            continue
        rows = got[0].copy()
        rows[:, 2] -= rows[:, 0]
        rows[:, 3] -= rows[:, 1]
        rows = np.concatenate([rows, got[2].reshape(-1, 1)],
                              axis=1).astype(np.int32)
        np.testing.assert_array_equal(rows, want)


def test_serving_clips_to_actual_image_size(exports):
    _, tpath = exports
    serve, _ = tinf.make_serving_fn(tpath, min_box_size=1, device=CPU)
    boxes, _, keep = serve(np.random.RandomState(2).rand(2, 128, 128, 3)
                           .astype(np.float32))
    kept = boxes[keep]
    assert kept.shape[0] > 0
    assert kept.max() <= 128.0 and kept.max() > 64.0


def test_detect_images_without_imread(exports):
    _, tpath = exports
    detect, cfg = tinf.make_detector_fn(tpath, device=CPU)
    imgs = [np.random.RandomState(i).randint(0, 255, (64, 64, 3)).astype(
        np.uint8) for i in range(2)]
    rows, scores = tinf.detect_images(imgs, detect, cfg.number_classes,
                                      InferenceConfig(min_box_size=4), 4,
                                      device=CPU)
    assert len(rows) == len(scores) == 2
    for r, s in zip(rows, scores):
        assert r.shape == (s.shape[0], 5) and r.dtype == np.int32


def test_overlays_and_main(exports, images, tmp_path):
    _, tpath = exports
    out, ov = str(tmp_path / "out"), str(tmp_path / "ov")
    tinf.main(["--saved-model-filepath", tpath, "--output-folder", out,
               "--image-folder", images, "--image-format", "png",
               "--min-box-size", "4", "--save-overlays", ov,
               "--device", CPU])
    assert sorted(os.listdir(out)) == ["im0.csv", "im1.csv", "im2.csv"]
    assert sorted(os.listdir(ov)) == ["im0.png", "im1.png", "im2.png"]
    assert imread(os.path.join(ov, "im0.png")).shape[:2] == (64, 64)


@pytest.mark.parametrize("flags", [["--num-devices", "2"]])
def test_unported_flags_raise(exports, images, tmp_path, flags):
    """The flag once refused, now ported: `--num-devices 2` on the CPU
    (the CPU twice) shards each batch of 2 (and the last batch of 1,
    padded) over two replicas, and writes the one-device CSVs, in bf16
    and with `--int8` (the int8 detector then, not the fused serving
    function, calibrated once: the reference's rule)."""
    _, tpath = exports
    for extra in ([], ["--int8"]):
        outs = []
        for more in ([], flags):
            out = str(tmp_path / f"o{len(outs)}{len(extra)}")
            tinf.main(["--saved-model-filepath", tpath, "--output-folder",
                       out, "--image-folder", images, "--image-format",
                       "png", "--device", CPU, "--batch-size", "2",
                       "--save-scores", *extra, *more])
            outs.append(read_all(out))
        assert sorted(outs[1]) == ["im0.csv", "im1.csv", "im2.csv"]
        assert outs[1] == outs[0]


@pytest.fixture
def jax_int8_kernels(monkeypatch):
    """The JAX int8 path under the port's wiring: its three kernel flags,
    in interpret mode (on the CPU its default is the XLA mirror)."""
    from yolov3_tpu.models import quantized as Q
    kernels = dict(pointwise_pallas=True, conv3_pallas=True,
                   down_pallas=True, fused_interpret=True)
    monkeypatch.setattr(Q, "default_serving_kernels", lambda: dict(kernels))
    return kernels


def assert_same_csvs(got, want, save_scores):
    """Boxes and classes identical. In the scored layout P within 2e-6 (the
    float32 convolutions of the heads sum in different orders)."""
    assert sorted(got) == sorted(want)
    for fn in want:
        g, w = got[fn].splitlines(), want[fn].splitlines()
        assert g[0] == w[0] and len(g) == len(w), fn
        if not save_scores:
            assert g == w, fn
            continue
        g = np.array([line.split(",") for line in g[1:]]).reshape(-1, 6)
        w = np.array([line.split(",") for line in w[1:]]).reshape(-1, 6)
        np.testing.assert_array_equal(g[:, [0, 1, 2, 3, 5]],
                                      w[:, [0, 1, 2, 3, 5]])
        np.testing.assert_allclose(g[:, 4].astype(float),
                                   w[:, 4].astype(float), rtol=0, atol=2e-6)


@pytest.mark.parametrize("save_scores", [False, True])
def test_int8_csvs_match_jax_cli(exports_int8, images, tmp_path,
                                 save_scores, jax_int8_kernels, monkeypatch):
    """--int8 (calibrated on the first batch; the last chunk of 3 images
    padded to the batch of 2) against the JAX CLI with --int8. The port
    calibrates with JAX's `calibrate` on the batch it is given: each
    package's own calibration differs in the last bits of a few scales
    (their float32 convolutions sum in different orders), which flips
    codes on .5 boundaries and, on this export, one of 156 boxes
    (ROADMAP Queue C)."""
    from yolov3_tpu.models import quantized as Q
    from yolov3_tpu_torch.models import quantized as TQ
    jpath, tpath = exports_int8
    p, st, jcfg = jckpt.load_model(jpath)
    monkeypatch.setattr(TQ, "calibrate", lambda _, images, pct: Q.calibrate(
        p, st, jcfg, images.numpy(), percentile=pct))
    kw = dict(min_box_size=4, batch_size=2, use_int8=True,
              save_scores=save_scores)
    jax_inference(images, "png", jpath, str(tmp_path / "jax"), **kw)
    tinf.inference(images, "png", tpath, str(tmp_path / "port"),
                   device=CPU, **kw)
    want, got = read_all(tmp_path / "jax"), read_all(tmp_path / "port")
    assert sum(len(t.splitlines()) - 1 for t in want.values()) > 0
    assert_same_csvs(got, want, save_scores)


def test_int8_host_nms_matches_fused(exports, images, tmp_path):
    """--int8 --host_nms (the int8 detector and the shared post-processing)
    gives the boxes of --int8 (tests/test_inference_e2e.py:130-146)."""
    _, tpath = exports
    kw = dict(min_box_size=4, batch_size=2, use_int8=True, device=CPU)
    tinf.inference(images, "png", tpath, str(tmp_path / "a"), **kw)
    tinf.inference(images, "png", tpath, str(tmp_path / "b"),
                   use_host_nms=True, **kw)
    for fn in sorted(os.listdir(tmp_path / "a")):
        np.testing.assert_array_equal(
            bbox.load_boxes_to_xywhc(os.path.join(tmp_path / "a", fn)),
            bbox.load_boxes_to_xywhc(os.path.join(tmp_path / "b", fn)))


def test_int8_calib_percentile_flag(exports, images, tmp_path):
    _, tpath = exports
    out = str(tmp_path / "p")
    tinf.main(["--saved-model-filepath", tpath, "--output-folder", out,
               "--image-folder", images, "--image-format", "png",
               "--min-box-size", "4", "--int8", "--calib-percentile", "99.9",
               "--batch-size", "2", "--device", CPU])
    assert sorted(os.listdir(out)) == ["im0.csv", "im1.csv", "im2.csv"]


def test_int8_serving_fn_matches_jax(exports_int8, monkeypatch,
                                     jax_int8_kernels):
    """make_quantized_serving_fn on one export with JAX's scales (the port's
    `calibrate` swapped for them): boxes, scores and keep, and the
    raw-pixel variant equal to the z-scored one."""
    from yolov3_tpu.models.quantized import (
        make_quantized_serving_fn as jax_serving_fn)
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    from yolov3_tpu_torch.models import quantized as TQ
    jpath, tpath = exports_int8
    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = zscore_images(torch.from_numpy(raw)).numpy()
    jserve, _, scales = jax_serving_fn(jpath, x, min_box_size=4,
                                       kernels=jax_int8_kernels)
    monkeypatch.setattr(TQ, "calibrate", lambda *a: dict(scales))
    serve, _, got_scales = TQ.make_quantized_serving_fn(
        tpath, x, min_box_size=4, device=CPU)
    assert got_scales == scales
    want = [np.asarray(o) for o in jserve(x)]
    got = [o.numpy() for o in serve(x)]
    np.testing.assert_array_equal(got[2], want[2])
    assert want[2].sum() > 0
    np.testing.assert_allclose(got[0][want[2]], want[0][want[2]], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    raw_serve, _, _ = TQ.make_quantized_serving_fn(
        tpath, x, min_box_size=4, raw_pixels=True, device=CPU)
    for a, b in zip(raw_serve(raw), got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_default_device_is_cuda(exports):
    """No silent CPU fallback: without a card the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tpath = exports
    with pytest.raises((RuntimeError, AssertionError)):
        tinf.make_detector_fn(tpath)


def test_int8_default_device_is_cuda(exports):
    """The int8 entry points default to the card as well."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from yolov3_tpu_torch.models import quantized as TQ
    _, tpath = exports
    calib = np.zeros((1, 64, 64, 3), np.float32)
    for make in (TQ.make_quantized_detector_fn,
                 TQ.make_quantized_serving_fn):
        with pytest.raises((RuntimeError, AssertionError)):
            make(tpath, calib)


@pytest.mark.parametrize("low_contrast", [False, True])
def test_zscore_images_matches_jax(low_contrast):
    """Per-image f32 z-score with population std; std <= 1 only subtracts
    the mean. The means are summed in another order than XLA's: 1e-5."""
    from yolov3_tpu.data.device_pipeline import zscore_images as jz
    from yolov3_tpu.data.imaging import zscore_normalize as jzn
    from yolov3_tpu_torch.data.device_pipeline import zscore_images
    from yolov3_tpu_torch.data.imaging import zscore_normalize
    rng = np.random.RandomState(7)
    hi = 2 if low_contrast else 256
    u8 = rng.randint(0, hi, (3, 32, 48, 3)).astype(np.uint8)
    got = zscore_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, np.asarray(jz(u8)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zscore_normalize(u8[0]), jzn(u8[0]),
                               rtol=1e-5, atol=1e-5)
    if low_contrast:   # std <= 1: mean-subtracted only
        np.testing.assert_allclose(got[0], u8[0] - u8[0].mean(), atol=1e-5)
