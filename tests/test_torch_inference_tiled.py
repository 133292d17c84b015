"""The port's tiled CLI (`yolov3_tpu_torch/inference_tiled.py`) against the
JAX package's (`yolov3_tpu/inference_tiled.py`) on one toy export.

The toy model is exported by the JAX package, converted to the port's
artifact through numpy, and both CLIs run on the same PNGs, the port
with device="cpu". The 150 x 130 image of tests/test_inference_e2e.py
makes 9 tiles of 64 px, batches of 4, 4 and 1; the 256 px export runs
the 96 px ghost zones. Boxes and classes must be identical and P
(printed to 6 decimals) within 2e-6: the two frameworks' float32
convolutions sum in different orders (ROADMAP Queue C, "Scored CSV").
"""

import os

import jax
import numpy as np
import pytest

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.inference_tiled import \
    inference_image_folder as jax_tiled_folder
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.utils import checkpoint as jckpt
from yolov3_tpu_torch import inference_tiled as ttiled
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.data.imaging import imwrite
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.utils import checkpoint as ckpt

CPU = "cpu"


def export_pair(out, size, **kw):
    """The JAX package's toy export at `size` px and the port's copy."""
    jcfg = JConfig(img_size=(size, size, 3), number_classes=2,
                   anchors=((16, 16), (32, 32)), block_count=1,
                   filter_count=32, compute_dtype="float32", **kw)
    v = JYoloV3(jcfg).init(jax.random.PRNGKey(0),
                           np.zeros((1, size, size, 3), np.float32),
                           train=False)
    jpath = jckpt.export_model(str(out / "jax"), v["params"],
                               v["batch_stats"], jcfg)
    p, s, cfg = jckpt.load_model(jpath)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tpath = ckpt.export_model(str(out / "port"), to_np(p), to_np(s),
                              ModelConfig.from_json(cfg.to_json()))
    return jpath, tpath


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    return export_pair(tmp_path_factory.mktemp("m64"), 64)


@pytest.fixture(scope="module")
def exports_int8(tmp_path_factory):
    """The plain stem, as tests/test_torch_inference_e2e.py's int8 export."""
    return export_pair(tmp_path_factory.mktemp("m64q"), 64,
                       stem_space_to_depth=False)


@pytest.fixture(scope="module")
def big_image(tmp_path_factory):
    folder = tmp_path_factory.mktemp("big")
    rng = np.random.RandomState(42)
    imwrite(rng.randint(0, 255, (150, 130, 3)).astype(np.uint8),
            os.path.join(folder, "big.png"))
    return str(folder)


def read_all(folder):
    out = {}
    for fn in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fn)) as fh:
            out[fn] = fh.read()
    return out


def assert_same_csvs(got, want):
    """X,Y,W,H,C identical; P within 2e-6."""
    assert sorted(got) == sorted(want) and want
    rows = 0
    for fn in want:
        g, w = got[fn].splitlines(), want[fn].splitlines()
        assert g[0] == w[0] == "X,Y,W,H,P,C" and len(g) == len(w), fn
        g = np.array([line.split(",") for line in g[1:]]).reshape(-1, 6)
        w = np.array([line.split(",") for line in w[1:]]).reshape(-1, 6)
        np.testing.assert_array_equal(g[:, [0, 1, 2, 3, 5]],
                                      w[:, [0, 1, 2, 3, 5]])
        np.testing.assert_allclose(g[:, 4].astype(float),
                                   w[:, 4].astype(float), rtol=0, atol=2e-6)
        rows += len(w)
    assert rows > 0


@pytest.mark.parametrize("host_nms", [False, True])
def test_same_csvs_as_jax_tiled_cli(exports, big_image, tmp_path, host_nms):
    jpath, tpath = exports
    kw = dict(tile_size=(64, 64), min_roi_size=4, batch_size=4,
              edge_range=0, use_host_nms=host_nms)
    jax_tiled_folder(big_image, "png", jpath, str(tmp_path / "jax"), **kw)
    ttiled.inference_image_folder(big_image, "png", tpath,
                                  str(tmp_path / "port"), device=CPU, **kw)
    assert_same_csvs(read_all(tmp_path / "port"), read_all(tmp_path / "jax"))


def test_ghost_zones_match_jax(tmp_path):
    """A 256 px export, 96 px ghost zones: 25 tiles of a 300 x 260 image
    in batches of 8, 8, 8 and 1; the culling and the shift to global
    coordinates as JAX's."""
    jpath, tpath = export_pair(tmp_path / "m256", 256)
    folder = tmp_path / "imgs"
    folder.mkdir()
    imwrite(np.random.RandomState(7).randint(0, 255, (300, 260, 3)).astype(
        np.uint8), str(folder / "a.png"))
    kw = dict(tile_size=(256, 256), min_roi_size=4, edge_range=96)
    jax_tiled_folder(str(folder), "png", jpath, str(tmp_path / "jax"), **kw)
    ttiled.inference_image_folder(str(folder), "png", tpath,
                                  str(tmp_path / "port"), device=CPU, **kw)
    assert_same_csvs(read_all(tmp_path / "port"), read_all(tmp_path / "jax"))


def test_int8_csvs_match_jax_tiled_cli(exports_int8, big_image, tmp_path,
                                       monkeypatch):
    """--int8, calibrated on the first image's first 8 tiles, one scale dict
    for both CLIs (the port's `calibrate` swapped for JAX's on the same
    tiles) and the JAX int8 path under the port's wiring (its three kernel
    flags, in interpret mode): boxes and classes identical, P within 2e-6
    (the float32 heads sum in different orders, as in the whole-image
    CLI's int8 test, tests/test_torch_inference_e2e.py)."""
    from yolov3_tpu.models import quantized as Q
    from yolov3_tpu_torch.models import quantized as TQ
    jpath, tpath = exports_int8
    p, st, jcfg = jckpt.load_model(jpath)
    kernels = dict(pointwise_pallas=True, conv3_pallas=True,
                   down_pallas=True, fused_interpret=True)
    monkeypatch.setattr(Q, "default_serving_kernels", lambda: dict(kernels))
    seen = []

    def jax_scales(_, images, pct):
        seen.append(images.shape)
        return Q.calibrate(p, st, jcfg, images.numpy(), percentile=pct)

    monkeypatch.setattr(TQ, "calibrate", jax_scales)
    kw = dict(tile_size=(64, 64), min_roi_size=4, batch_size=4,
              edge_range=0, use_int8=True)
    jax_tiled_folder(big_image, "png", jpath, str(tmp_path / "jax"), **kw)
    ttiled.inference_image_folder(big_image, "png", tpath,
                                  str(tmp_path / "port"), device=CPU, **kw)
    assert seen == [(8, 64, 64, 3)]
    assert_same_csvs(read_all(tmp_path / "port"), read_all(tmp_path / "jax"))


@pytest.mark.parametrize("int8", [False, True])
def test_host_nms_matches_device_nms(exports, big_image, tmp_path, int8):
    _, tpath = exports
    kw = dict(tile_size=(64, 64), min_roi_size=4, batch_size=4,
              edge_range=0, use_int8=int8, device=CPU)
    for tag, host in (("dev", False), ("host", True)):
        ttiled.inference_image_folder(big_image, "png", tpath,
                                      str(tmp_path / tag),
                                      use_host_nms=host, **kw)
    a = bbox.load_boxes_to_xywhc(str(tmp_path / "dev" / "big.csv"))
    b = bbox.load_boxes_to_xywhc(str(tmp_path / "host" / "big.csv"))
    assert a.shape[0] > 0
    np.testing.assert_array_equal(a, b)


def cli(tpath, images, out, *flags):
    ttiled.main(["--saved-model-filepath", tpath, "--output-folder", out,
                 "--image-folder", images, "--image-format", "png",
                 "--min-box-size", "4", "--tile-height", "64",
                 "--tile-width", "64", "--edge-range", "0", "--device", CPU,
                 *flags])


def test_main_writes_csvs(exports, big_image, tmp_path):
    _, tpath = exports
    out = str(tmp_path / "o")
    cli(tpath, big_image, out, "--batch-size", "3", "--int8",
        "--calib-percentile", "99.9")
    with open(os.path.join(out, "big.csv")) as fh:
        assert fh.readline().strip() == "X,Y,W,H,P,C"


def test_tile_size_must_match_the_export(exports, big_image, tmp_path):
    _, tpath = exports
    with pytest.raises(ValueError, match="must match"):
        ttiled.main(["--saved-model-filepath", tpath, "--output-folder",
                     str(tmp_path / "o"), "--image-folder", big_image,
                     "--image-format", "png", "--tile-height", "128",
                     "--tile-width", "128", "--edge-range", "0",
                     "--device", CPU])


def test_num_devices_is_not_ported(exports, big_image, tmp_path):
    """The flag once refused, now ported: `--num-devices 3` on the CPU
    (the CPU three times) shards each batch of 8 tiles (padded to 9)
    over three replicas and writes the one-device CSVs, in bf16 and with
    `--int8` (the scales calibrate once, on the first device)."""
    _, tpath = exports
    for extra in ([], ["--int8"]):
        outs = []
        for more in ([], ["--num-devices", "3"]):
            out = str(tmp_path / f"o{len(outs)}{len(extra)}")
            cli(tpath, big_image, out, *extra, *more)
            outs.append(read_all(out))
        assert outs[1] and outs[1] == outs[0]
