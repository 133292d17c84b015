"""The port's tools against the JAX package's: the dataset builder
(`data/builder.py`), evaluation (`utils/evaluation.py`), the anchor
finder (`find_anchors.py`, numpy k-means against scikit-learn's) and
the box-union helpers
(`ops/boxes.py`), the Keras weight importer (`utils/tf_import.py`), the last also through
the port's model alone on the golden fixtures.

Exact: the builder's stores (keys, record bytes, annotation lists), AP
and mAP, the importer's trees. Within 1e-3 relative: the anchor
centres and scores (two k-means implementations converging to one
optimum). The golden feature maps: the JAX tests' own tolerances
(tests/test_tf_import.py:89-146).
"""

import os
import random

import numpy as np
import pytest
import torch

from yolov3_tpu import find_anchors as janchors
from yolov3_tpu.data import builder as jbuilder
from yolov3_tpu.data import store as jstore
from yolov3_tpu.ops import boxes as jboxes
from yolov3_tpu.utils import evaluation as jeval
from yolov3_tpu.utils import tf_golden
from yolov3_tpu.utils import tf_import as jtf
from yolov3_tpu_torch import find_anchors as tanchors
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.data import builder as tbuilder
from yolov3_tpu_torch.data.imaging import imwrite
from yolov3_tpu_torch.models.yolo import YoloV3
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.utils import evaluation as teval
from yolov3_tpu_torch.utils import tf_import as ttf
from yolov3_tpu_torch.utils.checkpoint import _flatten, params_from_jax

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

@pytest.fixture
def dataset(tmp_path):
    """9 PNGs (uint8 RGB and uint16 gray) with their annotation CSVs, one
    image with no boxes."""
    rng = np.random.default_rng(0)
    images, csvs = tmp_path / "images", tmp_path / "csvs"
    images.mkdir()
    csvs.mkdir()
    for i in range(9):
        if i % 3 == 2:
            img = rng.integers(0, 65536, (24, 20), dtype=np.uint16)
        else:
            img = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
        imwrite(img, str(images / f"img{i}.png"))
        rows = [[rng.integers(0, 10), rng.integers(0, 10),
                 rng.integers(3, 10), rng.integers(3, 10), rng.integers(0, 3)]
                for _ in range(i % 4)]
        bbox.write_boxes_from_xywhc(np.asarray(rows).reshape(-1, 5),
                                    str(csvs / f"img{i}.csv"))
    return images, csvs


def read_store(path):
    r = jstore.RecordReader(str(path))
    out = [(k, bytes(r.get(k))) for k in r.keys()]
    r.close()
    with open(os.path.join(path, "annotation_list.csv")) as fh:
        return out, fh.read()


@pytest.mark.parametrize("uint8_cast", [False, True])
def test_builder_matches_jax(dataset, tmp_path, uint8_cast):
    images, csvs = dataset
    random.seed(11)
    jbuilder.build_database(str(images), str(csvs), str(tmp_path / "jax"),
                            "toy", 0.7, "png", preserve_dtype=not uint8_cast)
    tbuilder.main(["--image_folder", str(images), "--csv_folder", str(csvs),
                   "--output_folder", str(tmp_path / "port"),
                   "--dataset_name", "toy", "--train_fraction", "0.7",
                   "--image_format", "png", "--seed", "11"]
                  + (["--uint8_cast"] if uint8_cast else []))
    for name, n in (("train-toy.ydb", 6), ("test-toy.ydb", 3)):
        got = read_store(tmp_path / "port" / name)
        want = read_store(tmp_path / "jax" / name)
        assert len(got[0]) == n
        assert got == want


def test_builder_shuffle_takes_its_rng(dataset, tmp_path):
    images, csvs = dataset
    lists = []
    for seed in (1, 1, 2):
        out = tmp_path / f"s{len(lists)}"
        tbuilder.build_database(str(images), str(csvs), str(out), "t", 0.5,
                                "png", rng=random.Random(seed))
        lists.append(read_store(out / "train-t.ydb")[1])
    assert lists[0] == lists[1] != lists[2]


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def detections(seed, n_img=6):
    rng = np.random.default_rng(seed)
    preds, gts = {}, {}
    for i in range(n_img):
        gt = []
        for _ in range(rng.integers(0, 5)):
            x, y = rng.integers(0, 200, 2)
            w, h = rng.integers(10, 60, 2)
            gt.append([x, y, x + w - 1, y + h - 1, rng.integers(0, 3)])
        gt = np.asarray(gt, np.float64).reshape(-1, 5)
        boxes = [g[:4] + rng.normal(0, 4, 4) for g in gt
                 if rng.uniform() < 0.8]
        boxes += [np.r_[rng.integers(0, 200, 2), 0, 0] + [0, 0, 30, 30]
                  for _ in range(rng.integers(0, 3))]
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        preds[f"im{i}"] = (boxes, rng.uniform(0, 1, len(boxes)),
                           rng.integers(0, 4, len(boxes)).astype(np.int32))
        gts[f"im{i}"] = gt
    return preds, gts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("iou", [0.0, 0.2, 0.5])
def test_union_all_overlapping_bb_matches_jax(seed, iou):
    """`ops/boxes.py`'s box union helpers: clusters of overlapping
    boxes merge to their hulls, bit for bit as JAX's."""
    rng = np.random.default_rng(40 + seed)
    n = int(rng.integers(2, 12))
    lt = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([lt, lt + rng.uniform(5, 40, (n, 2))], 1)
    scores = rng.uniform(0, 1, n)
    got = bbox.union_all_overlapping_bb(boxes, scores, iou)
    want = jboxes.union_all_overlapping_bb(boxes, scores, iou)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    hull, weight = bbox.box_union(boxes, scores)
    jhull, jweight = jboxes.box_union(boxes, scores)
    np.testing.assert_array_equal(hull, jhull)
    assert weight == jweight
    for g, w in zip(bbox.union_all_overlapping_bb(boxes[:1], scores[:1]),
                    jboxes.union_all_overlapping_bb(boxes[:1], scores[:1])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("iou", [0.3, 0.5, 0.75])
def test_evaluate_detections_matches_jax(seed, iou):
    preds, gts = detections(seed)
    got = teval.evaluate_detections(preds, gts, iou)
    want = jeval.evaluate_detections(preds, gts, iou)
    assert got["mAP"] == want["mAP"]
    assert got["per_class_ap"].keys() == want["per_class_ap"].keys()
    for c, ap in want["per_class_ap"].items():
        assert got["per_class_ap"][c] == ap or (np.isnan(ap) and np.isnan(
            got["per_class_ap"][c]))


def test_evaluate_folders_matches_jax(tmp_path, capsys):
    preds, gts = detections(5)
    (tmp_path / "pred").mkdir()
    (tmp_path / "gt").mkdir()
    for name, (boxes, scores, cls) in preds.items():
        rows = np.concatenate([boxes, scores[:, None], cls[:, None]], 1)
        if name != "im3":  # a missing prediction file: all missed
            bbox.write_boxes_from_ltrbpc(rows, str(tmp_path / "pred" /
                                                   f"{name}.csv"))
        bbox.write_boxes_from_ltrbc(gts[name], str(tmp_path / "gt" /
                                                   f"{name}.csv"))
    got = teval.evaluate_folders(str(tmp_path / "pred"), str(tmp_path / "gt"))
    want = jeval.evaluate_folders(str(tmp_path / "pred"),
                                  str(tmp_path / "gt"))
    assert got == want and 0 < got["mAP"] < 1
    teval.main(["--pred_folder", str(tmp_path / "pred"),
                "--gt_folder", str(tmp_path / "gt")])
    assert f"mAP@0.5 = {want['mAP']:.4f}" in capsys.readouterr().out


def test_average_precision_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(5):
        r = np.sort(rng.uniform(0, 1, 12))
        p = rng.uniform(0, 1, 12)
        assert teval.average_precision(r, p) == jeval.average_precision(r, p)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

CLUSTERS = ((20, 20, 2), (100, 40, 6), (60, 140, 8), (180, 170, 9))


def plant_csvs(d, k):
    """Box sizes in k well-separated clusters (w, h, jitter): 12 CSVs of
    3 boxes a cluster."""
    rng = np.random.default_rng(k)
    d.mkdir()
    for i in range(12):
        rows = []
        for cw, ch, jit in CLUSTERS[:k]:
            for _ in range(3):
                dw, dh = rng.integers(-jit, jit + 1, 2)
                rows.append([5, 5, cw + dw, ch + dh, 0])
        bbox.write_boxes_from_xywhc(np.array(rows), str(d / f"im{i}.csv"))
    return str(d)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_find_anchors_matches_sklearn(tmp_path, k):
    csvs = plant_csvs(tmp_path / "csvs", k)
    got = tanchors.find_anchors(csvs, k_range=(k, k), plot_path=None)[k]
    want = janchors.find_anchors(csvs, k_range=(k, k), plot_path=None)[k]
    sizes = tanchors.collect_box_sizes(csvs)
    np.testing.assert_array_equal(sizes, janchors.collect_box_sizes(csvs))
    g = got[1][np.lexsort(got[1].T[::-1])]
    w = want[1][np.lexsort(want[1].T[::-1])]
    np.testing.assert_allclose(g, w, rtol=1e-3)
    # the score is sklearn's: the negative inertia at the port's centres
    d = ((sizes[:, None] - got[1][None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(got[0], -d.sum(), rtol=1e-12)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    assert sorted(map(tuple, np.round(g / 10).astype(int).tolist())) == \
        sorted((cw // 10, ch // 10) for cw, ch, _ in CLUSTERS[:k])


def test_find_anchors_cli_plots(tmp_path):
    plot = str(tmp_path / "plot.png")
    tanchors.main(["--csv_dirpath", plant_csvs(tmp_path / "csvs", 3),
                   "--plot_path", plot])
    assert os.path.getsize(plot) > 0
    with pytest.raises(ValueError, match="Not enough boxes"):
        tanchors.find_anchors(str(tmp_path), plot_path=None)


def test_kmeans_handles_fewer_distinct_points_than_clusters():
    x = np.array([[1.0, 1.0]] * 5 + [[9.0, 9.0]] * 5)
    centers, labels, inertia = tanchors.kmeans(
        x, 3, np.random.default_rng(0), n_init=2)
    assert inertia == 0.0 and len(centers) == 3
    assert np.isfinite(centers).all()


# ---------------------------------------------------------------------------
# Keras importer
# ---------------------------------------------------------------------------

def keras_fixture(block_count, filter_count, seed=0):
    shapes = ttf.reference_keras_shapes(2, 2, block_count=block_count,
                                        filter_count=filter_count)
    rng = np.random.RandomState(seed)
    out = {}
    for k, shp in shapes.items():
        v = (rng.randn(*shp) * 0.05).astype(np.float32)
        if k.endswith("moving_variance"):
            v = np.abs(v) + 0.5
        out[k] = v
    return out


def flat(tree):
    out = {}
    _flatten(tree, "", out)
    return out


@pytest.mark.parametrize("block_count", [1, 2, 8])
def test_importer_trees_match_jax(block_count):
    fc = 64 if block_count < 8 else 32
    assert ttf.reference_keras_shapes(2, 2, block_count=block_count,
                                      filter_count=fc) == \
        jtf.reference_keras_shapes(2, 2, block_count=block_count,
                                   filter_count=fc)
    assert ttf.conv_block_paths(block_count) == \
        jtf.conv_block_paths(block_count)
    weights = keras_fixture(block_count, fc)
    weights = {(f"{k}:0" if i % 2 else k): v
               for i, (k, v) in enumerate(weights.items())}
    for got, want in zip(ttf.import_keras_weights(weights, block_count),
                         jtf.import_keras_weights(weights, block_count)):
        got, want = flat(got), flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_load_npz_gives_the_state_dict(tmp_path):
    weights = keras_fixture(1, 64)
    np.savez(tmp_path / "w.npz", **weights)
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 16), (64, 64)), block_count=1,
                      filter_count=64, compute_dtype="float32",
                      upsample_channel_sum=True)
    state = ttf.load_npz(str(tmp_path / "w.npz"), cfg)
    want = params_from_jax(*jtf.import_keras_weights(weights, 1), cfg)
    assert state.keys() == want.keys() == YoloV3(cfg).state_dict().keys()
    for k in want:
        assert torch.equal(state[k], want[k])


def golden_maps(weights, cfg, x):
    model = YoloV3(cfg)
    params, stats = ttf.import_keras_weights(weights, cfg.block_count)
    model.load_state_dict(params_from_jax(params, stats, cfg))
    with torch.no_grad():
        return [f.numpy() for f in model.eval()(torch.from_numpy(x))]


@pytest.mark.parametrize("s2d", [False, True])
def test_golden_bc1_through_the_port(s2d):
    z = np.load(os.path.join(FIXTURES, "tf_golden_bc1.npz"))
    weights = {k: z[k] for k in z.files if not k.startswith("__")}
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 16), (32, 32)), block_count=1,
                      filter_count=64, compute_dtype="float32",
                      upsample_channel_sum=True, stem_space_to_depth=s2d)
    for fm, key in zip(golden_maps(weights, cfg, z["__input__"]),
                       ("__fm1__", "__fm2__", "__fm3__")):
        np.testing.assert_allclose(fm, z[key], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s2d", [False, True])
def test_golden_full_through_the_port(s2d):
    """The shipping topology (filter_count 1024, blocks 1,2,8,8,4); the
    weights regenerated from the fixture's seed, the outputs from the
    independent float64 transcription of the reference's walk."""
    z = np.load(os.path.join(FIXTURES, "tf_golden_full.npz"))
    seed, ncls, bc, fc = (int(v) for v in z["__meta__"])
    anchors = ((16, 16), (32, 32))
    weights = tf_golden.make_weights(seed, ncls, anchors, block_count=bc,
                                     filter_count=fc)
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=ncls,
                      anchors=anchors, block_count=bc, filter_count=fc,
                      compute_dtype="float32", upsample_channel_sum=True,
                      stem_space_to_depth=s2d)
    for fm, key in zip(golden_maps(weights, cfg, z["__input__"]),
                       ("__fm1__", "__fm2__", "__fm3__")):
        np.testing.assert_allclose(fm, z[key], rtol=1e-2, atol=1e-2)
