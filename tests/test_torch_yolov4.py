"""YOLOv4 (`models/yolov4.py`, darknet's `cfg/yolov4.cfg`) against the
benchmark's plain reference (`portbench/reference/yolov4.py`), on the CPU.

The model runs at its published widths on 64 x 64 images, its weights
seeded as the benchmark's (`portbench/loops/serve_yolov4.py::
make_weights`, BatchNorm statistics from the images), exported by
`export_model` and served by `make_serving_fn` as a user serves it.

Tolerances, and why:
- float32 feature maps within 2e-5 of the largest |value| of `Float`:
  the same convs summed by oneDNN in another order; the network keeps a
  perturbation about its size through its 110 convs (its BatchNorm
  scales keep Mish and LeakyReLU near-linear), so round-off stays at the
  f32 level;
- the decode within 1e-6 relative (2e-4 pixels at 64 px): the same
  formula with the centre's terms added in darknet's order;
- candidates (scores within 1e-5 in float32; bf16 serving exactly as
  `Bf16Serve` on the CPU, where both run the same bf16 convs; boxes within
  1 - IoU of 1e-4, the decode's rounding) and keep masks equal:
  `keep_diff` 0.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov3_tpu_torch import inference as inf
from yolov3_tpu_torch.config import InferenceConfig, ModelConfig
from yolov3_tpu_torch.models import yolo, yolov4
from yolov3_tpu_torch.ops import decode as D
from yolov3_tpu_torch.ops.kernels import conv_block as PW
from yolov3_tpu_torch.utils import checkpoint as ckpt
from yolov3_tpu_torch.utils import tracing

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
SEED = 2 ** 33 + 19
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))
V4 = dict(architecture="yolov4", number_classes=80, anchors=ANCHORS,
          scale_x_y=(1.2, 1.1, 1.05), leaky_relu_alpha=0.1, bn_epsilon=1e-5)
ICFG = dict(iou_threshold=0.45, score_threshold=0.5, min_box_size=0,
            max_boxes_per_class=128)
# a NIST export's model_config.json as the port wrote it before YOLOv4
OLD_NIST_JSON = (
    '{"img_size": [512, 512, 3], "number_classes": 2, "anchors": '
    '[[64, 384], [384, 64]], "compute_dtype": "bfloat16", '
    '"leaky_relu_alpha": 0.2, "bn_momentum": 0.99, "bn_epsilon": 0.001, '
    '"block_count": 8, "filter_count": 1024, "kernel_size": 3, '
    '"stem_space_to_depth": true, "use_pallas_pointwise": true, '
    '"upsample_channel_sum": false, "s2d_base_grads": false, '
    '"stem1_im2row_grads": false, "int8_train": false, '
    '"int8_train_static": false, "remat_blocks": false}')


def _portbench(name):
    if PORTBENCH not in sys.path:
        sys.path.append(PORTBENCH)
    return importlib.import_module(name)


def v4_config(px=64, **kw):
    return ModelConfig(img_size=(px, px, 3), **dict(V4, **kw))


def reference_model(cfg: ModelConfig) -> dict:
    """The reference's model dict of a program config."""
    return dict(img_size=list(cfg.img_size),
                number_classes=cfg.number_classes,
                number_anchors=cfg.number_anchors,
                anchors=[list(a) for a in cfg.anchors],
                scale_x_y=cfg.scale_x_y,
                leaky_relu_alpha=cfg.leaky_relu_alpha,
                bn_epsilon=cfg.bn_epsilon, compute_dtype=cfg.compute_dtype,
                use_pallas_pointwise=cfg.use_pallas_pointwise)


@pytest.fixture(scope="module")
def v4(tmp_path_factory):
    """Seeded weights at 64 px with their images' statistics, exported
    once under a bf16 config with the fused 1x1; a second export folder
    holds a float32 config beside the same weights file."""
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    R4 = _portbench("reference.yolov4")
    L = _portbench("loops.serve_yolov4")
    bf = v4_config(compute_dtype="bfloat16", use_pallas_pointwise=True)
    f32 = dataclasses.replace(bf, compute_dtype="float32",
                              use_pallas_pointwise=False)
    gen = torch.Generator().manual_seed(SEED)
    raw = torch.randint(0, 256, (4, 64, 64, 3), generator=gen,
                        dtype=torch.uint8)
    wts = L.make_weights(reference_model(bf), SEED, "cpu")
    R4.set_statistics(wts, reference_model(bf), R4.preprocess(raw))
    params, stats = L.flax_trees(wts)
    out = tmp_path_factory.mktemp("v4")
    path = ckpt.export_model(str(out / "bf16"), params, stats, bf)
    path32 = str(out / "f32" / ckpt.EXPORT_DIR)
    os.makedirs(path32)
    with open(os.path.join(path32, ckpt.CONFIG_FILE), "w") as fh:
        fh.write(f32.to_json())
    os.symlink(os.path.join(path, ckpt.WEIGHTS_FILE),
               os.path.join(path32, ckpt.WEIGHTS_FILE))
    return dict(R4=R4, L=L, wts=wts, raw=raw, path=path, path32=path32,
                params=params, stats=stats, bf=bf, f32=f32)


# --- the architecture --------------------------------------------------------

def test_layer_table_is_the_references_and_the_cfgs():
    """110 convs in the reference's order and shapes, 3 heads of 255;
    43 Mish and 20 LeakyReLU 1x1 stride-1 blocks; 7 stride-2 convs."""
    R4 = _portbench("reference.yolov4")
    table = yolov4.layer_table(3, 255)
    specs = R4.conv_specs(reference_model(v4_config(608)))
    assert [(f"conv_{t[0]}", *t[1:]) for t in table] == specs
    assert len(table) == 110
    heads = [t for t in table if t[5] == "linear"]
    assert [(t[0], t[2]) for t in heads] == [(138, 255), (149, 255),
                                              (160, 255)]
    pw = [t for t in table if t[3] == 1 and t[4] == 1 and t[5] != "linear"]
    assert sum(t[5] == "mish" for t in pw) == 43
    assert sum(t[5] == "leaky" for t in pw) == 20
    assert [t[0] for t in table if t[4] == 2] == [1, 11, 24, 55, 86, 141,
                                                  152]


def test_parameter_count_is_the_published_one():
    """64,363,101 parameters (darknet's 64.4 M): conv kernels, BatchNorm
    scales and offsets, head biases; the program's state_dict holds the
    same, plus each BatchNorm's two statistics."""
    R4 = _portbench("reference.yolov4")
    cfg = v4_config(608)
    n = sum(co * ci * k * k + (co if act == "linear" else 2 * co)
            for _, ci, co, k, _, act in R4.conv_specs(reference_model(cfg)))
    assert n == 64363101
    with torch.device("meta"):
        model = yolov4.YoloV4(cfg)
    assert sum(p.numel() for p in model.parameters()) == n
    bns = sum(m.running_mean.numel() for m in model.modules()
              if isinstance(m, yolo.BatchNorm))
    # 107 blocks: kernel, scale, offset, mean, variance; 3 heads: kernel,
    # bias
    assert len(model.state_dict()) == 107 * 5 + 3 * 2
    assert bns == sum(co for _, _, co, _, _, act in R4.conv_specs(
        reference_model(cfg)) if act != "linear")


def test_608_px_shapes():
    """At the published 608 px: heads on grids 76, 38, 19 of 255
    channels and 3 * (76^2 + 38^2 + 19^2) = 22,743 boxes."""
    cfg = v4_config(608)
    assert cfg.grid_sizes == [(76, 76), (38, 38), (19, 19)]
    assert cfg.number_anchors == 3 and cfg.number_output_boxes == 22743
    with torch.device("meta"):
        model = yolov4.YoloV4(cfg)
        fms = model(torch.empty(2, 608, 608, 3))
    assert [tuple(f.shape) for f in fms] == [(2, 76, 76, 255),
                                             (2, 38, 38, 255),
                                             (2, 19, 19, 255)]


# --- the configuration -------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    ModelConfig(img_size=(512, 512, 3), number_classes=2),
    v4_config(608), v4_config(64, compute_dtype="float32")])
def test_config_json_round_trip(cfg):
    assert ModelConfig.from_json(cfg.to_json()) == cfg


def test_old_nist_json_reads_and_writes_unchanged():
    cfg = ModelConfig.from_json(OLD_NIST_JSON)
    assert cfg.architecture == "nist_yolov3" and cfg.scale_x_y == ()
    assert cfg.number_anchors == 2 and cfg.strides == [32, 16, 8]
    assert cfg.to_json() == OLD_NIST_JSON


@pytest.mark.parametrize("kw", [
    dict(filter_count=512), dict(block_count=4), dict(remat_blocks=True),
    dict(scale_x_y=(1.2, 1.1)), dict(anchors=ANCHORS[:8]),
    dict(architecture="yolov5")])
def test_config_refuses_what_the_layer_table_fixes(kw):
    with pytest.raises(ValueError):
        v4_config(608, **kw)


def test_nist_config_refuses_scale_x_y():
    """The NIST detector's decode takes no `scale_x_y`: a config that sets
    it is refused rather than served without it."""
    with pytest.raises(ValueError, match="scale_x_y"):
        ModelConfig(img_size=(512, 512, 3), number_classes=2,
                    scale_x_y=(1.2, 1.1, 1.05))


# --- the ops -----------------------------------------------------------------

@pytest.mark.parametrize("stride,size", [(1, 19), (2, 64), (2, 20)])
def test_symmetric_padding(stride, size):
    """darknet pads k // 2 on every side: the reference's conv; TF-SAME
    (the NIST model's) differs at stride 2, where it pads the bottom and
    right only."""
    R4 = _portbench("reference.yolov4")
    g = torch.Generator().manual_seed(size + stride)
    x = torch.randn(2, size, size, 8, generator=g)
    w = torch.randn(16, 8, 3, 3, generator=g)
    got = yolov4.conv2d_darknet(x, w, None, stride)
    torch.testing.assert_close(got, R4.conv_pad(x, w, stride), rtol=1e-5,
                               atol=1e-5)
    same = yolo.conv2d_same(x, w, None, stride)
    assert same.shape == got.shape
    if stride == 1:
        torch.testing.assert_close(same, got)
    else:
        assert not torch.allclose(same, got, atol=1e-3)


def test_maxpool_pads_with_minus_inf():
    """SPP's pools at stride 1: an all-negative map keeps its border values
    (a zero pad would raise them to 0)."""
    R4 = _portbench("reference.yolov4")
    x = -1.0 - torch.rand(1, 19, 19, 4, generator=torch.Generator()
                          .manual_seed(1))
    for k in (5, 9, 13):
        got = yolov4.maxpool_same(x, k)
        assert float(got.max()) < 0
        torch.testing.assert_close(got, R4.maxpool(x, k))


def test_mish_plain_twin():
    """The fused 1x1's plain twin with act="mish" is y * tanh(softplus(y))
    (computed here in float64, softplus's threshold 20) of the f32 sums,
    then * mul + add, including |y| past the threshold."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(300, 64, generator=g) * 6).to(torch.bfloat16)
    w = torch.randn(48, 64, generator=g).to(torch.bfloat16)
    b, mul, add = (torch.randn(48, generator=g) for _ in range(3))
    got = PW.pointwise_conv_block_plain(x, w, b, mul, add, 0.1,
                                        torch.float32, act="mish")
    y = (x.double() @ w.double().t() + b.double())
    assert float(y.abs().max()) > 40
    sp = torch.where(y > 20, y, torch.log1p(torch.exp(y.clamp(max=20))))
    want = (y * torch.tanh(sp)) * mul.double() + add.double()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        PW.pointwise_conv_block(x, w, b, mul, add, 0.1, torch.float32,
                                act="swish")


def _nist_decode(fms, anchors, classes, strides):
    """The NIST decode's op sequence before scale_x_y existed."""
    out = []
    for fm, stride in zip(fms, strides):
        n, gh, gw, _ = fm.shape
        f = fm.to(torch.float32).reshape(n, gh, gw, len(anchors),
                                         5 + classes)
        row, col = torch.meshgrid(torch.arange(gh, dtype=torch.float32),
                                  torch.arange(gw, dtype=torch.float32),
                                  indexing="ij")
        off = torch.stack([col, row], dim=-1).reshape(gh, gw, 1, 2)
        xy = (torch.sigmoid(f[..., 0:2]) + off) * float(stride)
        wh = torch.exp(f[..., 2:4]) * torch.tensor(anchors,
                                                   dtype=torch.float32)
        boxes = torch.cat([xy, wh], dim=-1)
        xy, wh = boxes[..., 0:2], boxes[..., 2:4]
        out.append(torch.cat([xy - 0.5 * wh, xy + 0.5 * wh,
                              torch.sigmoid(f[..., 4:5]),
                              torch.sigmoid(f[..., 5:])], dim=-1)
                   .reshape(n, -1, 5 + classes))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("a,c", [(2, 2), (3, 80)])
def test_nist_decode_is_bit_equal_without_scale_x_y(a, c):
    g = torch.Generator().manual_seed(a * c)
    anchors = ANCHORS[:a]
    fms = [torch.randn(2, 64 // s, 64 // s, a * (5 + c), generator=g) * 3
           for s in (32, 16, 8)]
    want = _nist_decode(fms, anchors, c, (32, 16, 8))
    assert torch.equal(D.decode_detections(fms, anchors, c), want)
    assert torch.equal(D.decode_detections(fms, anchors, c, (32, 16, 8),
                                           scale_x_y=None), want)


def test_yolov4_decode_matches_the_reference():
    """Per-scale anchors and scale_x_y: darknet's yolo layer."""
    R4 = _portbench("reference.yolov4")
    cfg = v4_config(64)
    g = torch.Generator().manual_seed(7)
    fms = [torch.randn(2, gh, gw, 255, generator=g) * 2
           for gh, gw in cfg.grid_sizes]
    det = yolov4.YoloV4Detector(cfg)
    anchors = [getattr(det, f"anchors_{i}") for i in range(3)]
    got = D.decode_detections(fms, cfg.anchors, 80, cfg.strides,
                              scale_anchors=anchors,
                              scale_x_y=cfg.scale_x_y)
    want = R4.decode(fms, reference_model(cfg))
    assert got.shape == (2, cfg.number_output_boxes, 85)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=2e-4)


# --- the model against the reference -----------------------------------------

def test_float32_forward_matches_float(v4):
    R4 = v4["R4"]
    params, stats, cfg = ckpt.load_model(v4["path32"])
    model = ckpt.build_model(params, stats, cfg, "cpu")
    x = R4.preprocess(v4["raw"])
    with torch.no_grad():
        got = model.backbone(x)
        want = R4.forward(R4.Float(v4["wts"], reference_model(cfg)),
                          reference_model(cfg), x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=2e-5 * float(w.abs().max()))


def _served(path, raw, icfg=InferenceConfig(**ICFG)):
    serve, cfg = inf.make_serving_fn(path, icfg=icfg, device="cpu")
    with tracing.recording():
        tracing.clear()
        out = serve(inf.input_transform(cfg)(raw))
        spans = {s[0] for s in tracing.spans()}
        counts = tracing.counters()
    tracing.clear()
    return out, spans, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_candidates_and_keep_masks_match_the_reference(v4, dtype):
    """Through `export_model` and `make_serving_fn`: every image's
    candidates (scores, boxes) and keep masks against the reference's
    arithmetic of the same precision (`Float`, `Bf16Serve`)."""
    R4, L = v4["R4"], v4["L"]
    S = _portbench("loops.serve_closed")
    path = v4["path32"] if dtype == "float32" else v4["path"]
    cfg = v4["f32"] if dtype == "float32" else v4["bf"]
    model = reference_model(cfg)
    (boxes, scores, keep), spans, counts = _served(path, v4["raw"])
    assert scores.shape == (4, 80, 128)
    ar = (R4.Float if dtype == "float32" else R4.Bf16Serve)(v4["wts"], model)
    ref = L.reference_pool(ar, model, ICFG, v4["raw"], 4, "cpu")
    worst = S.compare([(0, (boxes, scores, keep))], ref, 4, 4, ICFG, 0.004)
    assert worst["compared"] == 4
    assert sum(len(s) for v in ref.values() for _, s in v) > 0
    assert worst["keep_diff"] == 0
    assert worst["score_gap"] <= (1e-5 if dtype == "float32" else 0.0)
    # the decode's centre terms add in another order
    assert worst["box_gap"] <= 1e-4
    assert {"yolo.serve", "yolo.stem", "yolo.backbone", "yolo.neck",
            "yolo.spp", "yolo.heads", "yolo.decode", "yolo.nms"} <= spans
    fused = dtype == "bfloat16"
    assert counts.get("pointwise.fused", 0) == (63 if fused else 0)
    assert counts.get("pointwise.plain", 0) == (0 if fused else 63)


def test_cli_serves_a_yolov4_export(v4, tmp_path):
    """`python -m yolov3_tpu_torch.inference` on the export: RGB / 255,
    one CSV an image with the boxes the serving function keeps under the
    CLI's thresholds."""
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(2):
        np.save(folder / f"im{i}.npy", v4["raw"][i].numpy())
    out = tmp_path / "csv"
    inf.main(["--saved-model-filepath", v4["path32"], "--image-folder",
              str(folder), "--image-format", "npy", "--output-folder",
              str(out), "--min-box-size", "0", "--max-boxes", "128",
              "--batch-size", "2", "--device", "cpu"])
    icfg = InferenceConfig(min_box_size=0, max_boxes_per_class=128)
    (boxes, _, keep), _, _ = _served(v4["path32"], v4["raw"][:2], icfg)
    for i in range(2):
        rows = np.loadtxt(out / f"im{i}.csv", delimiter=",", ndmin=2,
                          skiprows=1)
        assert len(rows) == int(keep[i].sum()) > 0
        kept = boxes[i][keep[i]].numpy()
        np.testing.assert_array_equal(np.sort(rows[:, 0]),
                                      np.sort(kept[:, 0].astype(np.int32)))


def test_int8_serving_refuses_yolov4(v4):
    from yolov3_tpu_torch.models import quantized
    with pytest.raises(ValueError, match="yolov4"):
        quantized.build_quantized_model(v4["params"], v4["stats"], v4["bf"],
                                        "cpu")


def test_eval_only(v4):
    model = yolov4.YoloV4(v4_config(64, compute_dtype="float32"))
    model.train()
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 64, 64, 3))
