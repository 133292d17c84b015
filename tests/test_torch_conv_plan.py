"""The tile planner of the wgmma core under the int8 1x1 and 3x3 and the
bf16 1x1 kernels (`yolov3_tpu_torch/ops/kernels/_conv_q.py::conv_plan`),
on the CPU.

The plan is pure Python: the kernels' C entry points check it and the
card tests (tests/test_torch_kernels_cuda.py) run every tile it can
choose. Here: every 1x1 and 3x3 launch shape of the flagship model (512
px, filter_count 1024, block_count 8) at batch 8 and 64 gets a plan that
has the least cost in the planner's model (the bytes an SM streams from
L2), keeps at least 120 of the card's 132 SMs busy, fits the shared
memory and the TMA box limits;
the shape list is checked against the launches of a small int8 forward.
The stride-2 3x3 plans too: on a float input (`down_conv_block_q`, the
converting producer) and on an s8 one (`exit_conv_block_q`, TMA at
element strides of 2, whose traversal box spans 2TH x 2TW).
"""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models import quantized as TQ
from yolov3_tpu_torch.models import yolo
from yolov3_tpu_torch.ops.kernels import _conv_q, conv_block
from yolov3_tpu_torch.utils.checkpoint import build_model, init_params

FLAGSHIP = dict(img=512, fc=1024, bc=8)


def launch_shapes(batch, img, fc, bc):
    """(x shape, Co) of each int8 1x1 and each 3x3 stride-1 launch of an
    int8 forward on the plain stem route (FeatureBlock_0 included), from
    the architecture (models/yolo.py: Darknet53, YoloV3)."""
    pw, c3 = [], []
    widths = [fc // 32, fc // 16, fc // 8, fc // 4, fc // 2, fc]
    size = img
    for reps, wd in zip([1, 2, bc, bc, bc // 2], widths[1:]):
        size //= 2
        for _ in range(reps):
            pw.append(((batch, size, size, wd), wd // 2))
            c3.append(((batch, size, size, wd // 2), wd))
    for stride, cin, f in ((32, fc, fc), (16, fc, fc // 2),
                           (8, fc // 2, fc // 4)):
        s = img // stride
        chans = [cin, f // 2, f, f // 2, f, f // 2, f]
        for i in range(6):
            (pw if i % 2 == 0 else c3).append(((batch, s, s, chans[i]),
                                               chans[i + 1]))
        if stride > 8:  # the neck 1x1 after the YoloBlock
            pw.append(((batch, s, s, f // 2), f // 2))
    return pw, c3


def test_launch_shapes_are_the_forwards():
    """The shape list is what an int8 forward launches: 64 px,
    filter_count 64, block_count 2, on the CPU (the plain versions)."""
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 48), (48, 16)), block_count=2,
                      filter_count=64, compute_dtype="float32",
                      stem_space_to_depth=False)
    params, stats = init_params(cfg, 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3)
                         .astype(np.float32))
    model = TQ.build_quantized_model(params, stats, cfg, "cpu")
    model.set_act_scales(TQ.calibrate(model, x))
    seen = {"pointwise_conv_block_q": [], "conv3x3_block_q": []}
    origs = {}
    for name, calls in seen.items():
        origs[name] = fn = getattr(TQ, name)

        def record(xq, w_t, *a, _fn=fn, _calls=calls, **kw):
            _calls.append((tuple(xq.shape), w_t.shape[1]))
            return _fn(xq, w_t, *a, **kw)

        setattr(TQ, name, record)
    try:
        with torch.no_grad():
            model(x)
    finally:
        for name, fn in origs.items():
            setattr(TQ, name, fn)
    pw, c3 = launch_shapes(2, 64, 64, 2)
    assert sorted(seen["pointwise_conv_block_q"]) == sorted(pw)
    assert sorted(seen["conv3x3_block_q"]) == sorted(c3)
    # the flagship: 33 1x1 and 31 3x3 launches on the default set, whose
    # stem region takes FeatureBlock_0's pair
    pw, c3 = launch_shapes(8, **FLAGSHIP)
    assert (len(pw), len(c3)) == (34, 32)


def flagship_cases():
    for batch in (8, 64):
        pw, c3 = launch_shapes(batch, **FLAGSHIP)
        for ksize, shapes in ((1, pw), (3, c3)):
            for shape, co in sorted(set(shapes)):
                yield batch, ksize, shape, co


@pytest.mark.parametrize("float_in", [False, True])
@pytest.mark.parametrize("batch,ksize,shape,co", list(flagship_cases()))
def test_flagship_plan_fills_the_card(batch, ksize, shape, co, float_in):
    """s8 inputs (TMA) and bf16 ones (the converting producer)."""
    n, h, w, ci = shape
    plan = _conv_q.conv_plan(n, h, w, ci, co, ksize, float_in)
    # the least cost of every tile, and a first wave on >= 120 of the 132
    # SMs (one 128 x 128 wave at 16^2, M * Co = 2,048 x 1,024)
    cost = _conv_q.plan_cost(plan, n, h, w, ci, co, ksize, float_in)
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 64) * 64:
            tw = bm if ksize == 1 else min(bm, 1 << (w - 1).bit_length())
            other = _conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, 2)
            assert cost <= _conv_q.plan_cost(other, n, h, w, ci, co, ksize,
                                             float_in)
    assert _conv_q.plan_tiles(plan, n, h, w, co, ksize) >= 120
    # the rectangle, the ring and the TMA boxes
    assert plan.th * plan.tw == plan.bm
    assert (plan.th, plan.tw) == ((1, plan.bm) if ksize == 1
                                  else (plan.bm // plan.tw, plan.tw))
    assert 2 <= plan.stages <= (_conv_q.FLOAT_MAX_STAGES if float_in
                                else _conv_q.MAX_STAGES)
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES
    assert max(plan.bk, plan.tw, plan.th, plan.bn) <= 256
    # one K step's box row is the swizzle span: 64 or 128 bytes, padding
    # Ci by less than 64
    assert plan.bk in (64, 128) and plan.bk * -(-ci // plan.bk) < ci + 64


@pytest.mark.parametrize("batch", [8, 64])
def test_flagship_plans_of_the_3x3s(batch):
    """The 3x3s at b8 take 128 x 128 tiles where 128 x 256 would idle half
    the card (16^2) and 128 x 256 where it keeps >= 128 SMs busy; the
    shallow 128^2 stage steps K by 64 bytes (Ci = 64)."""
    got = {h: tuple(_conv_q.conv_plan(batch, h, h, ci, co, 3))[:5]
           for h, ci, co in ((16, 512, 1024), (32, 256, 512),
                             (64, 128, 256), (128, 64, 128))}
    assert got[16] == ((128, 128, 128, 8, 16) if batch == 8
                       else (128, 256, 128, 8, 16))
    assert got[32] == (128, 256, 128, 4, 32)
    assert got[64] == (128, 256, 128, 2, 64)
    assert got[128] == (128, 128, 64, 1, 128)


def test_float_input_ties_take_two_producers():
    """A bf16-input 3x3 whose 128- and 64-pixel tiles cost the same takes
    BM = 64 (two producer warpgroups): 32^2 256 -> 512 at b8, one wave of
    128 x 256 tiles or two of 64 x 256."""
    plan = _conv_q.conv_plan(8, 32, 32, 256, 512, 3, True)
    other = plan._replace(bm=128, th=4, tw=32)
    assert (plan.bm, plan.bn) == (64, 256)
    assert _conv_q.plan_cost(plan, 8, 32, 32, 256, 512, 3, True) == \
        _conv_q.plan_cost(other, 8, 32, 32, 256, 512, 3, True)


def test_bf16_launch_shapes_are_the_forwards():
    """The bf16 model's fused 1x1 launches (`use_pallas_pointwise`) are
    the 1x1s of `launch_shapes`: 64 px, filter_count 64, block_count 2,
    on the CPU."""
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 48), (48, 16)), block_count=2,
                      filter_count=64, compute_dtype="bfloat16",
                      use_pallas_pointwise=True)
    params, stats = init_params(cfg, 0)
    model = build_model(params, stats, cfg, "cpu")
    seen = []
    orig = conv_block.pointwise_conv_block

    def record(x, w, *a, **kw):
        seen.append((x.shape[0], x.shape[1], w.shape[0]))
        return orig(x, w, *a, **kw)

    yolo.conv_block.pointwise_conv_block = record
    try:
        with torch.no_grad():
            model.backbone(torch.zeros(2, 64, 64, 3))
    finally:
        yolo.conv_block.pointwise_conv_block = orig
    pw, _ = launch_shapes(2, 64, 64, 2)
    assert sorted(seen) == sorted((n * h * w, ci, co)
                                  for (n, h, w, ci), co in pw)


def bf16_cases():
    for batch in (8, 64):
        pw, _ = launch_shapes(batch, **FLAGSHIP)
        for shape, co in sorted(set(pw)):
            yield batch, shape, co


@pytest.mark.parametrize("batch,shape,co", list(bf16_cases()))
def test_flagship_bf16_plan(batch, shape, co):
    """Every flagship bf16 1x1 (bf16 operands through TMA, 2-byte
    elements): a plan of the least cost that fits the shared memory, covers
    the output, and has BN <= Co rounded up to 32 (the Co = 32 launches
    take BN = 32)."""
    n, h, w, ci = shape
    m = n * h * w
    plan = _conv_q.conv_plan(1, 1, m, ci, co, 1, esize=2)
    assert plan.bn <= -(-co // 32) * 32 and (plan.bn == 32) == (co == 32)
    assert (plan.th, plan.tw) == (1, plan.bm)
    assert 2 <= plan.stages <= _conv_q.MAX_STAGES
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES
    # K steps of BK bytes over Ci's 2 * Ci bytes, padding less than 64
    assert plan.bk in (64, 128)
    assert plan.bk * -(-2 * ci // plan.bk) < 2 * ci + 64
    tiles = _conv_q.plan_tiles(plan, 1, 1, m, co, 1)
    assert tiles * plan.bm * plan.bn >= m * co
    assert tiles >= min(120, -(-m // 128) * -(-co // 256))
    cost = _conv_q.plan_cost(plan, 1, 1, m, ci, co, 1, esize=2)
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 32) * 32:
            other = _conv_q.Plan(bm, bn, plan.bk, 1, bm, 2)
            assert cost <= _conv_q.plan_cost(other, 1, 1, m, ci, co, 1,
                                             esize=2)


@pytest.mark.parametrize("m,ci,co", [(1000, 8, 8), (1, 64, 32),
                                     (4096, 768, 384), (130, 1024, 512)])
def test_bf16_plan_of_small_and_odd_shapes(m, ci, co):
    plan = _conv_q.conv_plan(1, 1, m, ci, co, 1, esize=2)
    assert plan.bn < co + 32 and plan.tw == plan.bm
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES


@pytest.mark.parametrize("n,h,w,ci,co,ksize,esize,float_in", [
    (1, 1, 64, 12, 64, 1, 2, False),    # Ci not a multiple of 8
    (1, 1, 64, 64, 36, 1, 2, False),    # Co not a multiple of 8
    (1, 8, 8, 64, 64, 3, 2, False),     # no bf16 3x3
    (1, 1, 64, 64, 64, 1, 2, True),     # bf16 operands come by TMA
    (1, 1, 64, 64, 64, 1, 4, False)])   # no 4-byte operands
def test_bf16_plan_raises_on_a_contract_it_cannot_meet(n, h, w, ci, co, ksize,
                                                       esize, float_in):
    with pytest.raises(ValueError):
        _conv_q.conv_plan(n, h, w, ci, co, ksize, float_in, esize)


@pytest.mark.parametrize("n,h,w,ci,co,ksize", [
    (1, 8, 8, 24, 64, 3),    # Ci not a multiple of 16
    (1, 8, 8, 64, 40, 1),    # Co not a multiple of 16
    (1, 8, 8, 64, 64, 5),    # neither 1x1 nor 3x3
    (0, 8, 8, 64, 64, 3),    # no pixels
    (1, 8, 8, 0, 64, 1)])    # no channels
def test_plan_raises_on_a_contract_it_cannot_meet(n, h, w, ci, co, ksize):
    with pytest.raises(ValueError):
        _conv_q.conv_plan(n, h, w, ci, co, ksize)


@pytest.mark.parametrize("n,h,w,ci,co,ksize", [
    (3, 5, 7, 64, 64, 3), (2, 9, 13, 16, 48, 3), (1, 3, 5, 64, 64, 1),
    (2, 300, 3, 32, 16, 3), (1, 1, 1, 1024, 1024, 1)])
def test_plan_of_small_and_odd_shapes(n, h, w, ci, co, ksize):
    """Tiles of tiny or ragged problems: a rectangle of BM pixels at least
    as wide as the image (up to BM), Co padded by less than 64."""
    plan = _conv_q.conv_plan(n, h, w, ci, co, ksize)
    assert plan.th * plan.tw == plan.bm and plan.bn < co + 64
    assert plan.tw >= min(plan.bm, w) or ksize == 1
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES



# --- the stride-2 3x3 (`down_conv_block_q`, bf16 or f32 input) ----------

def down_shapes(batch, img, fc):
    """(x shape, Co) of each stride-2 ConvBlock of the model: ConvBlock_1
    to ConvBlock_5 (models/yolo.py: Darknet53). The default set's stem
    region takes ConvBlock_1 and ConvBlock_2, so its serving call launches
    the last three; the tail and exit routes launch ConvBlock_1 too."""
    widths = [fc // 32, fc // 16, fc // 8, fc // 4, fc // 2, fc]
    return [((batch, img >> s, img >> s, widths[s]), widths[s + 1])
            for s in range(5)]


def test_down_shapes_are_the_forwards():
    """The stride-2 launches of an int8 forward on the plain stem route
    (64 px, filter_count 64, block_count 2, on the CPU) are
    `down_shapes`, each on a float input."""
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 48), (48, 16)), block_count=2,
                      filter_count=64, compute_dtype="float32",
                      stem_space_to_depth=False)
    params, stats = init_params(cfg, 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3)
                         .astype(np.float32))
    model = TQ.build_quantized_model(params, stats, cfg, "cpu")
    model.set_act_scales(TQ.calibrate(model, x))
    seen = []
    orig = TQ.down_conv_block_q

    def record(xq, w_t, *a, **kw):
        seen.append((tuple(xq.shape), w_t.shape[1], xq.dtype))
        return orig(xq, w_t, *a, **kw)

    TQ.down_conv_block_q = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        TQ.down_conv_block_q = orig
    assert sorted(s[:2] for s in seen) == sorted(down_shapes(2, 64, 64))
    assert all(s[2] in (torch.float32, torch.bfloat16) for s in seen)


def down_cases():
    for batch in (8, 64):
        for shape, co in down_shapes(batch, **{k: FLAGSHIP[k]
                                               for k in ("img", "fc")}):
            yield batch, shape, co


@pytest.mark.parametrize("batch,shape,co", list(down_cases()))
def test_flagship_stride2_plan(batch, shape, co):
    """Every flagship stride-2 launch at b8 and b64: a plan of the least
    cost, whose TH x TW rectangles tile the OH x OW output (TW the power of
    two >= OW, at most BM) on >= 120 of the 132 SMs (the 16^2 1024-channel
    output at b8 is 2,048 pixels: 128 tiles of 64 x 256), in the shared
    memory, at most FLOAT_MAX_STAGES stages (a float input)."""
    n, h, w, ci = shape
    oh, ow = -(-h // 2), -(-w // 2)
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, True, stride=2)
    assert plan.tw == min(plan.bm, 1 << (ow - 1).bit_length())
    assert plan.th * plan.tw == plan.bm
    tiles = _conv_q.plan_tiles(plan, n, oh, ow, co, 3)
    assert tiles == n * -(-oh // plan.th) * -(-ow // plan.tw) * -(-co //
                                                                  plan.bn)
    assert tiles * plan.bm * plan.bn >= n * oh * ow * co
    assert tiles >= 120
    assert 2 <= plan.stages <= _conv_q.FLOAT_MAX_STAGES
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES
    assert plan.bk in (64, 128) and plan.bk * -(-ci // plan.bk) < ci + 64
    cost = _conv_q.plan_cost(plan, n, h, w, ci, co, 3, True, stride=2)
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 32) * 32:
            tw = min(bm, 1 << (ow - 1).bit_length())
            other = _conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, 2)
            assert cost <= _conv_q.plan_cost(other, n, h, w, ci, co, 3, True,
                                             stride=2)


def test_stride2_costs_its_a_rows_more():
    """At stride 2 a float input's A rows count their L2 bytes 4 times
    (each input pixel read by ~2.25 taps, not 9): over the same output
    tiles, a 128 x 128 plan's K steps cost 7 + 1 rows of 128 instead of
    4 + 1."""
    plan = _conv_q.Plan(128, 128, 128, 2, 64, 4)
    s1 = _conv_q.plan_cost(plan, 8, 64, 64, 128, 256, 3, True)
    s2 = _conv_q.plan_cost(plan, 8, 128, 128, 128, 256, 3, True, stride=2)
    assert s2 * (_conv_q.FLOAT_A_COST + 1) == s1 * (_conv_q.FLOAT_A_COST + 4)


@pytest.mark.parametrize("stride", [1, 2])
def test_float_rows_of_a_bm64_block_cost_half(stride):
    """A BM = 64 block on a float input has two converting producer
    warpgroups (the block is three warpgroups, as at BM = 128): its A rows
    cost half as much as one producer's, and an s8 input's (TMA) are not
    weighted."""
    def cost(bm, float_in):
        plan = _conv_q.Plan(bm, 128, 128, 1, bm, 4)
        return _conv_q.plan_cost(plan, 1, stride, bm * stride, 128, 128, 3,
                                 float_in, stride=stride)

    a_cost = _conv_q.FLOAT_A_COST - 1 + stride * stride
    steps = 9
    assert cost(128, True) == steps * (128 * a_cost + 128) * 128
    assert cost(64, True) == steps * (64 * a_cost // 2 + 128) * 128
    assert cost(64, False) == steps * (64 + 128) * 128


@pytest.mark.parametrize("n,h,w,ci,co", [
    (1, 15, 17, 32, 64), (2, 9, 16, 64, 96), (1, 1, 1, 16, 16),
    (2, 300, 3, 32, 16)])
def test_stride2_plan_of_small_and_odd_shapes(n, h, w, ci, co):
    """Odd sizes (top/left pad 1) and tiny outputs: a rectangle at least
    as wide as the output (up to BM) that covers it."""
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, True, stride=2)
    oh, ow = -(-h // 2), -(-w // 2)
    assert plan.th * plan.tw == plan.bm and plan.tw >= min(plan.bm, ow)
    tiles = _conv_q.plan_tiles(plan, n, oh, ow, co, 3)
    assert tiles * plan.bm * plan.bn >= n * oh * ow * co
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES
    assert plan.stages <= _conv_q.FLOAT_MAX_STAGES


@pytest.mark.parametrize("ksize,float_in,esize,stride", [
    (1, True, 1, 2),     # no 1x1 stride 2
    (1, False, 1, 2),    # nor on an s8 x
    (3, True, 2, 2),     # no bf16 operands at stride 2
    (3, True, 1, 3)])    # stride 1 or 2 only
def test_stride2_plan_raises_on_a_contract_it_cannot_meet(ksize, float_in,
                                                          esize, stride):
    with pytest.raises(ValueError):
        _conv_q.conv_plan(8, 64, 64, 256, 512, ksize, float_in, esize,
                          stride=stride)


# --- the exit conv (`exit_conv_block_q`: an s8 input at stride 2, TMA) ---

def assert_s8_stride2_plan(plan, n, h, w, ci, co):
    """A plan of the least cost whose TH x TW rectangles tile the OH x OW
    output (TW the power of two >= OW, at most BM), whose strided TMA box
    (2TH x 2TW) stays within BOX_MAX, at most MAX_STAGES stages that fit
    the shared memory beside the staged output rows (the s8 stride-2
    path)."""
    oh, ow = -(-h // 2), -(-w // 2)
    assert plan.tw == min(plan.bm, 1 << (ow - 1).bit_length())
    assert plan.th * plan.tw == plan.bm
    assert 2 * plan.tw <= _conv_q.BOX_MAX and 2 * plan.th <= _conv_q.BOX_MAX
    tiles = _conv_q.plan_tiles(plan, n, oh, ow, co, 3)
    assert tiles == n * -(-oh // plan.th) * -(-ow // plan.tw) * -(-co //
                                                                  plan.bn)
    assert tiles * plan.bm * plan.bn >= n * oh * ow * co
    assert 2 <= plan.stages <= _conv_q.MAX_STAGES
    assert _conv_q.staged(plan, stride=2)
    assert _conv_q.smem_bytes(plan, True) <= _conv_q.SMEM_BYTES
    assert plan.bk in (64, 128) and plan.bk * -(-ci // plan.bk) < ci + 64
    cost = _conv_q.plan_cost(plan, n, h, w, ci, co, 3, stride=2)
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 32) * 32:
            tw = min(bm, 1 << (ow - 1).bit_length())
            other = _conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, 2)
            assert cost <= _conv_q.plan_cost(other, n, h, w, ci, co, 3,
                                             stride=2)


@pytest.mark.parametrize("batch", [8, 64])
def test_flagship_exit_plan(batch):
    """The flagship exit (ConvBlock_2: s8 256^2 x 64 -> 128, a 128^2
    output): 128 x 128 tiles of one output row (TW 128, a 256-pixel
    strided box), K steps of 64 bytes (Ci = 64), five stages beside the
    staged output rows, on every SM (1,024 tiles at b8)."""
    plan = _conv_q.conv_plan(batch, 256, 256, 64, 128, 3, stride=2)
    assert plan == _conv_q.Plan(128, 128, 64, 1, 128, 5)
    assert_s8_stride2_plan(plan, batch, 256, 256, 64, 128)
    assert _conv_q.plan_tiles(plan, batch, 128, 128, 128, 3) >= 1024


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 9, 13, 32, 64), (1, 9, 13, 16, 16), (3, 5, 7, 64, 48),
    (2, 300, 3, 32, 16), (1, 1, 1, 16, 16), (2, 16, 500, 64, 128)])
def test_s8_stride2_plan_of_small_and_odd_shapes(n, h, w, ci, co):
    """Odd sizes (SAME pads 1 top/left), outputs narrower than BM and one
    wider than the box (OW 250: TW stays at BM <= 128)."""
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, stride=2)
    assert_s8_stride2_plan(plan, n, h, w, ci, co)


def test_s8_stride2_costs_its_a_rows_once_a_tap():
    """TMA lands only the pixels at the stride, so an s8 input's A rows
    count once a tap as at stride 1: the exit's plan costs what the same
    plan costs on a stride-1 3x3 of the same output; a float input's rows
    cost FLOAT_A_COST - 1 + 4 times as much over its producers."""
    plan = _conv_q.Plan(128, 128, 64, 1, 128, 5)
    s2 = _conv_q.plan_cost(plan, 8, 256, 256, 64, 128, 3, stride=2)
    assert s2 == _conv_q.plan_cost(plan, 8, 128, 128, 64, 128, 3)
    assert s2 == 8 * 9 * (128 + 128) * 64
    f2 = _conv_q.plan_cost(plan, 8, 256, 256, 64, 128, 3, True, stride=2)
    assert f2 == 8 * 9 * (128 * (_conv_q.FLOAT_A_COST + 3) + 128) * 64


def test_exit_launch_of_the_small_model():
    """The exit launch of a small int8 forward under {exit_pallas} (64
    px, filter_count 256, block_count 1, on the CPU): one launch, s8 in,
    whose channels the kernel takes, and the plan `_conv_q.launch` would
    give it on the card (the same as for its shape at any other batch)."""
    cfg = ModelConfig(img_size=(64, 64, 3), number_classes=2,
                      anchors=((16, 48), (48, 16)), block_count=1,
                      filter_count=256, compute_dtype="float32")
    params, stats = init_params(cfg, 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3)
                         .astype(np.float32))
    kernels = {"exit_pallas": True}
    model = TQ.build_quantized_model(params, stats, cfg, "cpu",
                                     kernels=kernels)
    model.set_act_scales(TQ.calibrate(model, x))
    assert model.region_route(64, 64, kernels) == "exit"
    seen = []
    orig = TQ.exit_conv_block_q

    def record(xq, w_t, epi, **kw):
        seen.append((xq.dtype, tuple(xq.shape), tuple(w_t.shape),
                     tuple(epi.shape)))
        return orig(xq, w_t, epi, **kw)

    TQ.exit_conv_block_q = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        TQ.exit_conv_block_q = orig
    assert len(seen) == 1
    dtype, (n, h, w, ci), (taps, co, wci), epi = seen[0]
    assert dtype == torch.int8 and (taps, wci) == (9, ci) and epi == (4, co)
    assert (n, h, w, ci, co) == (2, 32, 32, 16, 32)
    assert ci % 16 == 0 and co % 16 == 0
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, False, stride=2)
    assert_s8_stride2_plan(plan, n, h, w, ci, co)
    assert (plan.th, plan.tw) == (plan.bm // 16, 16)


@pytest.mark.parametrize("bm,bn,stages,fits", [
    (128, 128, 5, True), (128, 128, 12, True), (128, 128, 13, False),
    (128, 256, 7, True), (128, 256, 8, False), (64, 32, 5, True)])
def test_staged_rows_mirror_the_kernel(bm, bn, stages, fits):
    """The s8 output is staged in shared memory only on the s8 stride-2
    path, when BM rows of BN + 16 bytes fit beside the ring
    (csrc/conv_gemm_q_sm90.cuh::launch's rule); never at stride 1 or on
    a float input."""
    plan = _conv_q.Plan(bm, bn, 64, 1, bm, stages)
    assert _conv_q.staged(plan, stride=2) == fits
    assert _conv_q.smem_bytes(plan, True) == (
        _conv_q.smem_bytes(plan) + bm * (bn + 16))
    assert _conv_q.smem_bytes(plan) == (
        1024 + stages * ((bm + bn) * 64 + 16) + bm // 64 * 16 * bn)
    assert not _conv_q.staged(plan)
    assert not _conv_q.staged(plan, True, 2)
