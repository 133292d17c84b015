"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build the kernels from
`yolov3_tpu_torch/csrc/`) and skip elsewhere. They import neither JAX nor
the JAX package, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.ops.kernels import _build
from yolov3_tpu_torch.ops.kernels import conv_block as PW
from yolov3_tpu_torch.ops.kernels import nms_suppress as NMS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sorted_candidates(rng, c, k):
    xy = rng.rand(c, k, 2).astype(np.float32) * 100
    wh = rng.rand(c, k, 2).astype(np.float32) * 40 + 1
    cand = np.concatenate([xy, xy + wh], axis=-1)
    counts = rng.randint(0, k + 1, c)
    valid = np.arange(k)[None, :] < counts[:, None]
    return cand, valid


@pytest.mark.parametrize("c,k,sparse", [
    (128, 512, False), (128, 512, True), (3, 40, True), (2, 3000, True),
    # serving b8 saturated; K around the 64-slot mask words
    (16, 512, False), (3, 1, False), (3, 63, False), (3, 64, False),
    (3, 65, False), (3, 65, True), (3, 513, False), (2, 3000, False)])
def test_nms_kernel_bit_equal_to_plain(cuda, c, k, sparse):
    """Keep masks bit-equal to the plain version and to the first design
    (the chain twin); one launch counted a call."""
    cand, valid = sorted_candidates(np.random.RandomState(c + k), c, k)
    if not sparse:
        valid[:] = True
    ct, vt = torch.from_numpy(cand), torch.from_numpy(valid)
    want = NMS.suppress_boxes_plain(ct, vt, 0.3)
    before = _build.launch_counts[NMS.NAME]
    got = NMS.suppress_boxes_t(ct.to(cuda), vt.to(cuda), 0.3)
    torch.cuda.synchronize()
    assert _build.launch_counts[NMS.NAME] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, NMS.suppress_boxes_chain(ct.to(cuda),
                                                     vt.to(cuda), 0.3))


def test_nms_kernel_tie_chain_across_word_boundaries(cuda):
    """130 slots, each box overlapping the next at IoU exactly 50/150 and
    the one after not at all: all kept at that threshold (ties survive),
    the even slots only just below it."""
    k = 130
    i = torch.arange(k, dtype=torch.float32)
    cand = torch.stack([torch.zeros(k), 5 * i, torch.full((k,), 10.0),
                        5 * i + 10], -1)[None].to(cuda)
    valid = torch.ones(1, k, dtype=torch.bool, device=cuda)
    tie = 50.0 / 150.0
    for thr, expect in ((tie, torch.ones(k, dtype=torch.bool)),
                        (tie - 1e-4, torch.arange(k) % 2 == 0)):
        got = NMS.suppress_boxes_t(cand, valid, thr)
        assert torch.equal(got[0].cpu(), expect)
        assert torch.equal(got, NMS.suppress_boxes_chain(cand, valid, thr))


def test_nms_kernel_threshold_tie_and_degenerate(cuda):
    cand = torch.tensor([[[0, 0, 10, 10], [0, 5, 10, 15], [0, 0, 0, 0],
                          [0, 0, 0, 0]]], dtype=torch.float32, device=cuda)
    valid = torch.ones(1, 4, dtype=torch.bool, device=cuda)
    iou = 50.0 / 150.0
    assert NMS.suppress_boxes(cand, valid, iou).tolist() == [[True] * 4]
    assert NMS.suppress_boxes(cand, valid, iou - 1e-4).tolist() == [
        [True, False, True, True]]


def test_nms_kernel_raises_on_wrong_dtype(cuda):
    cand = torch.zeros(2, 8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        NMS.suppress_boxes_t(cand, torch.ones(2, 8, dtype=torch.bool,
                                              device=cuda), 0.3)


def pointwise_case(rng, m, ci, co, cuda):
    """x [m, ci] bf16, w [co, ci] bf16 (the kernel's K-major layout) and
    the f32 bias, mul and add of a random block."""
    x = torch.from_numpy(rng.randn(m, ci).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(ci, co) / np.sqrt(ci)).astype(
        np.float32)).t().contiguous().to(cuda, torch.bfloat16)
    b, mul, add = (torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (
        0.1 * rng.randn(co), rng.uniform(0.8, 1.2, co), 0.1 * rng.randn(co)))
    return x, w, b, mul, add


def pointwise_close_to_plain_and_wmma(args, out, plan=None):
    """The sm90 kernel within rtol = atol = 2e-2 of the plain version and
    of the WMMA twin, one launch counted."""
    want = PW.pointwise_conv_block_plain(*args, 0.2, out)
    before = _build.launch_counts[PW.NAME]
    got = PW.pointwise_conv_block(*args, 0.2, out, plan=plan)
    torch.cuda.synchronize()
    assert _build.launch_counts[PW.NAME] == before + 1
    assert got.dtype == out and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    twin = PW.pointwise_conv_block_wmma(*args, 0.2, out)
    torch.testing.assert_close(got.float(), twin.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("m,ci,co,out", [
    (1000, 64, 32, torch.bfloat16), (4096, 768, 384, torch.bfloat16),
    (130, 1024, 512, torch.float32), (64, 8, 8, torch.float32)])
def test_pointwise_kernel_matches_plain(cuda, m, ci, co, out):
    args = pointwise_case(np.random.RandomState(m + ci), m, ci, co, cuda)
    pointwise_close_to_plain_and_wmma(args, out)


@pytest.mark.parametrize("tile", range(8))
@pytest.mark.parametrize("bk", [64, 128])
def test_pointwise_every_plan(cuda, tile, bk):
    """Each tile the planner can choose (BN 32 to 256), BK 64 and 128
    bytes, 2-5 stages (fewer where shared memory holds fewer): ragged M =
    1000, Ci 192 (6 or 3 K steps, the last half zero-filled at BK 128)."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    bm, bn = _conv_q.TILES[tile]
    stages = 2 + (tile + bk) % 4
    while _conv_q.smem_bytes(_conv_q.Plan(bm, bn, bk, 1, bm, stages)) \
            > _conv_q.SMEM_BYTES:
        stages -= 1
    plan = _conv_q.Plan(bm, bn, bk, 1, bm, stages)
    args = pointwise_case(np.random.RandomState(tile + bk), 1000, 192, 256,
                          cuda)
    pointwise_close_to_plain_and_wmma(args, torch.bfloat16, plan)


@pytest.mark.parametrize("m,ci,co,out", [
    (8 * 256 * 256, 64, 32, torch.bfloat16),   # the flagship's Co 32
    (777, 64, 48, torch.float32), (333, 768, 384, torch.bfloat16),
    (2048, 768, 384, torch.float32), (50, 64, 384, torch.bfloat16),
    (8 * 16 * 16, 1024, 512, torch.bfloat16), (1, 64, 32, torch.float32)])
def test_pointwise_edges(cuda, m, ci, co, out):
    """Co 32, 48 and 384, Ci 64 and 768, M < BM and ragged, both outputs,
    under the planner's tiles."""
    args = pointwise_case(np.random.RandomState(m + co), m, ci, co, cuda)
    pointwise_close_to_plain_and_wmma(args, out)


@pytest.mark.parametrize("m,ci,co,folded", [
    (304 * 304, 64, 64, True), (304 * 304, 64, 32, True),
    (304 * 304, 128, 64, True), (2 * 152 * 152, 128, 64, True),
    (2 * 152 * 152, 64, 64, False), (2 * 76 * 76, 256, 128, True),
    (2 * 38 * 38, 512, 256, True), (2 * 19 * 19, 1024, 512, True),
    (2 * 19 * 19, 1024, 1024, False), (777, 64, 48, False)])
def test_pointwise_mish_matches_plain(cuda, m, ci, co, folded):
    """The Mish entry at YOLOv4's 1x1 shapes (608 px, b1-b2; a ragged one)
    within rtol = atol = 2e-2 of its plain twin, one launch counted under
    its own name; `folded` with mul 1 and add 0, as the model launches
    it."""
    x, w, b, mul, add = pointwise_case(np.random.RandomState(m + co), m, ci,
                                       co, cuda)
    if folded:
        mul, add = torch.ones_like(mul), torch.zeros_like(add)
    want = PW.pointwise_conv_block_plain(x, w, b, mul, add, 0.1,
                                         torch.bfloat16, act="mish")
    before = _build.launch_counts[PW.MISH]
    got = PW.pointwise_conv_block(x, w, b, mul, add, 0.1, torch.bfloat16,
                                  act="mish")
    torch.cuda.synchronize()
    assert _build.launch_counts[PW.MISH] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_pointwise_kernel_raises_on_f32_input(cuda):
    x = torch.zeros(64, 64, device=cuda)
    w = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
    z = torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        PW.pointwise_conv_block(x, w, z, z, z, 0.2, torch.float32)


def test_pointwise_kernel_raises_on_a_plan_it_cannot_run(cuda):
    from yolov3_tpu_torch.ops.kernels import _conv_q
    args = pointwise_case(np.random.RandomState(0), 256, 64, 64, cuda)
    for plan in (_conv_q.Plan(128, 256, 128, 1, 128, 5),   # shared memory
                 _conv_q.Plan(128, 96, 128, 1, 128, 3),    # BN
                 _conv_q.Plan(128, 64, 32, 1, 128, 3)):    # BK
        with pytest.raises(RuntimeError):
            PW.pointwise_conv_block(*args, 0.2, torch.bfloat16, plan=plan)


def int8_block(rng, k, ci, co, scale=0.05):
    """s8 weights [k*k, co, ci] and the folded epi rows of a random block."""
    from yolov3_tpu_torch.ops import quant
    w = torch.from_numpy((rng.randn(co, ci, k, k) / np.sqrt(k * k * ci))
                         .astype(np.float32))
    b, g, o, m = (torch.from_numpy(v.astype(np.float32)) for v in (
        0.1 * rng.randn(co), rng.uniform(0.8, 1.2, co), 0.1 * rng.randn(co),
        0.1 * rng.randn(co)))
    mul, add = quant.bn_affine(g, o, m, torch.from_numpy(
        rng.uniform(0.5, 1.5, co).astype(np.float32)), 1e-3)
    return quant.fold_conv_block(w, b, mul, add, scale)


def int8_input(rng, shape, kind, cuda):
    if kind == "s8":
        return torch.from_numpy(rng.randint(-127, 128, shape).astype(
            np.int8)).to(cuda)
    x = torch.from_numpy((rng.randn(*shape) * 2).astype(np.float32))
    return x.to(cuda, torch.bfloat16 if kind == "bf16" else torch.float32)


def assert_int8_close(got, want):
    """s8 codes within 1; float outputs within a bf16 ulp."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max() <= 1
        else:
            d = (g.float() - w.float()).abs()
            assert bool((d <= 2.0 ** -7 * w.float().abs() + 1e-6).all())


def launched(mod, fn):
    before = _build.launch_counts[mod.NAME]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts[mod.NAME] == before + 1
    return out


@pytest.mark.parametrize("shape,co,kind,res,emit_s8,out", [
    ((2, 9, 7, 64), 32, "s8", False, True, None),
    ((2, 16, 16, 64), 32, "bf16", True, True, None),
    ((2, 16, 16, 256), 128, "bf16", False, True, torch.bfloat16),
    ((1, 8, 8, 128), 256, "f32", False, False, torch.float32),
    ((8, 16, 16, 1024), 512, "s8", False, True, None)])
def test_pointwise_q_matches_plain(cuda, shape, co, kind, res, emit_s8, out):
    from yolov3_tpu_torch.ops.kernels import pointwise_q as K
    rng = np.random.RandomState(shape[-1] + co)
    w_t, epi = int8_block(rng, 1, shape[-1], co)
    x = int8_input(rng, shape, kind, cuda)
    rq = int8_input(rng, shape, "s8", cuda) if res else None
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, residual_q=rq,
              res_scale=0.03, emit_s8=emit_s8, out_dtype=out)
    w_t, epi = w_t.to(cuda), epi.to(cuda)
    got = launched(K, lambda: K.pointwise_conv_block_q(x, w_t, epi, **kw))
    assert_int8_close(got, K.pointwise_conv_block_q_plain(x, w_t, epi, **kw))


@pytest.mark.parametrize("shape,co,kind,res,emit_s8,out,cast", [
    ((2, 16, 16, 32), 64, "s8", True, True, None, True),
    ((2, 10, 12, 32), 64, "s8", True, False, torch.bfloat16, True),
    ((2, 16, 16, 64), 128, "bf16", False, False, torch.bfloat16, True),
    ((1, 8, 8, 32), 64, "f32", False, False, torch.float32, False),
    ((2, 16, 16, 512), 1024, "s8", True, True, torch.bfloat16, False)])
def test_conv3x3_q_matches_plain(cuda, shape, co, kind, res, emit_s8, out,
                                 cast):
    from yolov3_tpu_torch.ops.kernels import conv3x3_q as K
    rng = np.random.RandomState(shape[1] + co)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, shape[-1], co))
    x = int8_input(rng, shape, kind, cuda)
    rq = int8_input(rng, shape[:3] + (co,), "s8", cuda) if res else None
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, cast_bf16=cast,
              residual_q=rq, res_scale=0.03, emit_s8=emit_s8, out_dtype=out)
    got = launched(K, lambda: K.conv3x3_block_q(x, w_t, epi, **kw))
    assert_int8_close(got, K.conv3x3_block_q_plain(x, w_t, epi, **kw))


@pytest.mark.parametrize("shape,co,kind,emit_s8,out", [
    ((2, 32, 32, 32), 64, "bf16", True, None),
    # odd H and W: XLA's SAME puts a zero row / column on each side
    ((1, 15, 17, 32), 64, "bf16", True, None),
    ((2, 8, 8, 64), 128, "f32", False, torch.float32),
    ((8, 32, 32, 512), 1024, "bf16", True, None),
    ((2, 9, 16, 64), 96, "bf16", True, torch.bfloat16),   # odd H, even W
    ((1, 16, 11, 48), 48, "f32", True, None),             # even H, odd W
    ((3, 5, 7, 16), 32, "bf16", False, torch.bfloat16),   # OH*OW < BM
    ((1, 1, 1, 16), 16, "f32", True, torch.float32)])
def test_down_conv_q_matches_plain(cuda, shape, co, kind, emit_s8, out):
    """The stride-2 kernel (wgmma core) equal to its plain version and to
    its WMMA twin: 0 s8 codes differ, float outputs bit-equal."""
    from yolov3_tpu_torch.ops.kernels import down_conv_q as K
    rng = np.random.RandomState(shape[1] + co)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, shape[-1], co))
    x = int8_input(rng, shape, kind, cuda)
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, cast_bf16=kind == "bf16",
              emit_s8=emit_s8, out_dtype=out)
    got = launched(K, lambda: K.down_conv_block_q(x, w_t, epi, **kw))
    assert_int8_equal(got, K.down_conv_block_q_plain(x, w_t, epi, **kw))
    assert_int8_equal(got, down_conv_wmma(x, w_t, epi, kw))


def down_conv_wmma(x, w_t, epi, kw, plan=None, wmma=True):
    """The stride-2 contract through `_conv_q.launch` on the WMMA twin
    (or, with `wmma=False`, on the wgmma kernel under `plan`)."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    return _conv_q.launch("down_conv_block_q", x, w_t, epi, ksize=3,
                          stride=2, plan=plan, wmma=wmma, **kw)


@pytest.mark.parametrize("shape,co", [
    ((8, 512, 512, 32), 64), ((8, 128, 128, 128), 256),
    ((8, 64, 64, 256), 512), ((8, 32, 32, 512), 1024)])
def test_down_conv_every_plan_at_flagship_shapes(cuda, shape, co):
    """Each tile plan `conv_plan` can give at the flagship's stride-2
    launches (b8, bf16 in; ConvBlock_1 on the tail and exit routes, then
    ConvBlock_3-5): the plan's own and every other tile of TILES with its
    TW rule and the stage count that fits, each equal to the plain version
    and the WMMA twin."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    from yolov3_tpu_torch.ops.kernels import down_conv_q as K
    rng = np.random.RandomState(shape[1] + co)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, shape[-1], co))
    x = int8_input(rng, shape, "bf16", cuda)
    kw = dict(inv_in=0.5, inv_next=9.0, alpha=0.2, cast_bf16=True,
              emit_s8=True, out_dtype=None)
    want = K.down_conv_block_q_plain(x, w_t, epi, **kw)
    assert_int8_equal(down_conv_wmma(x, w_t, epi, kw), want)
    n, h, w, ci = shape
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, True, stride=2)
    ow = -(-w // 2)
    plans = {plan}
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 32) * 32:
            tw = min(bm, 1 << (ow - 1).bit_length())
            plans.add(max(
                (_conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, stages)
                 for stages in range(2, _conv_q.FLOAT_MAX_STAGES + 1)),
                key=lambda q: (_conv_q.smem_bytes(q) <= _conv_q.SMEM_BYTES,
                               q.stages)))
    for p in sorted(plans):
        assert_int8_equal(down_conv_wmma(x, w_t, epi, kw, plan=p,
                                         wmma=False), want)


def test_down_conv_inv_next_row_and_plans_it_cannot_run(cuda):
    """A [4, Co] epi (1/s_next per channel in row 3); a plan whose
    rectangle is not BM pixels, and a stride-2 launch on an s8 x, are
    refused."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    from yolov3_tpu_torch.ops.kernels import down_conv_q as K
    rng = np.random.RandomState(4)
    w_t, epi = (t.to(cuda) for t in int8_block(rng, 3, 64, 96))
    x = int8_input(rng, (2, 20, 24, 64), "bf16", cuda)
    inv = torch.from_numpy(rng.uniform(4, 12, 96).astype(np.float32)).to(cuda)
    kw = dict(inv_in=0.5, alpha=0.2, cast_bf16=True)
    got = K.down_conv_block_q(x, w_t, torch.cat([epi, inv[None]]),
                              inv_next=0.0, **kw)
    assert_int8_equal(got, K.down_conv_block_q_plain(x, w_t, epi,
                                                     inv_next=inv, **kw))
    with pytest.raises(RuntimeError):
        down_conv_wmma(x, w_t, epi, dict(kw, inv_next=9.0),
                       plan=_conv_q.Plan(128, 128, 64, 3, 32, 4), wmma=False)
    with pytest.raises(RuntimeError):
        down_conv_wmma(int8_input(rng, (2, 20, 24, 64), "s8", cuda), w_t,
                       epi, dict(kw, inv_next=9.0),
                       plan=_conv_q.Plan(128, 128, 64, 8, 16, 4), wmma=False)


def test_int8_sums_exact_beyond_f32(cuda):
    """9 * 1024 * 127^2 ~ 1.5e8 > 2^24: the kernel sums in int32."""
    from yolov3_tpu_torch.ops.kernels import conv3x3_q as K
    x = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8, device=cuda)
    w_t = torch.full((9, 16, 1024), 127, dtype=torch.int8, device=cuda)
    w_t[0, 0, 0] = 126
    epi = torch.stack([torch.zeros(16), torch.ones(16), torch.zeros(16)]).to(
        cuda)
    y = K.conv3x3_block_q(x, w_t, epi, inv_in=1.0, inv_next=1.0, alpha=0.2,
                          cast_bf16=False, emit_s8=False,
                          out_dtype=torch.float32)
    assert y[0, 1, 1, 0].item() == np.float32(9 * 1024 * 127 * 127 - 127)


def test_int8_kernels_raise_on_what_they_do_not_take(cuda):
    from yolov3_tpu_torch.ops.kernels import down_conv_q, pointwise_q
    w_t = torch.zeros(1, 16, 24, dtype=torch.int8, device=cuda)
    epi = torch.zeros(3, 16, device=cuda)
    with pytest.raises(ValueError):  # Ci = 24 is not a multiple of 16
        pointwise_q.pointwise_conv_block_q(
            torch.zeros(1, 4, 4, 24, dtype=torch.int8, device=cuda), w_t,
            epi, inv_in=1.0, inv_next=1.0, alpha=0.2)
    with pytest.raises(TypeError):  # the stride-2 block takes floats
        down_conv_q.down_conv_block_q(
            torch.zeros(1, 4, 4, 16, dtype=torch.int8, device=cuda),
            torch.zeros(9, 16, 16, dtype=torch.int8, device=cuda), epi,
            inv_in=1.0, inv_next=1.0, alpha=0.2, cast_bf16=True)


def region_case(rng, n, h1, w1, c1, c, cm, co, cuda, tail=False,
                kind="s8"):
    """Random input (s8, bf16 or f32) and stage weights of the stem
    region, with its epi table (exact and fast) from random folded
    blocks."""
    from yolov3_tpu_torch.ops import quant
    stages = [int8_block(rng, k, ci, cout) for k, ci, cout in (
        (3, c1, c), (1, c, cm), (3, cm, c), (3, c, co))]
    scales = (0.04, 0.05, 0.06, 0.07)
    rows = [e for _, e in stages] + list(scales)
    shape = (n, h1 // 2, w1 // 2, c) if tail else (n, h1, w1, c1)
    x = int8_input(rng, shape, kind, cuda)
    ws = [w.to(cuda) for w, _ in stages]
    epis = {fast: quant.region_epi(*rows, fast=fast).to(cuda)
            for fast in (False, True)}
    return x, ws, epis, quant.tail_epi(*rows[1:]).to(cuda)


@pytest.mark.parametrize("n,h1,w1,c1,c,cm,co", [
    (2, 16, 16, 16, 32, 16, 64),     # one tile
    (1, 44, 36, 32, 64, 32, 128),    # ragged tiles (11 x 9 out)
    (3, 20, 28, 16, 16, 32, 48),     # odd out size, narrow stages
    (8, 128, 128, 32, 64, 32, 128)])  # flagship channels
@pytest.mark.parametrize("fast,cast,kind", [
    (False, True, "s8"), (False, False, "s8"), (True, True, "s8"),
    (True, True, "bf16"), (False, False, "f32")])
def test_s2d_region_matches_plain(cuda, n, h1, w1, c1, c, cm, co, fast,
                                  cast, kind):
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as K
    x, ws, epis, _ = region_case(np.random.RandomState(h1 + c), n, h1, w1,
                                 c1, c, cm, co, cuda, kind=kind)
    # a float x is quantized in the kernel with 1/s = 40
    kw = dict(alpha=0.2, cast_bf16=cast, fast=fast,
              inv_in=None if kind == "s8" else 40.0)
    got = launched(K, lambda: K.s2d_region_block_q(x, *ws, epis[fast],
                                                   **kw))
    want = K.s2d_region_block_q_plain(x, *ws, epis[fast], **kw)
    assert got.shape == (n, h1 // 4, w1 // 4, co)
    assert_int8_close(got, want)


@pytest.mark.parametrize("n,h1,w1", [(2, 16, 16), (1, 44, 36), (3, 20, 28)])
def test_s2d_tail_matches_plain(cuda, n, h1, w1):
    from yolov3_tpu_torch.ops.kernels import s2d_tail_q as K
    x, ws, _, epi = region_case(np.random.RandomState(h1), n, h1, w1, 32,
                                64, 32, 128, cuda, tail=True)
    kw = dict(alpha=0.2, cast_bf16=True)
    got = launched(K, lambda: K.s2d_tail_block_q(x, *ws[1:], epi, **kw))
    assert_int8_close(got, K.s2d_tail_block_q_plain(x, *ws[1:], epi, **kw))


@pytest.mark.parametrize("n,h1,w1,c1,c,cm,co", [
    (2, 16, 16, 16, 32, 16, 64),     # one tile, K 16 (a half K step)
    (1, 44, 36, 32, 64, 32, 128),    # ragged tiles (11 x 9 out)
    (3, 20, 28, 16, 16, 32, 48),     # odd out size, 16-channel slices
    (2, 68, 100, 32, 64, 32, 128),   # more tiles than SMs, ragged
    (8, 128, 128, 32, 64, 32, 128)])  # flagship channels
@pytest.mark.parametrize("fast,cast,kind", [
    (False, True, "s8"), (True, True, "s8"), (False, True, "bf16"),
    (True, True, "bf16"), (False, False, "f32"), (True, True, "f32")])
def test_s2d_region_equals_plain_and_twin(cuda, n, h1, w1, c1, c, cm, co,
                                          fast, cast, kind):
    """The kernel's codes equal the plain version's and the first
    design's (`_mma`) on every input."""
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as K
    x, ws, epis, _ = region_case(np.random.RandomState(h1 + w1 + c), n, h1,
                                 w1, c1, c, cm, co, cuda, kind=kind)
    kw = dict(alpha=0.2, cast_bf16=cast, fast=fast,
              inv_in=None if kind == "s8" else 40.0)
    got = launched(K, lambda: K.s2d_region_block_q(x, *ws, epis[fast],
                                                   **kw))
    assert_int8_equal(got, K.s2d_region_block_q_plain(x, *ws, epis[fast],
                                                      **kw))
    before = _build.launch_counts[K.NAME + K.TWIN]
    assert_int8_equal(got, K.s2d_region_block_q_mma(x, *ws, epis[fast],
                                                    **kw))
    assert _build.launch_counts[K.NAME + K.TWIN] == before + 1


@pytest.mark.parametrize("n,h1,w1,c,cm,co", [
    (2, 16, 16, 64, 32, 128), (1, 44, 36, 64, 32, 128),
    (3, 20, 28, 16, 32, 48), (8, 512, 512, 64, 32, 128)])
def test_s2d_tail_equals_plain_and_twin(cuda, n, h1, w1, c, cm, co):
    from yolov3_tpu_torch.ops.kernels import s2d_tail_q as K
    x, ws, _, epi = region_case(np.random.RandomState(h1 + c), n, h1, w1, 32,
                                c, cm, co, cuda, tail=True)
    kw = dict(alpha=0.2, cast_bf16=True)
    got = launched(K, lambda: K.s2d_tail_block_q(x, *ws[1:], epi, **kw))
    assert_int8_equal(got, K.s2d_tail_block_q_plain(x, *ws[1:], epi, **kw))
    assert_int8_equal(got, K.s2d_tail_block_q_mma(x, *ws[1:], epi, **kw))


def region_mode_case(rng, n, h1, w1, c1, c, cm, co, cuda, kind, fast,
                     affine2, rawimg, ci=3):
    """The region's operands in a mode: every third channel of stem2, the
    1x1 and FB0's 3x3 with a negative BatchNorm scale (the affine2
    packing's sign-flipped channels); affine2's table and flipped weights;
    with rawimg a random image of `kind` (bf16 or f32, ci channels), stem1's
    weights of its type and stem1's rows."""
    from yolov3_tpu_torch.ops import quant
    stages = [int8_block(rng, k, ci_, cout) for k, ci_, cout in (
        (3, c1, c), (1, c, cm), (3, cm, c), (3, c, co))]
    for _, epi3 in stages[:3]:
        epi3[1, ::3] *= -1
    rows = [e for _, e in stages] + [0.04, 0.05, 0.06, 0.07]
    ws = [w for w, _ in stages]
    if affine2:
        epi, signs = quant.region_epi_affine2(*rows, alpha=0.2)
        ws[1:] = [quant.flip_inputs(w, sgn) for w, sgn in zip(ws[1:], signs)]
    else:
        epi = quant.region_epi(*rows, fast=fast)
    extra = {}
    if rawimg:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        ws1 = torch.from_numpy((rng.randn(9, c1, ci) / np.sqrt(9 * ci))
                               .astype(np.float32))
        b0, m0, a0 = (torch.from_numpy(v.astype(np.float32)) for v in (
            0.1 * rng.randn(c1), rng.uniform(0.8, 1.2, c1),
            0.1 * rng.randn(c1)))
        epi = quant.with_stem1(epi, (b0, m0, a0), 0.04, fast=fast)
        x = torch.from_numpy(rng.randn(n, h1, w1, ci).astype(
            np.float32)).to(cuda, dtype)
        extra["w_s1"] = ws1.to(cuda, dtype)
    else:
        x = int8_input(rng, (n, h1, w1, c1), kind, cuda)
        if kind != "s8":
            extra["inv_in"] = 40.0
    return x, [w.to(cuda) for w in ws], epi.to(cuda), extra


@pytest.mark.parametrize("n,h1,w1,c1,c,cm,co,ci", [
    (2, 16, 16, 16, 32, 16, 64, 3),      # one tile
    (1, 44, 36, 32, 64, 32, 128, 1),     # ragged tiles, a grey image
    (3, 20, 28, 16, 16, 32, 48, 4),      # odd out size, narrow stages
    (2, 68, 100, 32, 64, 32, 128, 3),    # more tiles than SMs, ragged
    (8, 512, 512, 32, 64, 32, 128, 3)])  # the flagship, b8 at 512 px
@pytest.mark.parametrize("kind,cast,fast,affine2,rawimg", [
    ("s8", True, True, True, False), ("bf16", True, True, True, False),
    ("f32", False, False, True, False),
    ("bf16", True, False, False, True), ("bf16", True, True, False, True),
    ("bf16", True, True, True, True), ("bf16", True, False, True, True),
    ("f32", False, False, False, True), ("f32", False, True, True, True)])
def test_s2d_region_modes_equal_plain(cuda, n, h1, w1, c1, c, cm, co, ci,
                                      kind, cast, fast, affine2, rawimg):
    """The region kernel's affine2 and rawimg modes (rows 10a, 10b), alone
    and together, against their plain version: the affine2 epilogue rounds
    each product and add on its own as the plain version does, and on an
    f32 image stem1 sums its taps in the plain version's order, code for
    code. On a bf16 image stem1 runs on the tensor cores, whose sums run
    in the hardware's order, those whose code that order could change
    taken again in the plain order: held to the TPU kernel's class
    against its reference (test_s2d_region_kernel.py:339-343, <= 1 code
    on <= 10%); its twin with stem1 on CUDA cores (`_cores`: a bf16
    image's FMA equals its separately rounded product and add, the
    product of two bf16 values being exact in f32) is code for code. Each
    launch is counted under its mode."""
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as K
    x, ws, epi, extra = region_mode_case(
        np.random.RandomState(h1 + w1 + c + ci), n, h1, w1, c1, c, cm, co,
        cuda, kind, fast, affine2, rawimg, ci)
    kw = dict(alpha=0.2, cast_bf16=cast, fast=fast, affine2=affine2,
              **extra)
    name = K.variant(affine2, rawimg)
    before = _build.launch_counts[name]
    got = K.s2d_region_block_q(x, *ws, epi, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    assert got.shape == (n, h1 // 4, w1 // 4, co)
    want = K.s2d_region_block_q_plain(x, *ws, epi, **kw)
    if not (rawimg and kind == "bf16"):
        assert_int8_equal(got, want)
        return
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.10
    twin = K.s2d_region_block_q_cores(x, *ws, epi, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[name + K.CORES] >= 1
    assert_int8_equal(twin, want)


def test_s2d_region_modes_refuse_what_they_do_not_take(cuda):
    from yolov3_tpu_torch.ops.kernels import s2d_region_q as K
    x, ws, epi, extra = region_mode_case(
        np.random.RandomState(1), 1, 16, 16, 16, 32, 16, 64, cuda, "bf16",
        True, False, True)
    with pytest.raises(ValueError):  # the first design has neither mode
        K.launch(K.NAME, x, ws, epi, alpha=0.2, cast_bf16=True, twin=True,
                 **extra)
    with pytest.raises(ValueError):  # five image channels
        K.launch(K.NAME, torch.zeros(1, 16, 16, 5, device=cuda), ws, epi,
                 alpha=0.2, cast_bf16=True,
                 w_s1=torch.zeros(9, 16, 5, device=cuda))
    with pytest.raises(TypeError):  # an s8 image
        K.s2d_region_block_q(x.to(torch.int8), *ws, epi, alpha=0.2,
                             cast_bf16=True,
                             w_s1=extra["w_s1"].to(torch.int8))


def exit_case(rng, shape, co, cuda):
    """s8 x, w_t and the exit's [4, Co] epi (1/s_next in row 3) of a
    random block."""
    from yolov3_tpu_torch.ops import quant
    w_t, epi3 = int8_block(rng, 3, shape[-1], co)
    epi = quant.exit_epi(epi3, 0.07).to(cuda)
    return int8_input(rng, shape, "s8", cuda), w_t.to(cuda), epi


@pytest.mark.parametrize("shape,co,cast", [
    ((2, 16, 16, 64), 128, True), ((1, 9, 13, 32), 64, False),
    ((8, 64, 64, 64), 128, True),
    # the flagship exit at b8 (ConvBlock_2 at 512 px), both casts
    ((8, 256, 256, 64), 128, True), ((8, 256, 256, 64), 128, False),
    # odd H and W (SAME pads 1 top/left), and odd H with even W
    ((1, 9, 13, 32), 64, True), ((2, 15, 8, 16), 48, False),
    # OH*OW < BM with N > 1; one pixel; an output wider than TW = 128
    ((3, 5, 7, 16), 32, True), ((1, 1, 1, 16), 16, False),
    ((1, 6, 520, 32), 32, True)])
def test_exit_conv_matches_plain(cuda, shape, co, cast):
    """The exit kernel (wgmma core, s8 x by strided TMA) equal to its plain
    version and to its WMMA twin: 0 s8 codes differ."""
    from yolov3_tpu_torch.ops.kernels import exit_conv_q as K
    x, w_t, epi = exit_case(np.random.RandomState(shape[1] + co), shape, co,
                            cuda)
    kw = dict(alpha=0.2, cast_bf16=cast)
    got = launched(K, lambda: K.exit_conv_block_q(x, w_t, epi, **kw))
    assert got.shape == (shape[0], -(-shape[1] // 2), -(-shape[2] // 2), co)
    assert_int8_equal(got, K.exit_conv_block_q_plain(x, w_t, epi, **kw))
    before = _build.launch_counts[K.NAME + "_wmma"]
    assert_int8_equal(got, K.exit_conv_block_q_wmma(x, w_t, epi, **kw))
    assert _build.launch_counts[K.NAME + "_wmma"] == before + 1


def exit_plans(n, h, w, ci, co):
    """The exit's plan, and every other tile of TILES with the TW rule, at
    2 stages and at the most that fit beside the staged output rows (and,
    for BM = 128 and BN = 128, more than fit beside them: the common
    path's store)."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    plan = _conv_q.conv_plan(n, h, w, ci, co, 3, stride=2)
    ow = -(-w // 2)
    plans = {plan}
    for bm, bn in _conv_q.TILES:
        if bn <= -(-co // 32) * 32:
            tw = min(bm, 1 << (ow - 1).bit_length())
            fit = [q for q in (
                _conv_q.Plan(bm, bn, plan.bk, bm // tw, tw, stages)
                for stages in range(2, 14)) if _conv_q.smem_bytes(q)
                <= _conv_q.SMEM_BYTES]
            plans.update((fit[0], max(q for q in fit if _conv_q.staged(
                q, stride=2))))
            if (bm, bn) == (128, 128):
                plans.add(max(fit))
    return sorted(plans)


@pytest.mark.parametrize("cast", [True, False])
def test_exit_conv_every_plan_at_the_flagship_shape(cuda, cast):
    """Each tile plan `conv_plan` can give at the flagship exit (b8, s8
    256^2 x 64 -> 128), each equal to the plain version and the WMMA
    twin."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    from yolov3_tpu_torch.ops.kernels import exit_conv_q as K
    shape, co = (8, 256, 256, 64), 128
    x, w_t, epi = exit_case(np.random.RandomState(5 + cast), shape, co, cuda)
    kw = dict(alpha=0.2, cast_bf16=cast)
    want = K.exit_conv_block_q_plain(x, w_t, epi, **kw)
    assert_int8_equal(K.exit_conv_block_q_wmma(x, w_t, epi, **kw), want)
    for p in exit_plans(*shape, co):
        assert_int8_equal(_conv_q.launch(
            K.NAME, x, w_t, epi, ksize=3, stride=2, inv_in=1.0, inv_next=0.0,
            plan=p, **kw), want)


def test_exit_conv_refuses_what_it_cannot_run(cuda):
    """A plan whose TW (or TH) would take the strided box past TMA's 256
    elements, or whose rectangle is not BM pixels; a 3-row epi; a float
    x."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    from yolov3_tpu_torch.ops.kernels import exit_conv_q as K
    x, w_t, epi = exit_case(np.random.RandomState(6), (1, 8, 600, 16), 16,
                            cuda)
    kw = dict(ksize=3, stride=2, inv_in=1.0, inv_next=0.0, alpha=0.2,
              cast_bf16=True)
    for plan in (_conv_q.Plan(128, 32, 64, 1, 256, 4),   # TW 256
                 _conv_q.Plan(64, 32, 64, 1, 256, 4),    # and TH*TW != BM
                 _conv_q.Plan(128, 32, 64, 2, 32, 4)):   # TH*TW != BM
        with pytest.raises(RuntimeError):
            _conv_q.launch(K.NAME, x, w_t, epi, plan=plan, **kw)
    with pytest.raises(RuntimeError):  # the exit emits 1/s_next from row 3
        _conv_q.launch(K.NAME, x, w_t, epi[:3].contiguous(), **kw)
    with pytest.raises(TypeError):
        K.exit_conv_block_q(x.float(), w_t, epi, alpha=0.2, cast_bf16=True)


def slab_cases():
    """(c, k, slab kind, sparse): slabs of `pairwise_iou` (kind "boxes";
    the test adds a uniform random, asymmetric one on the same valid
    mask), and asymmetric ones holding NaNs and entries exactly at the
    threshold (kind "nan_ties")."""
    for c, k, sparse in ((128, 512, False), (128, 512, True), (5, 37, True),
                         (3, 1, False), (3, 63, True), (3, 64, False),
                         (3, 65, False), (2, 129, True), (2, 3000, True)):
        yield c, k, "boxes", sparse
    for c, k in ((4, 65), (3, 129), (128, 512), (2, 3000)):
        yield c, k, "nan_ties", True


@pytest.mark.parametrize("c,k,kind,sparse", list(slab_cases()))
def test_greedy_kernel_bit_equal(cuda, c, k, kind, sparse):
    """Keep masks bit-equal to the plain version and to the first design
    (the chain twin); on `pairwise_iou` slabs also to the box kernel, and
    on an asymmetric slab too (the kernel reads row i for candidate i).
    One launch counted a call."""
    from yolov3_tpu_torch.ops.nms import pairwise_iou
    rng = np.random.RandomState(c + k + 1)
    cand, valid = sorted_candidates(rng, c, k)
    if not sparse:
        valid[:] = True
    ct, vt = torch.from_numpy(cand).to(cuda), torch.from_numpy(valid).to(cuda)
    thr = 0.3
    if kind == "boxes":
        iou = pairwise_iou(ct).contiguous()
    else:
        slab = rng.rand(c, k, k).astype(np.float32)
        slab[rng.rand(c, k, k) < 0.1] = np.nan
        slab[rng.rand(c, k, k) < 0.2] = np.float32(thr)
        iou = torch.from_numpy(slab).to(cuda)
    before = _build.launch_counts[NMS.GREEDY]
    got = NMS.greedy_suppress(iou, vt, thr)
    torch.cuda.synchronize()
    assert _build.launch_counts[NMS.GREEDY] == before + 1
    assert torch.equal(got.cpu(), NMS.greedy_suppress_plain(
        iou.cpu(), vt.cpu(), thr))
    before = _build.launch_counts[NMS.GREEDY_CHAIN]
    assert torch.equal(got, NMS.greedy_suppress_chain(iou, vt, thr))
    assert _build.launch_counts[NMS.GREEDY_CHAIN] == before + 1
    if kind == "boxes":
        assert torch.equal(got, NMS.suppress_boxes_t(ct, vt, thr))
        # an asymmetric slab: the kernel reads row i for candidate i
        rnd = torch.rand(c, k, k, device=cuda, generator=torch.Generator(
            cuda).manual_seed(c))
        assert torch.equal(NMS.greedy_suppress(rnd, vt, 0.9).cpu(),
                           NMS.greedy_suppress_plain(rnd.cpu(), vt.cpu(),
                                                     0.9))


def test_greedy_kernel_refuses_k_over_its_limit(cuda):
    """Both IoU-slab entries take K <= 255 * 64 (the mask grid's words^2
    blocks): the wrapper raises above it, and so does each C entry."""
    k = NMS.GREEDY_MAX_K + 1
    iou = torch.empty((1, k, k), device=cuda)
    valid = torch.ones((1, k), dtype=torch.bool, device=cuda)
    for fn in (NMS.greedy_suppress, NMS.greedy_suppress_chain):
        with pytest.raises(ValueError):
            fn(iou, valid, 0.3)
    del iou
    stream = torch.cuda.current_stream().cuda_stream
    dummy = valid.data_ptr()
    assert NMS._kernel_fn(NMS.GREEDY)(dummy, dummy, dummy, dummy, 1, k, 0.3,
                                      stream) != 0
    assert NMS._kernel_fn(NMS.GREEDY_CHAIN)(dummy, dummy, dummy, 1, k, 0.3,
                                            stream) != 0
    k = NMS.GREEDY_MAX_K
    assert NMS._kernel_fn(NMS.GREEDY_CHAIN)(dummy, dummy, dummy, 0, k, 0.3,
                                            stream) == 0


def test_region_kernels_raise_on_what_they_do_not_take(cuda):
    from yolov3_tpu_torch.ops.kernels import exit_conv_q, s2d_region_q
    x, ws, epis, _ = region_case(np.random.RandomState(0), 1, 16, 16, 16, 32,
                                 16, 64, cuda)
    with pytest.raises(ValueError):  # H = 18 is not a multiple of 4
        s2d_region_q.s2d_region_block_q(
            torch.zeros(1, 18, 16, 16, dtype=torch.int8, device=cuda), *ws,
            epis[False], alpha=0.2, cast_bf16=True)
    with pytest.raises(TypeError):  # the region takes s8, bf16 or f32
        s2d_region_q.s2d_region_block_q(x.double(), *ws, epis[False],
                                        alpha=0.2, cast_bf16=True,
                                        inv_in=1.0)
    with pytest.raises(ValueError):  # a float x needs its 1/s
        s2d_region_q.s2d_region_block_q(x.float(), *ws, epis[False],
                                        alpha=0.2, cast_bf16=True)
    with pytest.raises(ValueError):  # 8 channels are not a multiple of 16
        s2d_region_q.launch(
            s2d_region_q.NAME, torch.zeros(1, 16, 16, 8, dtype=torch.int8,
                                           device=cuda),
            [torch.zeros(9, 32, 8, dtype=torch.int8, device=cuda)] + ws[1:],
            epis[False], alpha=0.2, cast_bf16=True)
    with pytest.raises(TypeError):  # the exit conv takes s8
        exit_conv_q.exit_conv_block_q(
            torch.zeros(1, 8, 8, 64, device=cuda),
            torch.zeros(9, 64, 64, dtype=torch.int8, device=cuda),
            torch.zeros(4, 64, device=cuda), alpha=0.2, cast_bf16=True)
    with pytest.raises(TypeError):  # the greedy kernel takes f32 and bool
        NMS.greedy_suppress(torch.zeros(2, 8, 8, dtype=torch.float64,
                                        device=cuda),
                            torch.ones(2, 8, dtype=torch.bool, device=cuda),
                            0.3)


# --- the wgmma + TMA core of the int8 1x1 and 3x3 kernels -----------------

def assert_int8_equal(got, want):
    """0 s8 codes differ and float outputs are bit-equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def wgmma_case(rng, shape, co, ksize, kind, res, cuda, emit_s8=True,
               out=torch.bfloat16):
    """(name, x, w_t, epi, launch kwargs) of a random int8 1x1 or 3x3
    block; `res` is the 1x1's residual input or the 3x3's residual
    output."""
    w_t, epi = (t.to(cuda) for t in int8_block(rng, ksize, shape[-1], co))
    x = int8_input(rng, shape, kind, cuda)
    rshape = shape if ksize == 1 else shape[:3] + (co,)
    rq = int8_input(rng, rshape, "s8", cuda) if res else None
    name = "pointwise_conv_block_q" if ksize == 1 else "conv3x3_block_q"
    kw = dict(ksize=ksize, stride=1, inv_in=0.5, inv_next=9.0, alpha=0.2,
              cast_bf16=out != torch.float32, res_scale=0.03,
              emit_s8=emit_s8, out_dtype=out,
              residual_in=rq if ksize == 1 else None,
              residual_out=rq if ksize == 3 else None)
    return name, x, w_t, epi, kw


def wgmma_equal_to_plain_and_wmma(name, x, w_t, epi, kw, plan=None):
    from yolov3_tpu_torch.ops.kernels import _conv_q
    before = _build.launch_counts[name]
    got = _conv_q.launch(name, x, w_t, epi, plan=plan, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    assert_int8_equal(got, _conv_q.conv_block_q_plain(x, w_t, epi, **kw))
    assert_int8_equal(got, _conv_q.launch(name, x, w_t, epi, wmma=True,
                                          **kw))


@pytest.mark.parametrize("ksize", [1, 3])
@pytest.mark.parametrize("tile", range(6))
@pytest.mark.parametrize("bk", [64, 128])
def test_wgmma_every_plan_equals_plain_and_wmma(cuda, ksize, tile, bk):
    """Each tile the planner can choose, at 2-5 stages: 9 taps x Ci 192
    (3 or 2 K steps, the last half zero-filled at BK 128) wrap the ring
    many times; 12 x 20 pixels leave ragged rectangles (TW 32)."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    bm, bn = _conv_q.TILES[tile]
    tw = bm if ksize == 1 else 32
    plan = _conv_q.Plan(bm, bn, bk, bm // tw, tw, 2 + (tile + bk) % 4)
    assert _conv_q.smem_bytes(plan) <= _conv_q.SMEM_BYTES
    case = wgmma_case(np.random.RandomState(tile + bk), (2, 12, 20, 192),
                      256, ksize, "s8", ksize == 3, cuda)
    wgmma_equal_to_plain_and_wmma(*case, plan=plan)


@pytest.mark.parametrize("shape,co,ksize,kind,res,emit_s8,out", [
    # H*W < BM with N > 1, W not a multiple of TW
    ((3, 5, 7, 64), 64, 3, "s8", True, True, torch.bfloat16),
    # Ci 16 and 48: TMA's zero fill in K; Co 48
    ((2, 9, 13, 16), 48, 3, "s8", False, True, None),
    ((2, 9, 13, 48), 48, 1, "s8", False, True, torch.bfloat16),
    ((2, 6, 10, 48), 48, 3, "s8", True, False, torch.bfloat16),
    # M = 15 < BM
    ((1, 3, 5, 64), 64, 1, "s8", False, True, None),
    ((1, 3, 5, 64), 64, 3, "s8", True, True, None),
    # bf16 and f32 inputs (the converting producer), with and without the
    # residual input (1x1) or output (3x3)
    ((2, 7, 9, 64), 96, 1, "bf16", True, True, torch.bfloat16),
    ((2, 7, 9, 64), 96, 1, "bf16", False, True, None),
    ((1, 8, 8, 128), 256, 1, "f32", False, False, torch.float32),
    ((2, 11, 6, 48), 80, 3, "bf16", True, True, torch.bfloat16),
    ((2, 16, 16, 64), 128, 3, "bf16", False, False, torch.bfloat16),
    ((1, 8, 8, 32), 64, 3, "f32", False, False, torch.float32),
    # the flagship's 16^2 512 -> 1024 and 128^2 64 -> 128 3x3s at b8, and
    # its 16^2 1024 -> 512 1x1
    ((8, 16, 16, 512), 1024, 3, "s8", True, True, None),
    ((8, 128, 128, 64), 128, 3, "s8", True, False, torch.bfloat16),
    ((8, 16, 16, 1024), 512, 1, "s8", False, True, None)])
def test_wgmma_edges_equal_plain_and_wmma(cuda, shape, co, ksize, kind, res,
                                          emit_s8, out):
    case = wgmma_case(np.random.RandomState(shape[1] + co), shape, co, ksize,
                      kind, res, cuda, emit_s8, out)
    wgmma_equal_to_plain_and_wmma(*case)


@pytest.mark.parametrize("ksize", [1, 3])
def test_wgmma_inv_next_row(cuda, ksize):
    """A [4, Co] epi: the s8 output's 1/s per channel from row 3."""
    from yolov3_tpu_torch.ops.kernels import _conv_q
    rng = np.random.RandomState(ksize)
    name, x, w_t, epi, kw = wgmma_case(rng, (2, 10, 12, 64), 96, ksize, "s8",
                                       False, cuda)
    inv = torch.from_numpy(rng.uniform(4, 12, 96).astype(np.float32)).to(cuda)
    got = _conv_q.launch(name, x, w_t, torch.cat([epi, inv[None]]), **kw)
    assert_int8_equal(got, _conv_q.conv_block_q_plain(
        x, w_t, epi, **dict(kw, inv_next=inv)))


def test_wgmma_raises_on_a_plan_it_cannot_run(cuda):
    from yolov3_tpu_torch.ops.kernels import _conv_q
    name, x, w_t, epi, kw = wgmma_case(np.random.RandomState(0),
                                       (1, 8, 8, 64), 64, 3, "s8", False,
                                       cuda)
    for plan in (_conv_q.Plan(128, 128, 128, 3, 32, 4),   # TH*TW != BM
                 _conv_q.Plan(128, 256, 128, 4, 32, 5),   # shared memory
                 _conv_q.Plan(128, 96, 128, 4, 32, 3)):   # BN
        with pytest.raises(RuntimeError):
            _conv_q.launch(name, x, w_t, epi, plan=plan, **kw)
