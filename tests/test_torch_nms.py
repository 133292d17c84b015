"""PyTorch port NMS vs the JAX package's NMS and its Pallas kernels.

The same numpy inputs go through both packages. Keep masks and candidate
boxes must be bit-equal and scores equal: the port's IoU and recurrence
are op for op the reference's, and its stable descending sort breaks
top-K ties as `lax.top_k` does. The Pallas kernels run in interpret mode,
as the JAX package's own tests run them on the CPU.
"""

import numpy as np
import pytest
import torch

from yolov3_tpu.ops import nms as jnms
from yolov3_tpu.ops.pallas.nms_kernel import (suppress_boxes_pallas,
                                              suppress_boxes_pallas_t)
from yolov3_tpu_torch.ops import boxes as bbox
from yolov3_tpu_torch.ops import nms as tnms
from yolov3_tpu_torch.ops.kernels import nms_suppress as K


def random_detections(rng, b, n, c, spread=400.0):
    xy = rng.rand(b, n, 2) * spread
    wh = rng.rand(b, n, 2) * 100 + 5
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    obj = rng.rand(b, n, 1)
    probs = rng.rand(b, n, c)
    return np.concatenate([boxes, obj, probs], axis=-1).astype(np.float32)


def sorted_candidates(rng, c, k):
    xy = rng.rand(c, k, 2).astype(np.float32) * 100
    wh = rng.rand(c, k, 2).astype(np.float32) * 40 + 1
    cand = np.concatenate([xy, xy + wh], axis=-1)
    counts = rng.randint(0, k + 1, c)
    valid = np.arange(k)[None, :] < counts[:, None]
    return cand, valid


def port_keep(cand, valid, thr):
    return K.suppress_boxes_t(torch.from_numpy(cand),
                              torch.from_numpy(valid), thr).numpy()


class TestBatchedNmsMatchesJax:
    @pytest.mark.parametrize("use_pallas", [True, False])
    @pytest.mark.parametrize("seed,b,n,c,k,min_box", [
        (0, 2, 300, 2, 128, None), (1, 3, 200, 3, 64, 32.0),
        (2, 1, 100, 1, 512, None)])
    def test_bit_equal(self, use_pallas, seed, b, n, c, k, min_box):
        rng = np.random.RandomState(seed)
        det = random_detections(rng, b, n, c)
        jb, js, jk = (np.asarray(o) for o in jnms.batched_nms_device(
            det, c, max_boxes=k, min_box_size=min_box, use_pallas=use_pallas))
        tb, ts, tk = (o.numpy() for o in tnms.batched_nms_device(
            torch.from_numpy(det), c, max_boxes=k, min_box_size=min_box))
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ts, js)

    def test_top_k_ties_keep_lower_index_first(self):
        """Equal scores everywhere (the -1 sentinels and repeated real
        scores): the gathered candidates follow lax.top_k's order."""
        rng = np.random.RandomState(3)
        det = random_detections(rng, 2, 64, 2)
        det[..., 4] = 1.0
        det[..., 5:] = np.where(rng.rand(2, 64, 2) < 0.5, 0.25, 0.0)
        jb, js, jk = (np.asarray(o) for o in jnms.batched_nms_device(
            det, 2, max_boxes=48, use_pallas=False))
        tb, ts, tk = (o.numpy() for o in tnms.batched_nms_device(
            torch.from_numpy(det), 2, max_boxes=48))
        assert (js == 0.5).any() and (js == -1.0).any()
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tk, jk)


    @pytest.mark.parametrize("b,n", [(1, 300), (3, 600), (1, 1)])
    def test_kernel_gets_contiguous_inputs(self, monkeypatch, b, n):
        """The CUDA wrapper refuses strided inputs; torch.sort can return
        a column-major result, so the NMS must hand over row-major ones."""
        seen = []
        orig = K.suppress_boxes_t

        def spy(cand, valid, thr):
            seen.append(cand.is_contiguous() and valid.is_contiguous())
            return orig(cand, valid, thr)

        monkeypatch.setattr(K, "suppress_boxes_t", spy)
        det = random_detections(np.random.RandomState(n), b, n, 2)
        tnms.batched_nms_device(torch.from_numpy(det), 2)
        assert seen == [True]


class TestHostOracle:
    @pytest.mark.parametrize("seed,n,c", [(0, 50, 1), (1, 100, 3), (2, 200, 5)])
    def test_per_class_matches_host(self, seed, n, c):
        rng = np.random.RandomState(seed)
        det = random_detections(rng, 1, n, c)[0]
        out = tnms.per_class_nms_device(
            torch.from_numpy(det[:, :4]), torch.from_numpy(det[:, 4:5]),
            torch.from_numpy(det[:, 5:]), max_boxes=n)
        got = tnms.nms_to_host(*out)
        want = bbox.per_class_nms(det[:, :4], det[:, 4:5], det[:, 5:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_port_oracle_equals_jax_oracle(self):
        from yolov3_tpu.ops import boxes as jbox
        det = random_detections(np.random.RandomState(4), 1, 150, 2)[0]
        got = bbox.per_class_nms(det[:, :4], det[:, 4:5], det[:, 5:])
        want = jbox.per_class_nms(det[:, :4], det[:, 4:5], det[:, 5:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_nothing_survives(self):
        det = random_detections(np.random.RandomState(5), 1, 10, 2)
        det[..., 4:] = 1e-4
        out = tnms.batched_nms_device(torch.from_numpy(det), 2)
        assert not out[2].any()
        assert tnms.nms_to_host(out[0][0], out[1][0], out[2][0]) == (
            None, None, None)

    def test_saturation_warned_once(self, capsys):
        boxes = np.stack([np.arange(64) * 200.0, np.zeros(64),
                          np.arange(64) * 200.0 + 50, np.full(64, 50.0)],
                         axis=1).astype(np.float32)
        det = np.concatenate([boxes, np.ones((64, 1)),
                              np.full((64, 1), 0.8)], axis=1)[None]
        _, scores, keep = tnms.batched_nms_device(
            torch.from_numpy(det.astype(np.float32)), 1, max_boxes=16)
        assert int(keep.sum()) == 16
        tnms._saturation_warned = False
        assert tnms.warn_if_saturated(scores)
        assert "raise --max-boxes" in capsys.readouterr().out
        assert tnms.warn_if_saturated(scores)
        assert capsys.readouterr().out == ""


class TestSuppressionMatchesPallas:
    @pytest.mark.parametrize("seed,c,k", [(0, 3, 64), (1, 7, 128),
                                          (2, 130, 64), (3, 1, 32)])
    def test_plain_vs_pallas_t(self, seed, c, k):
        cand, valid = sorted_candidates(np.random.RandomState(seed), c, k)
        want = np.asarray(suppress_boxes_pallas_t(cand, valid, 0.3,
                                                  interpret=True, unroll=1))
        np.testing.assert_array_equal(port_keep(cand, valid, 0.3), want)

    @pytest.mark.parametrize("k", [1, 63, 64, 65, 513])
    def test_plain_vs_pallas_t_at_word_edges(self, k):
        """K around the CUDA kernel's 64-slot mask words (one slot, a word
        less one, one word, one slot more, eight words and one), every
        slot valid."""
        cand, _ = sorted_candidates(np.random.RandomState(k), 2, k)
        valid = np.ones((2, k), bool)
        # unroll=1: the Pallas kernel's unrolled loop reaches past the last
        # slot when K is not a multiple of `unroll`
        want = np.asarray(suppress_boxes_pallas_t(cand, valid, 0.3,
                                                  interpret=True, unroll=1))
        got = port_keep(cand, valid, 0.3)
        np.testing.assert_array_equal(got, want)
        assert got[:, 0].all()

    def test_tie_chain_across_word_boundaries(self):
        """130 slots in a chain: each box overlaps the next at IoU exactly
        50/150 and the one after it not at all. Ties are kept, so at that
        threshold every slot survives; just below it greedy keeps the even
        slots only, across the 64- and 128-slot word boundaries (slot 63,
        suppressed, must not suppress slot 64)."""
        k = 130
        i = np.arange(k, dtype=np.float32)
        cand = np.stack([np.zeros(k), 5 * i, np.full(k, 10.0), 5 * i + 10],
                        axis=-1).astype(np.float32)[None]
        valid = np.ones((1, k), bool)
        tie = 50.0 / 150.0
        for thr, expect in ((tie, np.ones(k, bool)),
                            (tie - 1e-4, np.arange(k) % 2 == 0)):
            want = np.asarray(suppress_boxes_pallas_t(
                cand, valid, thr, interpret=True, unroll=1))
            got = port_keep(cand, valid, thr)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got[0], expect)

    @pytest.mark.parametrize("seed,c,k", [(5, 4, 96), (6, 2, 256)])
    def test_row_layout_entry_vs_pallas(self, seed, c, k):
        cand, valid = sorted_candidates(np.random.RandomState(seed), c, k)
        want = np.asarray(suppress_boxes_pallas(cand, valid, 0.3,
                                                interpret=True))
        got = K.suppress_boxes(torch.from_numpy(cand),
                               torch.from_numpy(valid), 0.3).numpy()
        np.testing.assert_array_equal(got, want)

    def test_threshold_tie_survives(self):
        cand = np.array([[[0, 0, 10, 10], [0, 5, 10, 15]]], np.float32)
        valid = np.ones((1, 2), bool)
        iou = 50.0 / 150.0
        assert port_keep(cand, valid, iou).tolist() == [[True, True]]
        assert port_keep(cand, valid, iou - 1e-4).tolist() == [[True, False]]

    def test_suppression_chain(self):
        # A suppresses B; C overlaps B but not A -> C survives
        cand = np.array([[[0, 0, 10, 10], [0, 2, 10, 12], [0, 4, 10, 14]]],
                        np.float32)
        valid = np.ones((1, 3), bool)
        assert port_keep(cand, valid, 0.5).tolist() == [[True, False, True]]

    def test_gap_validity_pattern(self):
        cand = np.array([[[0, 0, 10, 10], [0, 0, 10, 10],
                          [20, 20, 30, 30], [50, 50, 60, 60]]], np.float32)
        valid = np.array([[True, False, True, False]])
        want = np.asarray(suppress_boxes_pallas_t(cand, valid, 0.5,
                                                  interpret=True))
        got = port_keep(cand, valid, 0.5)
        assert got.tolist() == [[True, False, True, False]] == want.tolist()

    def test_all_invalid_keeps_nothing(self):
        cand = np.zeros((2, 8, 4), np.float32)
        assert not port_keep(cand, np.zeros((2, 8), bool), 0.3).any()

    def test_degenerate_boxes_never_suppress(self):
        """0/0 IoU is NaN and NaN > threshold is false, as in the reference."""
        cand = np.zeros((1, 3, 4), np.float32)
        valid = np.ones((1, 3), bool)
        want = np.asarray(suppress_boxes_pallas_t(cand, valid, 0.3,
                                                  interpret=True))
        assert port_keep(cand, valid, 0.3).tolist() == want.tolist() == [
            [True, True, True]]

    def test_wrapper_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            K.suppress_boxes_t(torch.zeros(2, 8, 3), torch.zeros(2, 8, dtype=torch.bool), 0.3)
        with pytest.raises(ValueError):
            K.suppress_boxes_t(torch.zeros(2, 8, 4), torch.zeros(2, 7, dtype=torch.bool), 0.3)
