"""PyTorch port weight bridge and artifact vs the JAX package's trees."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.config import ModelConfig as JConfig
from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
from yolov3_tpu.utils import checkpoint as jckpt
from yolov3_tpu_torch.config import ModelConfig
from yolov3_tpu_torch.models.yolo import YoloV3
from yolov3_tpu_torch.utils import checkpoint as ckpt

SMALL = dict(img_size=(64, 64, 3), number_classes=2,
             anchors=((16, 16), (32, 32)), block_count=1, filter_count=32,
             compute_dtype="float32")


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_variables(kw, seed=0):
    v = JYoloV3(JConfig(**kw)).init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 64, 64, 3)), train=False)
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * r.rand(*a.shape).astype(np.float32),
        v)


class TestParamsFromJax:
    @pytest.mark.parametrize("s2d,bc", [(True, 1), (False, 1), (True, 2)])
    def test_consumes_every_leaf_once(self, s2d, bc):
        kw = dict(SMALL, stem_space_to_depth=s2d, block_count=bc)
        v = jax_variables(kw)
        cfg = ModelConfig(**kw)
        state = ckpt.params_from_jax(v["params"], v["batch_stats"], cfg)
        n_leaves = len(leaves(v["params"])) + len(leaves(v["batch_stats"]))
        assert len(state) == n_leaves
        assert set(state) == set(YoloV3(cfg).state_dict())
        # every value arrives exactly, kernels transposed HWIO -> OIHW
        k = v["params"]["Darknet53_0"]["FeatureBlock_0"]["ConvBlock_1"][
            "Conv_0"]["kernel"]
        np.testing.assert_array_equal(
            state["darknet.blocks.0.convs.1.conv.weight"].numpy(),
            k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            state["necks.1.bn.running_var"].numpy(),
            v["batch_stats"]["ConvBlock_1"]["BatchNorm_0"]["var"])
        total = sum(t.numel() for t in state.values())
        assert total == sum(a.size for a in leaves(v).values())

    def test_missing_leaf_raises(self):
        v = jax_variables(SMALL)
        del v["params"]["DetectionHead_2"]["Conv_0"]["bias"]
        with pytest.raises(KeyError, match="DetectionHead_2"):
            ckpt.params_from_jax(v["params"], v["batch_stats"],
                                 ModelConfig(**SMALL))

    def test_leftover_leaf_raises(self):
        v = jax_variables(SMALL)
        v["batch_stats"]["ConvBlock_0"]["BatchNorm_0"]["extra"] = np.zeros(3)
        with pytest.raises(KeyError, match="left over"):
            ckpt.params_from_jax(v["params"], v["batch_stats"],
                                 ModelConfig(**SMALL))

    def test_wrong_shape_raises(self):
        v = jax_variables(SMALL)
        with pytest.raises(ValueError, match="shape"):
            ckpt.params_from_jax(v["params"], v["batch_stats"],
                                 ModelConfig(**dict(SMALL, number_classes=3)))

    def test_flax_paths_of_auto_named_modules(self):
        assert ckpt.flax_path("necks.0.conv.weight") == \
            "params/ConvBlock_0/Conv_0/kernel"
        assert ckpt.flax_path("heads.2.conv.bias") == \
            "params/DetectionHead_2/Conv_0/bias"
        assert ckpt.flax_path("darknet.blocks.2.convs.3.bn.running_var") == \
            "batch_stats/Darknet53_0/FeatureBlock_2/ConvBlock_3/BatchNorm_0/var"
        assert ckpt.flax_path("yolo_blocks.1.convs.5.bn.weight") == \
            "params/YoloBlock_1/ConvBlock_5/BatchNorm_0/scale"

    @pytest.mark.parametrize("bc", [1, 8])
    def test_init_params_has_the_flax_tree(self, bc):
        kw = dict(SMALL, block_count=bc)
        want = jax.eval_shape(lambda k: JYoloV3(JConfig(**kw)).init(
            k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
        params, stats = ckpt.init_params(ModelConfig(**kw), 0)
        got = {"params": params, "batch_stats": stats}
        assert {k: v.shape for k, v in leaves(got).items()} == {
            jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(want)}
        a, _ = ckpt.init_params(ModelConfig(**kw), 0)
        b, _ = ckpt.init_params(ModelConfig(**kw), 1)
        ka = a["YoloBlock_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
        assert np.array_equal(ka, params["YoloBlock_0"]["ConvBlock_0"][
            "Conv_0"]["kernel"])
        assert not np.array_equal(ka, b["YoloBlock_0"]["ConvBlock_0"][
            "Conv_0"]["kernel"])


class TestArtifact:
    def test_export_load_roundtrip(self, tmp_path):
        cfg = ModelConfig(**dict(SMALL, int8_train=True))
        params, stats = ckpt.init_params(cfg, 3)
        path = ckpt.export_model(str(tmp_path), params, stats, cfg)
        p2, s2, cfg2 = ckpt.load_model(path)
        assert cfg2 == dataclasses.replace(cfg, int8_train=False)
        assert leaves(p2).keys() == leaves(params).keys()
        for k, v in leaves({"p": params, "s": stats}).items():
            np.testing.assert_array_equal(
                leaves({"p": p2, "s": s2})[k], v)

    def test_load_model_missing(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ckpt.load_model(str(tmp_path / "nope"))

    def test_config_json_from_jax(self):
        """Every JAX field, the TPU-only ones included, reads unchanged."""
        jcfg = JConfig(img_size=(512, 512, 3), number_classes=2,
                       anchors=((64, 384), (384, 64)),
                       stem_space_to_depth=True, s2d_base_grads=("stride1",),
                       stem1_im2row_grads=True, remat_blocks=True,
                       use_pallas_pointwise=True)
        cfg = ModelConfig.from_json(jcfg.to_json())
        assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
        assert cfg.dtype == torch.bfloat16
        assert cfg.number_output_boxes == jcfg.number_output_boxes == 10752
        assert cfg.grid_sizes == jcfg.grid_sizes

    def test_convert_jax_orbax_export(self, tmp_path):
        """A JAX (Orbax) export -> numpy -> the port's artifact -> the
        same state as converting the JAX trees directly."""
        v = jax_variables(SMALL, seed=4)
        jpath = jckpt.export_model(str(tmp_path / "jax"), v["params"],
                                   v["batch_stats"], JConfig(**SMALL))
        jp, js, jcfg = jckpt.load_model(jpath)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        cfg = ModelConfig.from_json(jcfg.to_json())
        path = ckpt.export_model(str(tmp_path / "port"), to_np(jp),
                                 to_np(js), cfg)
        p, s, cfg2 = ckpt.load_model(path)
        assert cfg2 == cfg
        got = ckpt.params_from_jax(p, s, cfg2)
        want = ckpt.params_from_jax(v["params"], v["batch_stats"], cfg)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
