"""The yardstick's conv count against the program's own count.

`chip_smoke.train_flops` counts the convs the port's train-mode forward
actually calls (`conv2d_same`'s shapes); `work.forward_ops` counts them
from the configuration alone. Run with
`python -m pytest portbench/test_portbench_work.py -q` from the root.
"""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import work  # noqa: E402
from loops.common import model_dict, program_config  # noqa: E402


def _config(**model):
    with open(os.path.join(HERE, "configs", "nist-yolov3-512-bf16.json")) as fh:
        config = json.load(fh)
    config["model"].update(model)
    return config


@pytest.mark.parametrize("model", [
    dict(img_size=[64, 96, 3], filter_count=64, block_count=2),
    dict(img_size=[512, 512, 3]),
], ids=["small", "flagship"])
def test_forward_ops_match_the_ports_count(model, monkeypatch):
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    config = _config(**model)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    want = chip_smoke.train_flops(torch, program_config(config))
    assert work.forward_ops(model_dict(config)) == want


def test_flagship_forward_is_96_gflop():
    # PERF.md's 96.00 GFLOP per 512 px forward (the port's count)
    ops = work.forward_ops(model_dict(_config()))
    assert round(ops / 1e9, 2) == 96.0


def test_int8_core_holds_the_67_quantized_convs():
    model = model_dict(_config())
    io = work.int8_core_io(model)
    assert len(io) == 67
    kinds = [(k, s) for n, _, _, _, _, k, s in work.conv_layers(model)
             if n in io]
    assert kinds.count((1, 1)) == 33
    assert kinds.count((3, 1)) == 31
    assert kinds.count((3, 2)) == 3
    assert work.int8_core_bound_s(model, 64) > 0
