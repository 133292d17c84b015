"""What the loops share: the run's record, the program's configuration
from the cell's, and the seeded generators."""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEED_MOD = 2 ** 63


@dataclasses.dataclass
class Run:
    """What a run hands to `run.py` and to the metric readers."""
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    info: Dict[str, Any]
    trace: Any = None
    trace_window: Optional[Tuple[float, float]] = None


def model_dict(config: dict) -> dict:
    """The cell configuration's model settings, with `number_anchors`."""
    m = dict(config["model"])
    m["img_size"] = tuple(m["img_size"])
    m["anchors"] = tuple(tuple(a) for a in m["anchors"])
    m["number_anchors"] = len(m["anchors"])
    return m


def program_config(config: dict, **overrides):
    """The program's `ModelConfig` of the cell's configuration."""
    from yolov3_tpu_torch.config import ModelConfig
    m = model_dict(config)
    del m["number_anchors"]
    m.update(overrides)
    return ModelConfig(**m)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one stream of the seed's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) % SEED_MOD)
    return gen


def host_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), stream])


def report_setup(t_start: float, marks) -> None:
    """Set-up's parts on standard error, in seconds: process start to the
    loop's start, then each named stretch."""
    parts = [("imports", marks[0][1] - t_start)] + [
        (name, t - prev) for (_, prev), (name, t) in zip(marks, marks[1:])]
    print("setup parts: " + ", ".join(f"{n} {v:.3f}" for n, v in parts),
          file=sys.stderr)
