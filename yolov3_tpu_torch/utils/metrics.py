"""Training metrics and TensorBoard-compatible logging (copy of
`yolov3_tpu/utils/metrics.py`).

Replaces the reference's `tf.keras.metrics.Mean` set (5 train + 5 test:
total/xy/wh/obj/class, reference/train.py:80-90) and its
`tf.summary` scalar writers (reference/train.py:92-101,128-133,158-163).
TensorBoard event files are written via tensorboardX when available;
otherwise scalars fall back to a CSV log so headless environments still get
a record.
"""

from __future__ import annotations

import csv
import os
from typing import Dict


class MeanMetric:
    """Streaming mean, reset between logging intervals."""

    def __init__(self, name: str):
        self.name = name
        self._total = 0.0
        self._count = 0

    def update(self, value: float) -> None:
        self._total += float(value)
        self._count += 1

    def result(self) -> float:
        return self._total / self._count if self._count else 0.0

    def reset(self) -> None:
        self._total = 0.0
        self._count = 0


class MetricSet:
    """The reference's five-loss metric bundle."""

    NAMES = ("loss", "loss_xy", "loss_wh", "loss_obj", "loss_class")

    def __init__(self, prefix: str):
        self.metrics = {n: MeanMetric(f"{prefix}_{n}") for n in self.NAMES}

    def update(self, values: Dict[str, float]) -> None:
        for n in self.NAMES:
            self.metrics[n].update(values[n])

    def results(self) -> Dict[str, float]:
        return {n: m.result() for n, m in self.metrics.items()}

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()


class SummaryLogger:
    """Scalar logger: TensorBoard events (tensorboardX) + CSV fallback."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        try:
            from tensorboardX import SummaryWriter
            self._writer = SummaryWriter(log_dir)
        except Exception:
            pass
        self._csv_path = os.path.join(log_dir, "scalars.csv")
        self._csv_fh = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_fh)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        self._csv.writerow([step, tag, value])

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
        self._csv_fh.flush()

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._writer.close()
        self._csv_fh.close()


def write_loss_csv(path: str, losses) -> None:
    """Rewrite test_loss.csv, one loss per line (reference/train.py:170-173)."""
    with open(path, "w") as fh:
        for value in losses:
            fh.write(f"{value}\n")
