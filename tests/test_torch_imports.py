"""The PyTorch port, chip_smoke.py and the probe script it loads stand
alone: no JAX, no JAX package, no scikit-learn and no OpenCV (the card's
host has neither)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import pkgutil, sys
import yolov3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(yolov3_tpu_torch.__path__,
                                                "yolov3_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
chip_smoke.load_probe()  # scripts/qg512_probe.py, which phase 13 loads
banned = {"jax", "jaxlib", "flax", "optax", "orbax", "yolov3_tpu", "sklearn",
          "cv2"}
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned
             or m == "google.protobuf" or m.startswith("google.protobuf."))
# the training slice's modules and the device feed's and the tools',
# among those imported above
training = ["data.isg_ai", "data.records", "data.store", "data.encoder",
            "data.augment", "data.reader", "ops.loss",
            "parallel.train_step", "utils.metrics", "utils.prefetch",
            "train", "data.device_pipeline", "data.shm_ring",
            "data.store_native", "data.builder", "find_anchors",
            "utils.evaluation", "utils.tf_import"]
missing = [m for m in training if "yolov3_tpu_torch." + m not in names]
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def _run(args, cwd, **extra_env):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    r = _run(["-c", _CHECK], REPO)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    """With no card visible, and in a directory holding chip_smoke.py and
    nothing else of the repo, the script exits non-zero with no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(["chip_smoke.py"], cwd, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
