"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, for Hopper (`sm_90a`), and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/yolov3_tpu_torch/<name>-<hash>.so

`-fmad=false` keeps every multiply and add separately rounded, as the
NMS kernel's bit-equality with the plain IoU needs; `--use_fast_math` is
never passed (IEEE division). A library is built at first use and again
whenever its source, the shared headers (`csrc/*.cuh`) or the flags
change, since the file name carries a hash of them. Nothing here runs at
import time, so the CPU tests import every module without `nvcc`.

Each kernel wrapper adds one to `launch_counts[<name>]` where it launches
its kernel, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "yolov3_tpu_torch")
# the libraries; `s2d_region_block_q` also holds the `s2d_tail_block_q`
# entry point, `nms_suppress` its first design `nms_suppress_chain`
KERNELS = ("nms_suppress", "pointwise_conv_block", "pointwise_conv_block_q",
           "conv3x3_block_q", "down_conv_block_q", "exit_conv_block_q",
           "s2d_region_block_q", "greedy_suppress")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


def _target(name: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers (`csrc/*.cuh`) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> None:
    """Build one kernel's library unless it is built for this source."""
    target = _target(name)
    if os.path.exists(target):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                        os.path.join(CSRC_DIR, f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, target)


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile the given kernels, one nvcc process each, all at once."""
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(_compile, names))


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        _compile(name)
        lib = ctypes.CDLL(_target(name))
        _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a CUDA error code returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
