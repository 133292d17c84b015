#!/usr/bin/env python3
"""Compare the machine code (SASS) of two builds of the stem region's
library, kernel by kernel, on a machine with the CUDA toolkit.

    python3 scripts/region_sass_diff.py OLD.cu NEW.cu

Builds each source with the flags of `ops/kernels/_build.py` into a cubin
(sm_90a), disassembles it with cuobjdump, and prints for every kernel
both sides have (the persistent kernel's instances by region, x's kind
and epilogue mode; the first design's by region) the instruction counts
and whether the instruction sequences are equal once addresses,
encodings and constants are set aside; then the first lines that differ
of the serving instance (region, bf16 x, fast epilogue).
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from yolov3_tpu_torch.ops.kernels import _build  # noqa: E402

SERVING = "region_kernel90ILb1ELi1ELi1E"


def functions(src: str, out: str) -> dict:
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", out, src],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", out], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            k = re.search(r"region_kernel90ILb\dELi\dELi\dE|"
                          r"region_kernelILb\dE", m.group(1))
            name = k.group(0) if k else m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return funcs


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp()
    old, new = (functions(src, os.path.join(tmp, f"{i}.cubin"))
                for i, src in enumerate(argv))
    for k in sorted(set(old) & set(new)):
        print(f"{k}: {len(old[k])} instructions against {len(new[k])}, "
              f"equal {old[k] == new[k]}")
    if SERVING in old and SERVING in new:
        diff = list(difflib.unified_diff(old[SERVING], new[SERVING],
                                         lineterm="", n=0))
        print(f"{SERVING}: {len(diff)} diff lines")
        print("\n".join(diff[:40]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
