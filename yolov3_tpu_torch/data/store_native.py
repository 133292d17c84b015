"""ctypes binding of the native YDB engine (port of
`yolov3_tpu/data/store_native.py`).

The engine is the repo's `native/yolodb.cpp`: the same on-disk format as
the pure-Python `store.py`, with zero-copy reads out of a C++ mmap. The
port builds its own copy of the library at first use,

    g++ -O2 -std=c++17 -shared -fPIC -o build/yolov3_tpu_torch/libyolodb-<hash>.so native/yolodb.cpp

named by a hash of the source and the flags, written through a temporary
file and `os.replace` so that two processes never load a half-written
library. It never writes into `native/build/`. `store.open_reader`
prefers this reader; the reader's workers find the library their parent
built when it opened the store.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "yolodb.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "yolov3_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LIB = None
# why the library could not be built or loaded, once that has failed
_LOAD_ERROR = None


def library_path() -> str:
    """The library's path, named by a hash of the source and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libyolodb-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built for this source; returns
    its path. Raises if there is no C++ compiler or the build fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native store")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    """The engine's library, built on first use, with every function's
    argument and result types declared. A failed build or load raises
    again on later calls without retrying."""
    global _LIB, _LOAD_ERROR
    if _LIB is not None:
        return _LIB
    if _LOAD_ERROR is not None:
        raise _LOAD_ERROR
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError) as e:
        _LOAD_ERROR = e
        raise
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    sigs = {
        "ydb_reader_open": (ctypes.c_void_p, [ctypes.c_char_p]),
        "ydb_reader_count": (ctypes.c_uint64, [ctypes.c_void_p]),
        "ydb_reader_key": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char_p), u32p]),
        "ydb_reader_get": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_void_p), u64p]),
        "ydb_reader_map": (None, [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), u64p]),
        "ydb_reader_get_batch": (ctypes.c_uint64, [
            ctypes.c_void_p, ctypes.c_char_p, u32p, ctypes.c_uint64,
            u64p, u64p]),
        "ydb_reader_close": (None, [ctypes.c_void_p]),
        "ydb_writer_open": (ctypes.c_void_p, [ctypes.c_char_p]),
        "ydb_writer_put": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint64]),
        "ydb_writer_flush": (ctypes.c_int, [ctypes.c_void_p]),
        "ydb_writer_close": (ctypes.c_int, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the engine's library builds and loads here, so whether
    `store.open_reader` takes the native reader. (The JAX package's
    asks whether its prebuilt library exists: the port builds its own at
    first use.)"""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


class NativeRecordReader:
    """Drop-in for `store.RecordReader` over the C++ engine. Views from
    `get`/`get_batch` alias the engine's mapping: they are valid until
    `close()`."""

    kind = "native"

    def __init__(self, db_path: str):
        if not os.path.isdir(db_path):
            raise FileNotFoundError(f"Missing database: {db_path}")
        self._lib = load()
        self._h = self._lib.ydb_reader_open(db_path.encode())
        if not self._h:
            raise ValueError(f"Not a YDB database: {db_path}")
        # one long-lived zero-copy view over the whole data-log mapping;
        # get/get_batch serve slices of it
        base = ctypes.c_void_p()
        mlen = ctypes.c_uint64()
        self._lib.ydb_reader_map(self._h, ctypes.byref(base),
                                 ctypes.byref(mlen))
        self._map_view = memoryview(
            (ctypes.c_char * mlen.value).from_address(base.value))

    def __len__(self) -> int:
        return int(self._lib.ydb_reader_count(self._h))

    def keys(self) -> List[bytes]:
        out = []
        kp = ctypes.c_char_p()
        kl = ctypes.c_uint32()
        for i in range(len(self)):
            if self._lib.ydb_reader_key(self._h, i, ctypes.byref(kp),
                                        ctypes.byref(kl)) == 0:
                out.append(ctypes.string_at(kp, kl.value))
        return out

    def get(self, key: bytes) -> Optional[memoryview]:
        if isinstance(key, str):
            key = key.encode("ascii")
        vp = ctypes.c_void_p()
        vl = ctypes.c_uint64()
        if self._lib.ydb_reader_get(self._h, key, len(key), ctypes.byref(vp),
                                    ctypes.byref(vl)) != 0:
            return None
        return memoryview((ctypes.c_char * vl.value).from_address(vp.value))

    def get_batch(self, keys: Sequence[bytes]) -> List[Optional[memoryview]]:
        """Look up many keys in one call into the engine, which fills
        offset and length arrays; Python only slices the mapping's view."""
        n = len(keys)
        if n == 0:
            return []
        keys = [k.encode("ascii") if isinstance(k, str) else k for k in keys]
        concat = b"".join(keys)
        klens = np.fromiter((len(k) for k in keys), np.uint32, count=n)
        offs = np.empty(n, np.uint64)
        vlens = np.empty(n, np.uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.ydb_reader_get_batch(
            self._h, concat, klens.ctypes.data_as(u32p), n,
            offs.ctypes.data_as(u64p), vlens.ctypes.data_as(u64p))
        mv = self._map_view
        return [mv[o:o + n_] if o else None
                for o, n_ in zip(offs.tolist(), vlens.tolist())]

    def close(self) -> None:
        if self._h:
            self._map_view = None
            self._lib.ydb_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRecordWriter:
    """Drop-in for `store.RecordWriter` over the C++ engine."""

    def __init__(self, db_path: str, overwrite: bool = True):
        lib = load()
        if os.path.exists(db_path):
            if not overwrite:
                raise FileExistsError(db_path)
            shutil.rmtree(db_path)
        self._lib = lib
        self._h = lib.ydb_writer_open(db_path.encode())
        if not self._h:
            raise OSError(f"cannot create database: {db_path}")
        self._count = 0

    def put(self, key: bytes, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode("ascii")
        if self._lib.ydb_writer_put(self._h, key, len(key), value,
                                    len(value)) != 0:
            raise OSError("ydb write failed")
        self._count += 1

    def flush(self) -> None:
        self._lib.ydb_writer_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ydb_writer_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
