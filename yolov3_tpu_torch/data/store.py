"""YDB: an embedded, memory-mapped, append-only record store (copy of
`yolov3_tpu/data/store.py`'s pure-Python writer and reader, on the same
on-disk format, so a store written by either package reads in the other).

This plays the role LMDB plays in the reference (reference/build_lmdb.py:80,
reference/imagereader.py:103): a single-writer, many-reader key/value store
holding serialized `ImageYoloBoxesPair` records, safe to share read-only
across data-loader worker processes.

Design (TPU-host-native, not an LMDB clone):
- `<db>/data.ydb`   append-only log: magic | [u32 klen][u64 vlen][key][value]*
- `<db>/index.ydb`  footer index written on close: per record
                    [u32 klen][key][u64 value_offset][u64 vlen]
- readers mmap `data.ydb` and serve zero-copy `memoryview`s; when the index
  file is missing or stale the log is rescanned (crash-safe).
- key iteration order == insertion order, which the class-balancing reader
  relies on (reference/imagereader.py:113-144 iterates the LMDB cursor).

`open_reader` prefers the native reader (`store_native.py`, over the
repo's `native/yolodb.cpp`), as the JAX package's does, and falls back
to the pure-Python reader only where the native library cannot be
built; each reader's `kind` says which it is.
"""

from __future__ import annotations

import os
import mmap
import struct
from typing import Dict, List, Optional, Tuple

MAGIC = b"YDBSTOR1"
_REC_HDR = struct.Struct("<IQ")  # klen, vlen
_IDX_ENT = struct.Struct("<QQ")  # value offset, vlen

DATA_FILE = "data.ydb"
INDEX_FILE = "index.ydb"


class RecordWriter:
    """Single-writer append handle. Not thread-safe; use one per process."""

    def __init__(self, db_path: str, overwrite: bool = True):
        if os.path.exists(db_path):
            if overwrite:
                import shutil
                shutil.rmtree(db_path)
            else:
                raise FileExistsError(db_path)
        os.makedirs(db_path)
        self._db_path = db_path
        self._fh = open(os.path.join(db_path, DATA_FILE), "wb")
        self._fh.write(MAGIC)
        self._offset = len(MAGIC)
        self._index: List[Tuple[bytes, int, int]] = []
        self._closed = False

    def put(self, key: bytes, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode("ascii")
        self._fh.write(_REC_HDR.pack(len(key), len(value)))
        self._fh.write(key)
        val_off = self._offset + _REC_HDR.size + len(key)
        self._fh.write(value)
        self._index.append((key, val_off, len(value)))
        self._offset = val_off + len(value)

    def flush(self) -> None:
        """Durability point — the analog of the reference's periodic
        txn.commit every 1000 puts (reference/build_lmdb.py:101-103)."""
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.close()
        with open(os.path.join(self._db_path, INDEX_FILE), "wb") as idx:
            idx.write(MAGIC)
            idx.write(struct.pack("<Q", len(self._index)))
            for key, off, vlen in self._index:
                idx.write(struct.pack("<I", len(key)))
                idx.write(key)
                idx.write(_IDX_ENT.pack(off, vlen))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return len(self._index)


class RecordReader:
    """Zero-copy mmap reader. Safe to open independently in many processes."""

    kind = "python"

    def __init__(self, db_path: str):
        if not os.path.isdir(db_path):
            raise FileNotFoundError(f"Missing database: {db_path}")
        data_path = os.path.join(db_path, DATA_FILE)
        self._fh = open(data_path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[: len(MAGIC)] != MAGIC:
            raise ValueError(f"Not a YDB database: {data_path}")

        self._keys: List[bytes] = []
        self._table: Dict[bytes, Tuple[int, int]] = {}
        idx_path = os.path.join(db_path, INDEX_FILE)
        if os.path.exists(idx_path) and self._load_index(idx_path):
            return
        self._scan_log()

    def _load_index(self, idx_path: str) -> bool:
        with open(idx_path, "rb") as idx:
            blob = idx.read()
        if blob[: len(MAGIC)] != MAGIC:
            return False
        pos = len(MAGIC)
        (count,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        try:
            for _ in range(count):
                (klen,) = struct.unpack_from("<I", blob, pos)
                pos += 4
                key = blob[pos:pos + klen]
                pos += klen
                off, vlen = _IDX_ENT.unpack_from(blob, pos)
                pos += _IDX_ENT.size
                if off + vlen > len(self._mm):
                    return False  # stale index
                self._keys.append(key)
                self._table[key] = (off, vlen)
        except struct.error:
            self._keys.clear()
            self._table.clear()
            return False
        return True

    def _scan_log(self) -> None:
        pos = len(MAGIC)
        end = len(self._mm)
        while pos + _REC_HDR.size <= end:
            klen, vlen = _REC_HDR.unpack_from(self._mm, pos)
            pos += _REC_HDR.size
            if pos + klen + vlen > end:
                break  # truncated tail record
            key = bytes(self._mm[pos:pos + klen])
            pos += klen
            self._keys.append(key)
            self._table[key] = (pos, vlen)
            pos += vlen

    def keys(self) -> List[bytes]:
        return list(self._keys)

    def get(self, key: bytes) -> Optional[memoryview]:
        if isinstance(key, str):
            key = key.encode("ascii")
        ent = self._table.get(key)
        if ent is None:
            return None
        off, vlen = ent
        return memoryview(self._mm)[off:off + vlen]

    def get_batch(self, keys) -> List[Optional[memoryview]]:
        return [self.get(k) for k in keys]

    def __len__(self) -> int:
        return len(self._keys)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # zero-copy views handed out by get() are still alive;
                # leave the mapping for the GC to reclaim with them
                pass
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_reader(db_path: str):
    """Open a read handle: the native reader, built at first use, else
    (no C++ compiler, or its build failed) the pure-Python one, with the
    reason printed. Both serve the same bytes; `.kind` names it."""
    from yolov3_tpu_torch.data import store_native
    try:
        store_native.load()
    except (OSError, RuntimeError) as e:
        print(f"native store reader unavailable, reading {db_path} with "
              f"the pure-Python reader: {e}")
        return RecordReader(db_path)
    return store_native.NativeRecordReader(db_path)
