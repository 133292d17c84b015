"""Zero-copy shared-memory batch transport for the raw-mode reader (copy
of `yolov3_tpu/data/shm_ring.py`).

The per-example `mp.Queue` transport pickles each image through a pipe
(one pickle, two kernel copies, one unpickle, then a parent-side
`np.stack`), as the reference's LMDB reader does
(reference/imagereader.py:171,412-416). For `--shm_feed` the workers
instead assemble ENTIRE batches in place inside a ring of shared-memory
slots (one mmap'd file in `/dev/shm`), and the parent hands out numpy
views: the only per-pixel host cost left is the worker's one copy from
the record into the slot, and the prefetcher's copy into pinned memory.

Each slot holds one batch: images `[B,H,W,C]` (source dtype: uint8
pixels cost 4x less than float32 here and over PCIe), boxes `[B,M,5]`
float32, valid `[B,M]` bool. Slot ownership moves through two small
queues of slot indices (free -> a worker fills it -> ready -> the parent
yields it -> free), so the arrays themselves never travel.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import uuid
from typing import Dict, Tuple

import numpy as np

_ALIGN = 128  # keep every region cache-line/vector aligned


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def ring_dir() -> str:
    """Where rings are created: /dev/shm when present."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def free_bytes(path: str) -> int:
    """Bytes free to an unprivileged writer on `path`'s filesystem."""
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


class BatchRing:
    """A ring of pre-assembled raw batches in one shared mmap'd file.

    Created by the parent (`path=None` allocates under /dev/shm when
    present); workers attach by path via `BatchRing.attach(spec)`.
    `views(slot)` returns writable numpy views aliasing the shared pages,
    valid until the slot is recycled.

    `ftruncate` makes a sparse file, so a /dev/shm too small for the ring
    would show up only later, as SIGBUS in a worker that touches a page:
    creating a ring checks the free space first and raises with the
    bytes it needs.
    """

    def __init__(self, batch: int, image_shape: Tuple[int, int, int],
                 image_dtype, max_boxes: int, num_slots: int,
                 path: str = None):
        self.batch = int(batch)
        self.image_shape = tuple(int(s) for s in image_shape)
        self.image_dtype = np.dtype(image_dtype)
        self.max_boxes = int(max_boxes)
        self.num_slots = int(num_slots)

        img_bytes = self.batch * int(np.prod(self.image_shape)) \
            * self.image_dtype.itemsize
        boxes_bytes = self.batch * self.max_boxes * 5 * 4
        valid_bytes = self.batch * self.max_boxes
        self._off_boxes = _aligned(img_bytes)
        self._off_valid = self._off_boxes + _aligned(boxes_bytes)
        self.slot_bytes = self._off_valid + _aligned(valid_bytes)
        self.total_bytes = self.slot_bytes * self.num_slots

        self._created = path is None
        if self._created:
            base = ring_dir()
            free = free_bytes(base)
            if free < self.total_bytes:
                raise OSError(
                    f"{base} has {free} bytes free; the batch ring needs "
                    f"{self.total_bytes} ({self.num_slots} slots of "
                    f"{self.slot_bytes}). Enlarge it (docker run "
                    f"--shm-size) or use fewer reader workers.")
            path = os.path.join(
                base, f"yolov3-ring-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, self.total_bytes)
                self._mm = mmap.mmap(fd, self.total_bytes)
            finally:
                os.close(fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, self.total_bytes)
            finally:
                os.close(fd)
        self.path = path
        self._closed = False

    # -- cross-process handoff (spec is plain picklable data) ----------------

    def spec(self) -> Dict:
        return dict(batch=self.batch, image_shape=self.image_shape,
                    image_dtype=self.image_dtype.str,
                    max_boxes=self.max_boxes, num_slots=self.num_slots,
                    path=self.path)

    @classmethod
    def attach(cls, spec: Dict) -> "BatchRing":
        return cls(**spec)

    # -- access ---------------------------------------------------------------

    def views(self, slot: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} not in [0, {self.num_slots})")
        base = slot * self.slot_bytes
        b, m = self.batch, self.max_boxes
        imgs = np.frombuffer(self._mm, self.image_dtype,
                             count=b * int(np.prod(self.image_shape)),
                             offset=base).reshape(b, *self.image_shape)
        boxes = np.frombuffer(self._mm, np.float32, count=b * m * 5,
                              offset=base + self._off_boxes
                              ).reshape(b, m, 5)
        valid = np.frombuffer(self._mm, np.bool_, count=b * m,
                              offset=base + self._off_valid).reshape(b, m)
        return imgs, boxes, valid

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except BufferError:
            # live numpy views still alias the mapping; the pages are
            # released when they are garbage-collected instead
            pass
        if unlink and self._created:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
