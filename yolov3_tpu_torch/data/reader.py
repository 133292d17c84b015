"""Parallel prefetching dataset reader (copy of `yolov3_tpu/data/reader.py`).

The training-side equivalent of the reference's multiprocess LMDB reader
(reference/imagereader.py:79-460): N worker processes read records from a
shared read-only YDB store, augment, normalize, and YOLO-encode them on the
host, and push device-ready examples through a bounded queue.

Semantics preserved:
- class-count inference from record keys, including the "empty image"
  pseudo-class remap (reference/imagereader.py:110-156): images whose key
  has an empty class list get a dedicated balancing bucket at index 0 and
  every real class id shifts up by one; the pseudo-class does NOT count
  toward `number_classes`.
- sampling: uniform-over-classes then uniform-within-class when balancing
  (re-drawing empty buckets), plain uniform when shuffled, and strided
  sequential (start = worker id, stride = worker count) when not shuffled
  (reference/imagereader.py:224-250).
- hardcoded augmentation severities (reference/imagereader.py:370-378) via
  `AugmentConfig` defaults.
- bounded output queue of 10x workers with starvation warnings at <10% fill
  and recovery at >50% (reference/imagereader.py:171,422-431).
- clean shutdown: one terminate token per worker, drain until one `None`
  sentinel per worker, then join (reference/imagereader.py:203-222,418-420).

Differences from the reference: examples are NHWC float32, not CHW, and
`batches()` yields stacked numpy batches, which `utils/prefetch.py`
stages onto the card. In raw mode (`--device_augment`) the workers only
decode and pad the boxes; `data/device_pipeline.py` does the rest on the
card. `ShmBatchReader` (`--shm_feed`) moves raw batches through a
shared-memory ring instead of per-example pickles. `shard=(rank, world)`
gives each data-parallel process an equal, disjoint 1/world of the
store (the JAX reader's multi-host shard). Worker-reachable modules
(this one, `config`, `augment`, `records`, `encoder`, `imaging`,
`store`, `store_native`, `shm_ring`) import no torch and make no CUDA
call.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import random
import traceback
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from yolov3_tpu_torch.config import AugmentConfig
from yolov3_tpu_torch.data import augment as aug
from yolov3_tpu_torch.data import records
from yolov3_tpu_torch.data.encoder import (MAX_BOXES, encode_boxes,
                                           grid_shapes, pad_boxes)
from yolov3_tpu_torch.data.imaging import zscore_normalize
from yolov3_tpu_torch.data.shm_ring import BatchRing
from yolov3_tpu_torch.data.store import open_reader

Example = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _mp_context():
    """Worker start method: never `fork`.

    The training process has initialised CUDA and runs threads (the
    prefetcher's); a forked child must not touch either. `forkserver`
    forks workers from a clean single-threaded server process that has
    this module preloaded; `spawn` where it is unavailable.
    """
    try:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["yolov3_tpu_torch.data.reader"])
        return ctx
    except ValueError:  # platform without forkserver
        return multiprocessing.get_context("spawn")


_MP = _mp_context()


class DatasetReader:
    """Multiprocess prefetching reader over a YDB record database."""

    def __init__(self, img_db: str,
                 anchors: Sequence[Tuple[float, float]],
                 use_augmentation: bool = True,
                 balance_classes: bool = False,
                 shuffle: bool = True,
                 num_workers: int = 1,
                 augment_config: Optional[AugmentConfig] = None,
                 raw_mode: bool = False,
                 shard: Optional[Tuple[int, int]] = None):
        if not os.path.exists(img_db):
            raise FileNotFoundError(f"Missing database: {img_db}")
        if shard is not None:
            rank, world = int(shard[0]), int(shard[1])
            if not 0 <= rank < world:
                raise ValueError(f"shard rank {rank} not in [0, {world})")
            shard = (rank, world) if world > 1 else None
        # data parallelism: (rank, world) restricts this process to an
        # equal-size, disjoint 1/world slice of the store; the class census
        # still spans the whole store, so every rank derives the same
        # number_classes and label shapes
        self.shard = shard
        self.image_db = img_db
        self.anchors = [tuple(a) for a in anchors]
        self.use_augmentation = use_augmentation
        self.balance_classes = balance_classes
        self.shuffle = shuffle
        self.nb_workers = num_workers
        self.augment_config = augment_config or AugmentConfig()
        # raw mode: workers only decode records and emit (image HWC in its
        # source dtype, boxes [MAX_BOXES, 5] f32, valid [MAX_BOXES]);
        # augmentation, z-score and label encoding then run on the card
        # (data/device_pipeline.py)
        self.raw_mode = raw_mode
        self.queue_starvation = False

        self._scan_database()

        self.max_out_qsize = num_workers * 10
        self._terminate_q = _MP.Queue(maxsize=num_workers)
        self._out_q = _MP.Queue(maxsize=self.max_out_qsize)
        self._id_q = _MP.Queue(maxsize=num_workers)
        self._workers: Optional[List[multiprocessing.Process]] = None

    def __getstate__(self):
        # workers receive a pickled copy of self (forkserver/spawn start);
        # live Process handles are parent-only state
        state = self.__dict__.copy()
        state["_workers"] = None
        return state

    # -- database scan -------------------------------------------------------

    def _scan_database(self) -> None:
        """Two-pass key scan: class census, then per-class key buckets.
        Opening the store here, in the parent, also builds the native
        reader's library before any worker needs it."""
        reader = open_reader(self.image_db)
        self.store_kind = reader.kind
        try:
            all_keys = reader.keys()
            if not all_keys:
                raise ValueError(f"Database {self.image_db} is empty")

            empty_images = False
            highest_class = 0
            for key in all_keys:
                for k in records.parse_key_classes(key):
                    if len(k) == 0:
                        empty_images = True
                    else:
                        highest_class = max(highest_class, int(k))

            if self.shard is not None:
                rank, world = self.shard
                # truncate to a multiple of world so every rank's shard,
                # and so its epoch accounting, has the same size: unequal
                # step counts would leave a collective waiting
                usable = len(all_keys) - (len(all_keys) % world)
                if usable == 0:
                    raise ValueError(
                        f"Database {self.image_db} has {len(all_keys)} "
                        f"records, fewer than the {world} ranks sharding "
                        f"it")
                all_keys = [all_keys[i] for i in range(rank, usable, world)]

            bucket_count = highest_class + 1 + (1 if empty_images else 0)
            self.keys: List[List[bytes]] = [[] for _ in range(bucket_count)]
            self.keys_flat: List[bytes] = []
            for key in all_keys:
                self.keys_flat.append(key)
                for k in records.parse_key_classes(key):
                    if len(k) == 0:
                        idx = 0
                    else:
                        idx = int(k) + 1 if empty_images else int(k)
                    self.keys[idx].append(key)

            self.empty_images_flag = empty_images
            self.number_classes = (len(self.keys) - 1 if empty_images
                                   else len(self.keys))

            img, _ = records.decode_record(reader.get(all_keys[0]))
            self.image_size = [img.shape[0], img.shape[1], img.shape[2]]
            self.image_dtype = img.dtype
        finally:
            reader.close()

    # -- introspection (reference/imagereader.py:180-188) ---------------------

    def get_image_size(self) -> List[int]:
        return self.image_size

    def get_number_classes(self) -> int:
        return self.number_classes

    def get_image_count(self) -> int:
        return len(self.keys_flat)

    def class_counts(self) -> List[int]:
        return [len(b) for b in self.keys]

    def label_shapes(self) -> List[Tuple[int, int, int, int]]:
        return grid_shapes(self.image_size, len(self.anchors),
                           self.number_classes)

    # -- worker pool lifecycle ------------------------------------------------

    def startup(self) -> None:
        for i in range(self.nb_workers):
            self._id_q.put(i)
        workers = []
        for _ in range(self.nb_workers):
            w = _MP.Process(target=self._worker_main)
            w.daemon = True
            w.start()
            workers.append(w)
        self._workers = workers

    def shutdown(self) -> None:
        if self._workers is None:
            return
        for _ in self._workers:
            self._terminate_q.put(None)
        # drain until every worker's None sentinel arrives, so workers
        # blocked on a full queue can exit
        sentinels = 0
        while sentinels < len(self._workers):
            try:
                while True:
                    if self._out_q.get(timeout=1.0) is None:
                        sentinels += 1
            except queue.Empty:
                # re-check: a worker may have crashed before its sentinel
                if all(not w.is_alive() for w in self._workers):
                    break
        for w in self._workers:
            w.join()
        self._workers = None

    # -- sampling (reference/imagereader.py:224-250) ---------------------------

    def _next_key(self, rng: random.Random) -> bytes:
        if self.shuffle:
            if self.balance_classes:
                bucket = self.keys[rng.randint(0, len(self.keys) - 1)]
                while len(bucket) == 0:
                    bucket = self.keys[rng.randint(0, len(self.keys) - 1)]
                return bucket[rng.randint(0, len(bucket) - 1)]
            return self.keys_flat[rng.randint(0, len(self.keys_flat) - 1)]
        key = self.keys_flat[self._key_idx]
        self._key_idx = (self._key_idx + self.nb_workers) % len(self.keys_flat)
        return key

    # -- worker ---------------------------------------------------------------

    def _load_example(self, rec, key: bytes,
                      rng_np: np.random.RandomState,
                      rng: random.Random) -> Example:
        if rec is None:
            raise KeyError(f"record missing from database: {key!r}")
        img, boxes = records.decode_record(rec)
        if list(img.shape) != list(self.image_size):
            raise RuntimeError(
                f"Unexpected image shape from database. Expected "
                f"{self.image_size}. Found {list(img.shape)}.")

        if self.raw_mode:
            padded, valid = pad_boxes(boxes.astype(np.float32))
            # the source dtype: uint8 pixels cost 4x less through the
            # worker queue and the host-to-device copy
            return (img, padded, valid)

        crop_to = [self.image_size[0], self.image_size[1]]
        if self.use_augmentation:
            ac = self.augment_config
            img = img.astype(np.float32)
            img, boxes = aug.augment_image_box_pair(
                img, boxes,
                reflection_flag=ac.reflection_flag,
                rotation_flag=ac.rotation_flag,
                crop_to=crop_to,
                noise_augmentation_severity=ac.noise_augmentation_severity,
                scale_augmentation_severity=ac.scale_augmentation_severity,
                blur_augmentation_max_sigma=ac.blur_augmentation_max_sigma,
                box_size_augmentation_severity=ac.box_size_augmentation_severity,
                box_location_jitter_severity=ac.box_location_jitter_severity,
                rng=rng_np)

        if img.shape[0] != crop_to[0] or img.shape[1] != crop_to[1]:
            img, boxes = aug.crop_to_size(img, boxes, crop_to, rng=rng_np)

        img = zscore_normalize(img)
        labels = encode_boxes(boxes, self.image_size, self.anchors,
                              self.number_classes)
        return (img.astype(np.float32), labels[0], labels[1], labels[2])

    def _worker_main(self) -> None:
        worker_id = self._id_q.get()
        # non-shuffle stride offset; wrap so worker pools larger than the
        # dataset still work (the reference would index out of range here,
        # reference/imagereader.py:246 — it never ran workers > images)
        self._key_idx = worker_id % len(self.keys_flat)
        seed = (os.getpid() * 7919 + worker_id) & 0x7FFFFFFF
        rng = random.Random(seed)
        rng_np = np.random.RandomState(seed)
        try:
            reader = open_reader(self.image_db)
            # draw keys in chunks of 16, as the JAX reader does (it
            # batches its native store's reads)
            chunk = 16
            terminated = False
            while not terminated:
                keys = [self._next_key(rng) for _ in range(chunk)]
                recs = reader.get_batch(keys)
                for key, rec in zip(keys, recs):
                    try:
                        if self._terminate_q.get_nowait() is None:
                            terminated = True
                            break
                    except queue.Empty:
                        pass
                    self._out_q.put(self._load_example(rec, key, rng_np, rng))
        except Exception as e:
            print("***************** Reader Error *****************")
            print(e)
            traceback.print_exc()
            print("***************** Reader Error *****************")
        finally:
            self._out_q.put(None)

    # -- consumption ------------------------------------------------------------

    def get_example(self) -> Optional[Example]:
        qsize = self._out_q.qsize()
        if qsize < int(0.1 * self.max_out_qsize):
            if not self.queue_starvation:
                print("Input Queue Starvation !!!!")
            self.queue_starvation = True
        if self.queue_starvation and qsize > int(0.5 * self.max_out_qsize):
            print("Input Queue Starvation Over")
            self.queue_starvation = False
        while True:
            try:
                return self._out_q.get(timeout=5.0)
            except queue.Empty:
                # workers that die in process bootstrap (e.g. an unguarded
                # __main__ under the spawn/forkserver start method) never
                # post their None sentinel — fail loudly instead of
                # blocking the training loop forever
                if self._workers and all(not w.is_alive()
                                         for w in self._workers):
                    raise RuntimeError(
                        "All reader worker processes died without producing "
                        "data. If they crashed at startup, ensure the "
                        "launching script guards its entry point with "
                        "`if __name__ == '__main__':` (required by the "
                        "spawn/forkserver start method).")

    def generator(self) -> Iterator[Example]:
        while True:
            example = self.get_example()
            if example is None:
                return
            yield example

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield stacked batches.

        Full mode: (images NHWC, label_s32, label_s16, label_s8).
        Raw mode: (images NHWC, boxes [B,M,5], valid [B,M]).
        """
        gen = self.generator()
        while True:
            parts: List[Example] = []
            for _ in range(batch_size):
                ex = next(gen, None)
                if ex is None:
                    return
                parts.append(ex)
            yield tuple(np.stack([p[i] for p in parts])
                        for i in range(len(parts[0])))

    def __enter__(self):
        self.startup()
        return self

    def __exit__(self, *exc):
        self.shutdown()


class ShmBatchReader(DatasetReader):
    """Raw-mode reader whose workers assemble whole batches into a
    shared-memory ring (`data/shm_ring.py::BatchRing`).

    Only slot indices travel through queues. Workers claim a free slot,
    fill its (images [B,H,W,C] source dtype, boxes [B,M,5] f32, valid
    [B,M] bool) arrays in place, and post the index; `batches()` yields
    zero-copy views.

    Contract: the yielded arrays alias the ring and are valid only until
    the NEXT `next()` on the iterator, which recycles the slot.
    `utils/prefetch.py::DevicePrefetcher` meets it: its thread copies
    each batch (into pinned memory on the card's host) before it pulls
    the next one. A reader is single-shot: `shutdown()` unlinks the
    ring.

    Sampling, the class census, starvation telemetry and the shutdown
    protocol are the base reader's.
    """

    def __init__(self, img_db: str,
                 anchors: Sequence[Tuple[float, float]],
                 batch_size: int,
                 num_slots: Optional[int] = None,
                 **kw):
        kw["raw_mode"] = True
        super().__init__(img_db, anchors, **kw)
        self.batch_size = int(batch_size)
        self.num_slots = int(num_slots or (self.nb_workers + 2))
        self._ring = BatchRing(batch=self.batch_size,
                               image_shape=tuple(self.image_size),
                               image_dtype=self.image_dtype,
                               max_boxes=MAX_BOXES,
                               num_slots=self.num_slots)
        self._ring_spec = self._ring.spec()
        self._free_q = _MP.Queue(maxsize=self.num_slots)
        for s in range(self.num_slots):
            self._free_q.put(s)
        # starvation telemetry counts ready slots, not queued examples
        self.max_out_qsize = self.num_slots

    def __getstate__(self):
        state = super().__getstate__()
        state["_ring"] = None  # workers attach by path via _ring_spec
        return state

    def _worker_main(self) -> None:
        worker_id = self._id_q.get()
        self._key_idx = worker_id % len(self.keys_flat)
        seed = (os.getpid() * 7919 + worker_id) & 0x7FFFFFFF
        rng = random.Random(seed)
        ring = None
        try:
            ring = BatchRing.attach(self._ring_spec)
            reader = open_reader(self.image_db)
            terminated = False
            while not terminated:
                slot = None
                while slot is None:
                    try:
                        if self._terminate_q.get_nowait() is None:
                            terminated = True
                            break
                    except queue.Empty:
                        pass
                    try:
                        slot = self._free_q.get(timeout=0.25)
                    except queue.Empty:
                        continue
                if terminated:
                    break
                imgs, boxes, valid = ring.views(slot)
                keys = [self._next_key(rng) for _ in range(self.batch_size)]
                recs = reader.get_batch(keys)
                for i, (key, rec) in enumerate(zip(keys, recs)):
                    if rec is None:
                        raise KeyError(
                            f"record missing from database: {key!r}")
                    img, bx = records.decode_record(rec)
                    if list(img.shape) != list(self.image_size):
                        raise RuntimeError(
                            f"Unexpected image shape from database. "
                            f"Expected {self.image_size}. "
                            f"Found {list(img.shape)}.")
                    imgs[i] = img
                    boxes[i], valid[i] = pad_boxes(bx.astype(np.float32))
                del imgs, boxes, valid
                self._out_q.put(slot)
        except Exception as e:
            print("***************** Reader Error *****************")
            print(e)
            traceback.print_exc()
            print("***************** Reader Error *****************")
        finally:
            if ring is not None:
                ring.close()
            self._out_q.put(None)

    def batches(self, batch_size: Optional[int] = None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield zero-copy (images, boxes, valid) views from the ring."""
        if batch_size not in (None, self.batch_size):
            raise ValueError(
                f"ShmBatchReader was sized for batch {self.batch_size}, "
                f"got {batch_size}")
        while True:
            slot = self.get_example()
            if slot is None:
                return
            try:
                yield self._ring.views(slot)
            finally:
                self._free_q.put(slot)

    def generator(self):
        raise NotImplementedError(
            "ShmBatchReader transports whole batches; use batches()")

    def shutdown(self) -> None:
        super().shutdown()
        self._ring.close(unlink=True)
