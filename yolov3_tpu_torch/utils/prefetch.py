"""Background host -> device batch staging (port of
`yolov3_tpu/utils/prefetch.py`; tf.data's `.prefetch`,
reference/train.py:61,65).

A daemon thread pulls numpy batches from the reader, copies each array
into pinned host memory and from there onto the card with `non_blocking`
copies on a side CUDA stream, runs the optional `transform` (the device
preprocessing of `--device_augment`) on that stream, and records an
event there. So the preprocessing of batch k+1 overlaps step k, as the
JAX trainer's `DevicePrefetcher(feed(...), lambda b: b)` does. `next()`
makes the consuming stream wait on that event before the step reads the
batch, and hands the batch's memory over to that stream. On the CPU the
arrays are copied into tensors and transformed. Every array is copied
before the source is advanced, so a source may hand out views that its
next item recycles (`data/reader.py::ShmBatchReader`). At most `depth`
batches wait staged.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

_SENTINEL = object()


class DevicePrefetcher:
    """Iterate `source` (tuples of numpy arrays) as tuples of tensors on
    `device`, staged `depth` ahead in a background thread. An exception
    in the thread re-raises at the consuming `next()`. `wait_s` sums the
    time `next()` waited for a batch. `transform`, when given, maps the
    staged tuple of tensors to the tuple the consumer receives."""

    def __init__(self, source: Iterator[Sequence[np.ndarray]], device,
                 depth: int = 2,
                 transform: Optional[Callable[[tuple], tuple]] = None):
        self._source = source
        self._transform = transform
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        if not self._cuda:
            out = tuple(torch.from_numpy(np.array(a)) for a in batch)
            if self._transform:
                out = tuple(self._transform(out))
            return out, None
        with torch.cuda.stream(self._stream):
            # pin_memory() copies synchronously: the card's copy reads the
            # pinned copy, never the source's (possibly recycled) memory
            out = tuple(torch.from_numpy(np.asarray(a)).pin_memory().to(
                self._device, non_blocking=True) for a in batch)
            if self._transform:
                out = tuple(self._transform(out))
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stopped.is_set():
                    return
                self._q.put(self._stage(item))
        except BaseException as e:  # surfaced to the consumer
            self._error = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        out, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in out:
                # the side stream allocated it; the step's stream uses it
                t.record_stream(stream)
        return out

    def stop(self) -> None:
        self._stopped.set()
        # unblock the producer if it is waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
