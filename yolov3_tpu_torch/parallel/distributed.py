"""Data parallelism over processes: one process per device (port of
`yolov3_tpu/parallel/mesh.py`, the reference's MirroredStrategy
plumbing, reference/train.py:38-66).

The JAX package lays a 1-D mesh over the chips and splits the global
batch along its `data` axis; here each device has its own process, joined
by a `torch.distributed` group (NCCL between cards, gloo on the CPU, or
for several ranks on one card), and each rank reads its own shard of the
store (`data/reader.py`, `shard=(rank, world)`). The train step's
cross-replica reductions are explicit collectives on the group
(`all_reduce_sum_`, `average_`; `parallel/train_step.py`).

Serving shards a batch over a device list instead (`shard_detector`, the
reference's inference.py:73-90): one model replica per device, the batch
padded to a multiple of the list's length and split, the detections
gathered in order. A list may name one device more than once.

`spawn` starts a function on `world` ranks, passing each its rank, and
returns each rank's result; `dryrun_multichip(n)` runs one training step
on n CPU gloo ranks at `__graft_entry__.py`'s tiny shapes.
"""

from __future__ import annotations

import datetime
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# elements per all_reduce bucket (64 MiB of f32)
BUCKET_ELEMENTS = 1 << 24


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world: int, port: int, backend: str,
                       timeout_s: float = 300.0) -> None:
    """Join the default group of `world` ranks at tcp://localhost:`port`."""
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def world_size(group=None) -> int:
    """Ranks in `group` (the default group when None); 1 without one."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def shard_batch(batch: Sequence[torch.Tensor], rank: int, world: int):
    """This rank's slice of a global batch, split along dim 0 (the
    reference's `shard_batch` places slice `rank` on chip `rank`); raises
    when the batch does not divide."""
    n = batch[0].shape[0]
    if n % world:
        raise ValueError(f"global batch {n} does not divide over {world} "
                         f"devices")
    k = n // world
    return tuple(t[rank * k:(rank + 1) * k] for t in batch)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of tensors of one device and dtype, each of at most
    `BUCKET_ELEMENTS` elements (a larger tensor is a run alone)."""
    run, size = [], 0
    for t in tensors:
        if run and (t.device != run[0].device or t.dtype != run[0].dtype
                    or size + t.numel() > BUCKET_ELEMENTS):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor across the group's ranks, in place, one collective
    per bucket (the reference's `lax.psum`)."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """The mean of each tensor across the group's ranks, in place (the
    reference's `lax.pmean`)."""
    all_reduce_sum_(tensors, group)
    world = world_size(group)
    for t in tensors:
        t.div_(world)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Each tensor set to rank `src`'s, in place."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def serving_devices(num_devices: int, device: str = "cuda") -> List[str]:
    """The device list `--num-devices N` serves on: the first N cards
    (raises when fewer exist), or the CPU N times."""
    kind = torch.device(device).type
    if kind != "cuda":
        return [kind] * num_devices
    have = torch.cuda.device_count()
    if num_devices > have:
        raise ValueError(f"--num-devices {num_devices}: only {have} CUDA "
                         f"devices")
    return [f"cuda:{i}" for i in range(num_devices)]


def shard_detector(detects: Sequence[Callable], devices: Sequence[str]):
    """Wrap one detector per device (`detects[i]` runs on `devices[i]`)
    into detect(images [B, ...]): the batch padded with zeros to a
    multiple of the device count and split, each slice run on its device,
    the outputs concatenated in order on the first device and the padding
    dropped (the reference's inference.py:73-90)."""
    n = len(devices)
    if len(detects) != n:
        raise ValueError(f"{len(detects)} detectors for {n} devices")

    def detect_sharded(images) -> torch.Tensor:
        images = torch.as_tensor(images)
        b = images.shape[0]
        pad = (-b) % n
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad, *images.shape[1:]))])
        k = images.shape[0] // n
        outs = [fn(images[i * k:(i + 1) * k].to(dev))
                for i, (fn, dev) in enumerate(zip(detects, devices))]
        return torch.cat([o.to(devices[0]) for o in outs])[:b]

    return detect_sharded


def _rank_main(rank: int, fn: Callable, world: int, port: int, backend: str,
               args: tuple, results) -> None:
    try:
        init_process_group(rank, world, port, backend)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          timeout_s: Optional[float] = 600.0) -> list:
    """Run fn(rank, world, *args) on `world` fresh processes joined by a
    default group of `backend`, and return each rank's result in rank
    order. `fn` and its arguments and result must pickle. Raises when a
    rank fails, and kills every rank when the whole takes longer than
    `timeout_s` (a hung collective fails rather than waits; None: no
    limit)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, fn, world, port,
                                                  backend, args, results),
                         daemon=False) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(got) < world:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not finish in {timeout_s} s "
                                   f"(done: {sorted(got)})")
            if results.empty():
                if not any(p.is_alive() for p in procs) and results.empty():
                    raise RuntimeError(
                        "ranks exited without a result: codes "
                        f"{[p.exitcode for p in procs]}")
                time.sleep(0.05)
                continue
            r, ok, out = results.get()
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{out}")
            got[r] = out
    finally:
        for p in procs:
            p.join(timeout=5 if len(got) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _dryrun_rank(rank: int, world: int) -> float:
    import numpy as np

    from yolov3_tpu_torch.config import ModelConfig, TrainConfig
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.parallel import train_step as T
    torch.set_num_threads(1)
    img_size, anchors, ncls = (64, 64, 3), ((16, 16), (32, 32)), 2
    cfg = ModelConfig(img_size=img_size, number_classes=ncls,
                      anchors=anchors, block_count=1, filter_count=32,
                      compute_dtype="float32")
    tcfg = TrainConfig(batch_size=1, shard_optimizer=True)
    global_batch = world  # one example per rank
    images = np.random.RandomState(0).randn(
        global_batch, *img_size).astype(np.float32)
    labels = encode_boxes(np.array([[8, 8, 24, 24, 0]]), img_size, anchors,
                          ncls)
    batch = [torch.from_numpy(images)] + [
        torch.from_numpy(np.stack([g] * global_batch)) for g in labels]
    state = T.create_train_state(cfg, tcfg, 0, "cpu")
    step = T.make_train_step(cfg, tcfg, global_batch)
    state, metrics = step(state, shard_batch(batch, rank, world), 1e-4)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"loss {loss}, step {state.step}")
    return loss


def dryrun_multichip(n: int) -> float:
    """One full training step (the train-mode forward, the loss, the
    summed gradients, ZeRO-1 Adam, the averaged BatchNorm statistics) on
    n CPU processes over gloo, at `__graft_entry__.py`'s tiny shapes (64
    px, two classes, one block a stage, 32 filters, one example a rank);
    prints `dryrun_multichip(n): OK, loss=...` and returns the loss."""
    losses = spawn(_dryrun_rank, n, backend="gloo", timeout_s=300.0)
    if len(set(losses)) != 1:
        raise RuntimeError(f"ranks disagree on the loss: {losses}")
    print(f"dryrun_multichip({n}): OK, loss={losses[0]:.4f}", flush=True)
    return losses[0]


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
