"""Training CLI on one card (port of `yolov3_tpu/train.py`,
reference/train.py:28-267).

    python -m yolov3_tpu_torch.train --train_database D --test_database T \
        --output_dir O [--device cpu] ...

Loop semantics are the JAX trainer's (train.py:63-371):
- global batch = per-device batch x devices (one here); readers 3 per
  device (reference/train.py:16,43);
- the test reader has no augmentation and no shuffle; the train reader
  augments, shuffles and balances classes (reference/train.py:46-50);
- an epoch is `test_every_n_steps` train steps; epoch 0 is an Adam
  warm-up of min(warmup_steps, epoch size) steps at lr / 10;
- each epoch runs `size + 1` steps (the reference's break fires at step
  > size, train.py:287-288), kept bug for bug;
- a NaN summed loss aborts, in training and in test (:294-296, :313-314);
- `test_loss.csv` is rewritten each epoch; the checkpoint is saved only
  on a new best test loss (:329-334); training stops when the first
  epoch within 1e-4 of the best lies more than `early_stopping` epochs
  back (:336-348), or at `--max_epochs`;
- `--resume` restores the checkpoint and `test_loss.csv` and goes on
  from the next epoch (:164-175);
- `--profile_dir` writes a `torch.profiler` trace of epoch 1
  (`trace.json`, Chrome format; :285-286, 303-304);
- at the end the best checkpoint is exported to `<output>/saved_model`,
  which `inference.py` serves.

Batches are made by reader worker processes (`data/reader.py`) and staged
onto the card by `utils/prefetch.py`. With `--device_augment 1` the
workers only decode records, and the augmentation, z-score and label
encoding run on the card (`data/device_pipeline.py`), in the prefetch
thread's stream; each batch draws from its own generator, seeded from
(seed + 1, the batch's number in its feed), so a run repeats whatever
the thread's timing. `--shm_feed 1` (with `--device_augment 1` only, as
in the JAX trainer) moves the raw batches through a shared-memory ring.
Runs on "cuda" unless asked for "cpu". The flags of later slices
(`--num_devices` > 1, `--shard_optimizer 1`, `--int8_train 1`,
`--int8_static 1`) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import itertools
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from yolov3_tpu_torch.config import (TRAIN_DEFAULT_ANCHORS, AugmentConfig,
                                     ModelConfig, TrainConfig)
from yolov3_tpu_torch.data.device_pipeline import preprocess_batch
from yolov3_tpu_torch.data.reader import DatasetReader, ShmBatchReader
from yolov3_tpu_torch.parallel.train_step import (create_train_state,
                                                  make_eval_step,
                                                  make_train_step)
from yolov3_tpu_torch.utils import checkpoint as ckpt
from yolov3_tpu_torch.utils.metrics import (MetricSet, SummaryLogger,
                                            write_loss_csv)
from yolov3_tpu_torch.utils.prefetch import DevicePrefetcher


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: a later slice of the port (ROADMAP.md "
        f"Queue A)")


def _check_ported(num_devices, shard_optimizer, model_overrides) -> None:
    if num_devices not in (None, 1):
        raise _not_ported("--num_devices > 1 (multi-device training)")
    if shard_optimizer:
        raise _not_ported("--shard_optimizer")
    overrides = model_overrides or {}
    for name, flag in (("int8_train", "--int8_train"),
                       ("int8_train_static", "--int8_static")):
        if overrides.get(name):
            raise _not_ported(f"{flag} (quantization-aware training)")


def batch_generator(seed: int, counter: int, device) -> torch.Generator:
    """The generator of a feed's `counter`-th batch, on `device`: seeded
    from (seed + 1, counter), as the JAX trainer folds the counter into
    PRNGKey(seed + 1)."""
    gen = torch.Generator(device=device)
    state = np.random.SeedSequence([seed + 1, counter]).generate_state(
        1, np.uint64)[0]
    gen.manual_seed(int(state))
    return gen


def _device_feed(seed: int, device, acfg: AugmentConfig, img_size,
                 anchors, number_classes: int, augment: bool):
    """The prefetcher's transform for raw batches: the device
    preprocessing, one generator per batch."""
    counter = itertools.count(1)

    def transform(raw):
        images, boxes, valid = raw
        gen = batch_generator(seed, next(counter), device) if augment \
            else None
        return preprocess_batch(images, boxes, valid, gen, acfg,
                                tuple(img_size), anchors, number_classes,
                                use_augmentation=augment)
    return transform


def _profiler(device: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def train_model(batch_size: int, test_every_n_steps: int,
                train_database_filepath: str, test_database_filepath: str,
                output_folder: str, early_stopping_count: int,
                learning_rate: float, use_augmentation: bool,
                anchors: Sequence[Tuple[float, float]] = TRAIN_DEFAULT_ANCHORS,
                num_devices: Optional[int] = None,
                seed: int = 0,
                max_epochs: Optional[int] = None,
                compute_dtype: str = "bfloat16",
                profile_dir: Optional[str] = None,
                tcfg: Optional[TrainConfig] = None,
                augment_config: Optional[AugmentConfig] = None,
                model_overrides: Optional[dict] = None,
                device_augment: bool = False,
                shm_feed: bool = False,
                resume: bool = False,
                shard_optimizer: bool = False,
                device: str = "cuda",
                report: Optional[dict] = None) -> Optional[str]:
    """Run the training loop; returns the export path (or None). With
    `report` given, fills it with the train loop's step count, its wall
    seconds, the seconds it waited for batches, the eval steps run and
    the store reader's kind."""
    _check_ported(num_devices, shard_optimizer, model_overrides)
    os.makedirs(output_folder, exist_ok=True)
    global_batch_size = batch_size  # one device
    reader_count = (tcfg or TrainConfig()).reader_count_per_device
    tcfg = tcfg or TrainConfig(batch_size=batch_size,
                               learning_rate=learning_rate,
                               test_every_n_steps=test_every_n_steps,
                               early_stopping_count=early_stopping_count,
                               use_augmentation=bool(use_augmentation))
    print(f"Devices: 1 ({device}), global batch {global_batch_size}, "
          f"readers {reader_count}")
    # the ring carries raw batches, so it needs the device augmentation
    use_shm = bool(device_augment and shm_feed)
    if shm_feed and not device_augment:
        print("--shm_feed takes effect with --device_augment 1 only")
    feed = ("device augmentation, shared-memory ring" if use_shm else
            "device augmentation" if device_augment else "host augmentation")
    print(f"Feed: {feed}")

    def reader(db, **kw):
        if use_shm:
            return ShmBatchReader(db, anchors, batch_size=global_batch_size,
                                  num_workers=reader_count, **kw)
        return DatasetReader(db, anchors, num_workers=reader_count,
                             raw_mode=bool(device_augment), **kw)

    print("Setting up test image reader")
    test_reader = reader(test_database_filepath, use_augmentation=False,
                         shuffle=False)
    print(f"Test Reader has {test_reader.get_image_count()} images "
          f"({test_reader.store_kind} store reader)")
    print("Setting up training image reader")
    try:
        train_reader = reader(train_database_filepath,
                              use_augmentation=bool(use_augmentation),
                              shuffle=True, balance_classes=True,
                              augment_config=augment_config)
    except BaseException:
        test_reader.shutdown()  # unlinks the test reader's ring, if any
        raise
    print(f"Train Reader has {train_reader.get_image_count()} images "
          f"({train_reader.store_kind} store reader)")

    report = {} if report is None else report
    report.update(train_steps=0, train_s=0.0, feed_wait_s=0.0, eval_steps=0,
                  store_kind=train_reader.store_kind, feed=feed)
    export_path = None
    best_checkpoint_saved = False
    train_batches = test_batches = None
    try:
        print("Starting Readers")
        train_reader.startup()
        test_reader.startup()

        number_classes = train_reader.get_number_classes()
        img_size = train_reader.get_image_size()
        cfg = ModelConfig(img_size=tuple(img_size),
                          number_classes=number_classes,
                          anchors=tuple(tuple(a) for a in anchors),
                          compute_dtype=compute_dtype,
                          **(model_overrides or {}))
        print(f"Creating model: img_size={img_size} classes={number_classes} "
              f"anchors={list(cfg.anchors)}")
        state = create_train_state(cfg, tcfg, seed, device)

        # resume (the reference always restarts from scratch): the best
        # checkpoint and the test-loss history
        test_loss = []
        if resume and ckpt.has_checkpoint(output_folder):
            print("Resuming from checkpoint")
            state = ckpt.restore_checkpoint(output_folder, state)
            best_checkpoint_saved = True
            loss_csv = os.path.join(output_folder, "test_loss.csv")
            if os.path.exists(loss_csv):
                with open(loss_csv) as fh:
                    test_loss = [float(line) for line in fh if line.strip()]
            print(f"Resumed at step {state.step}, {len(test_loss)} "
                  f"completed epochs")

        train_step = make_train_step(cfg, tcfg, global_batch_size)
        eval_step = make_eval_step(cfg, tcfg, global_batch_size)
        train_transform = test_transform = None
        if device_augment:
            feed_args = (seed, device, augment_config or AugmentConfig(),
                         img_size, cfg.anchors, number_classes)
            train_transform = _device_feed(*feed_args, bool(use_augmentation))
            test_transform = _device_feed(*feed_args, False)
        train_batches = DevicePrefetcher(
            train_reader.batches(global_batch_size), device,
            transform=train_transform)
        test_batches = DevicePrefetcher(
            test_reader.batches(global_batch_size), device,
            transform=test_transform)

        train_epoch_size = test_every_n_steps
        test_epoch_size = test_reader.get_image_count() / batch_size

        train_metrics = MetricSet("train")
        test_metrics = MetricSet("test")
        stamp = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
        tb_root = os.path.join(output_folder, f"tensorboard-{stamp}")
        train_logger = SummaryLogger(os.path.join(tb_root, "train"))
        test_logger = SummaryLogger(os.path.join(tb_root, "test"))

        epoch = len(test_loss)  # > 0 when resuming
        print("Running Network")
        while True:
            print(f"---- Epoch: {epoch} ----")
            if epoch == 0:
                cur_train_epoch_size = min(tcfg.warmup_steps, train_epoch_size)
                print(f"Performing Adam Optimizer learning rate warmup for "
                      f"{cur_train_epoch_size} steps")
                lr = learning_rate / tcfg.warmup_lr_divisor
            else:
                cur_train_epoch_size = train_epoch_size
                lr = learning_rate

            start_time = time.time()
            profiling = bool(profile_dir) and epoch == 1
            wait0 = train_batches.wait_s
            with (_profiler(device) if profiling
                  else contextlib.nullcontext()) as prof:
                # the reference's `if step > size: break` runs size+1 steps
                for step in range(cur_train_epoch_size + 1):
                    state, metrics = train_step(state, next(train_batches),
                                                lr)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if np.isnan(metrics.pop("loss_sum")):
                        raise RuntimeError(
                            "Training Loss went to NaN, try a lower "
                            "learning rate")
                    train_metrics.update(metrics)
                    global_step = int(epoch * train_epoch_size + step)
                    print(f"Train Epoch {epoch}: Batch {step}/"
                          f"{train_epoch_size}: Loss "
                          f"{train_metrics.metrics['loss'].result()}")
                    train_logger.scalars(train_metrics.results(), global_step)
                    train_metrics.reset()
            report["train_steps"] += cur_train_epoch_size + 1
            report["train_s"] += time.time() - start_time
            report["feed_wait_s"] += train_batches.wait_s - wait0
            if profiling:
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      "trace.json"))

            epoch_test_loss = []
            for step in range(int(test_epoch_size) + 1):
                metrics = {k: float(v) for k, v
                           in eval_step(state, next(test_batches)).items()}
                # test_loss.csv and early stopping track the summed loss
                # (reference/train.py:150-155)
                loss_sum = metrics.pop("loss_sum")
                if np.isnan(loss_sum):
                    raise RuntimeError("Test Loss went to NaN")
                epoch_test_loss.append(loss_sum)
                test_metrics.update(metrics)
            report["eval_steps"] += int(test_epoch_size) + 1
            test_loss.append(float(np.mean(epoch_test_loss)))

            print(f"Test Epoch: {epoch}: Loss = "
                  f"{test_metrics.metrics['loss'].result()}")
            test_logger.scalars(test_metrics.results(),
                                int((epoch + 1) * train_epoch_size))
            test_metrics.reset()
            write_loss_csv(os.path.join(output_folder, "test_loss.csv"),
                           test_loss)
            print(f"Epoch took: {time.time() - start_time} s")

            # best-only checkpoint (reference/train.py:178-182)
            if (len(test_loss) - 1) == int(np.argmin(test_loss)):
                print(f"Test loss improved: {np.min(test_loss)}, "
                      f"saving checkpoint")
                ckpt.save_checkpoint(output_folder, state)
                best_checkpoint_saved = True

            # early stopping (reference/train.py:185-197)
            print("Best Current Epoch Selection:")
            print("Test Loss:")
            print(test_loss)
            error_from_best = np.abs(np.asarray(test_loss) - np.min(test_loss))
            error_from_best[error_from_best < tcfg.convergence_tolerance] = 0
            best_epoch = int(np.where(error_from_best == 0)[0][0])
            print(f"Best epoch: {best_epoch}")
            if len(test_loss) - best_epoch > early_stopping_count:
                break
            epoch += 1
            if max_epochs is not None and epoch >= max_epochs:
                break

        train_logger.close()
        test_logger.close()
    finally:
        for it in (train_batches, test_batches):
            if it is not None:
                it.stop()
        print("Shutting down train_reader")
        train_reader.shutdown()
        print("Shutting down test_reader")
        test_reader.shutdown()

    if best_checkpoint_saved:
        print("Converting best checkpoint into inference artifact")
        params, batch_stats = ckpt.checkpoint_params(output_folder)
        export_path = ckpt.export_model(output_folder, params, batch_stats,
                                        cfg)
        print(f"Exported: {export_path}")
    return export_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="train_yolo", description="Train a YOLOv3 model on one card")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="per-device training batch size")
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--test_every_n_steps", type=int, default=1000,
                        help="number of gradient update steps between test runs")
    parser.add_argument("--train_database", dest="train_database_filepath",
                        type=str, required=True,
                        help="database to use for training (Required)")
    parser.add_argument("--test_database", dest="test_database_filepath",
                        type=str, required=True,
                        help="database to use for testing (Required)")
    parser.add_argument("--output_dir", dest="output_folder", type=str,
                        required=True,
                        help="Folder where outputs will be saved (Required)")
    parser.add_argument("--early_stopping", type=int, default=10,
                        help="stop when test loss has not improved for N epochs")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="hard cap on training epochs")
    parser.add_argument("--use_augmentation", type=int, default=1,
                        help="whether to use data augmentation [0=false, 1=true]")
    parser.add_argument("--anchors", type=str,
                        default=",".join(f"{w}x{h}" for w, h in
                                         TRAIN_DEFAULT_ANCHORS),
                        help="comma-separated WxH anchor list")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="devices to train on (only 1 is ported)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=("bfloat16", "float32"))
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of epoch 1 here")
    parser.add_argument("--device_augment", type=int, default=0,
                        help="augment, z-score and encode labels on the "
                             "device; reader workers only decode")
    parser.add_argument("--shm_feed", type=int, default=0,
                        help="with --device_augment 1: move raw batches "
                             "through a shared-memory ring")
    parser.add_argument("--resume", action="store_true",
                        help="resume from an existing checkpoint in "
                             "--output_dir")
    parser.add_argument("--shard_optimizer", type=int, default=0,
                        help="ZeRO-1 optimizer sharding (not ported yet)")
    parser.add_argument("--int8_train", type=int, default=0,
                        help="quantization-aware training (not ported yet)")
    parser.add_argument("--int8_static", type=int, default=0,
                        help="static-scale QAT (not ported yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    anchors = tuple(tuple(float(v) for v in a.split("x"))
                    for a in args.anchors.split(","))

    print("Arguments:")
    for k, v in sorted(vars(args).items()):
        print(f"{k} = {v}")

    train_model(args.batch_size, args.test_every_n_steps,
                args.train_database_filepath, args.test_database_filepath,
                args.output_folder, args.early_stopping, args.learning_rate,
                bool(args.use_augmentation), anchors=anchors,
                num_devices=args.num_devices,
                compute_dtype=args.compute_dtype,
                profile_dir=args.profile_dir,
                device_augment=bool(args.device_augment),
                shm_feed=bool(args.shm_feed),
                resume=args.resume,
                shard_optimizer=bool(args.shard_optimizer),
                max_epochs=args.max_epochs,
                model_overrides=dict(
                    **({"int8_train": True} if args.int8_train else {}),
                    **({"int8_train_static": True} if args.int8_static
                       else {})) or None,
                device=args.device)


if __name__ == "__main__":
    main()
