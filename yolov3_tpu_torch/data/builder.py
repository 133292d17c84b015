"""Dataset ETL: (images + annotation CSVs) -> train/test YDB record stores
(port of `yolov3_tpu/data/builder.py`).

    python -m yolov3_tpu_torch.data.builder --image_folder I --csv_folder C \
        --output_folder O --dataset_name N [--train_fraction 0.8] \
        [--image_format tif] [--seed 0]

The reference's LMDB builder (reference/build_lmdb.py:115-160): pairs
each `*.csv` with its image, shuffles, splits by `train_fraction`, and
writes `train-<name>.ydb` / `test-<name>.ydb` plus an
`annotation_list.csv` manifest inside each database directory. The
shuffle takes an explicit `random.Random(seed)`, where the JAX builder
calls the global `random.shuffle`; both are Python's Mersenne Twister, so
the same seed gives the same split. Images are read with
`data/imaging.py::imread`, which needs imageio.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Sequence

from yolov3_tpu_torch.data import imaging, records
from yolov3_tpu_torch.data.store import RecordWriter
from yolov3_tpu_torch.ops import boxes as bbox

FLUSH_EVERY = 1000  # durability cadence (reference/build_lmdb.py:101-103)


def generate_database(csv_files: Sequence[str], img_files: Sequence[str],
                      output_folder: str, database_name: str,
                      preserve_dtype: bool = True) -> str:
    """Write one YDB database from parallel lists of csv and image paths."""
    print(f"Generating database {database_name}")
    db_path = os.path.join(output_folder, database_name)

    with RecordWriter(db_path, overwrite=True) as writer:
        for i, (csv_fp, img_fp) in enumerate(zip(csv_files, img_files)):
            img = imaging.imread(img_fp)
            box_arr = bbox.load_boxes_to_xywhc(csv_fp)
            basename = os.path.splitext(os.path.basename(csv_fp))[0]
            key = records.make_record_key(i, basename, box_arr)
            writer.put(key.encode("ascii"),
                       records.encode_record(img, box_arr,
                                             preserve_dtype=preserve_dtype))
            if (i + 1) % FLUSH_EVERY == 0:
                writer.flush()

    with open(os.path.join(db_path, "annotation_list.csv"), "w") as fh:
        for csv_fp in csv_files:
            fh.write(os.path.splitext(os.path.basename(csv_fp))[0] + "\n")
    return db_path


def build_database(image_folder: str, csv_folder: str, output_folder: str,
                   dataset_name: str, train_fraction: float = 0.8,
                   image_format: str = "tif", preserve_dtype: bool = True,
                   rng: random.Random = None) -> None:
    """Shuffle-split annotations into train/test databases; the shuffle
    draws from `rng` (a fresh `random.Random()` when None)."""
    os.makedirs(output_folder, exist_ok=True)
    csv_files: List[str] = [f for f in os.listdir(csv_folder)
                            if f.endswith(".csv")]
    (rng or random.Random()).shuffle(csv_files)

    img_files = [fn.replace(".csv", f".{image_format}") for fn in csv_files]
    csv_files = [os.path.join(csv_folder, fn) for fn in csv_files]
    img_files = [os.path.join(image_folder, fn) for fn in img_files]

    split = int(train_fraction * len(csv_files))
    generate_database(csv_files[:split], img_files[:split], output_folder,
                      f"train-{dataset_name}.ydb", preserve_dtype)
    generate_database(csv_files[split:], img_files[split:], output_folder,
                      f"test-{dataset_name}.ydb", preserve_dtype)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="build_database",
        description="Convert a folder of images and box-annotation csv files "
                    "into a pair of record databases for training.")
    parser.add_argument("--image_folder", type=str, required=True,
                        help="filepath to the folder containing the images")
    parser.add_argument("--csv_folder", type=str, required=True,
                        help="filepath to the folder containing the bounding "
                             "box csv files")
    parser.add_argument("--output_folder", type=str, required=True,
                        help="filepath to the folder where the outputs will "
                             "be placed")
    parser.add_argument("--dataset_name", type=str, required=True,
                        help="name of the dataset to be used in creating the "
                             "database files")
    parser.add_argument("--train_fraction", type=float, default=0.8,
                        help="what fraction of the dataset to use for "
                             "training (0.0, 1.0)")
    parser.add_argument("--image_format", type=str, default="tif",
                        help="format (extension) of the input images. E.g "
                             "{tif, jpg, png}")
    parser.add_argument("--uint8_cast", action="store_true",
                        help="bug-compatible mode: cast all images to uint8 "
                             "like the reference builder "
                             "(reference/build_lmdb.py:48)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the train/test shuffle (default: "
                             "unseeded)")
    args = parser.parse_args(argv)

    build_database(args.image_folder, args.csv_folder, args.output_folder,
                   args.dataset_name, args.train_fraction, args.image_format,
                   preserve_dtype=not args.uint8_cast,
                   rng=random.Random(args.seed))


if __name__ == "__main__":
    main()
