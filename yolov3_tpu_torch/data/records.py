"""Record (de)serialization between numpy arrays and `ImageYoloBoxesPair`
(copy of `yolov3_tpu/data/records.py`, over the port's own wire codec
`data/isg_ai.py`).

The record KEY embeds the class ids present in the image as
``"{n}_{basename}:{c1,c2,...}"``; the reader's class balancing parses it
(reference/build_lmdb.py:91-96, reference/imagereader.py:115,133).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from yolov3_tpu_torch.data.isg_ai import ImageYoloBoxesPair


def encode_record(img: np.ndarray, boxes: np.ndarray,
                  preserve_dtype: bool = True) -> bytes:
    """Serialize (image HW or HWC, boxes [N,5] int rows of [x, y, w, h,
    class-id]) to the record's bytes. The image keeps its dtype unless
    `preserve_dtype` is False (the reference's uint8 cast,
    reference/build_lmdb.py:48)."""
    img = np.asarray(img)
    if not preserve_dtype:
        img = np.asarray(img, dtype=np.uint8)
    boxes = np.asarray(boxes, dtype=np.int32)

    rec = ImageYoloBoxesPair()
    if img.ndim == 2:
        rec.channels = 1
    elif img.ndim == 3:
        rec.channels = img.shape[2]
    else:
        raise ValueError(f"Invalid image dimensions: {img.shape}")
    rec.img_height = img.shape[0]
    rec.img_width = img.shape[1]
    rec.image = img.tobytes()
    rec.box_count = boxes.shape[0]
    if boxes.shape[0] > 0:
        rec.boxes = boxes.tobytes()
    rec.img_type = img.dtype.str
    rec.box_type = boxes.dtype.str
    return rec.SerializeToString()


def decode_record(blob: bytes,
                  rec: Optional[ImageYoloBoxesPair] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Record bytes -> (image HWC, boxes [N,5] int32); no boxes give an
    empty [0,5] array (reference/imagereader.py:348-365)."""
    if rec is None:
        rec = ImageYoloBoxesPair()
    rec.ParseFromString(blob)
    img = np.frombuffer(rec.image, dtype=np.dtype(rec.img_type))
    img = img.reshape((rec.img_height, rec.img_width, rec.channels))
    if rec.box_count > 0:
        boxes = np.frombuffer(rec.boxes, dtype=np.dtype(rec.box_type))
        boxes = boxes.reshape(rec.box_count, 5).astype(np.int32)
    else:
        boxes = np.zeros((0, 5), dtype=np.int32)
    return img, boxes


def make_record_key(index: int, basename: str, boxes: np.ndarray) -> str:
    """Build the ``"{n}_{basename}:{classes}"`` key
    (reference/build_lmdb.py:91-96)."""
    present = np.unique(np.asarray(boxes).reshape(-1, 5)[:, 4]).astype(np.int32)
    class_str = ",".join(str(int(c)) for c in present)
    return f"{index}_{basename}:{class_str}"


def parse_key_classes(key: bytes) -> List[str]:
    """The class-id suffix of a record key as strings; an image with no
    boxes gives [''], the reader's "empty image" pseudo-class
    (reference/imagereader.py:115-121)."""
    return key.decode("ascii").split(":")[1].split(",")
