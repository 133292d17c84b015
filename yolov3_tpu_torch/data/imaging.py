"""Image I/O and normalization helpers (copy of `yolov3_tpu/data/imaging.py`).

`imageio` is imported inside `imread`/`imwrite` only, so the serving path
runs on hosts that have no imageio.
"""

from __future__ import annotations

import numpy as np


def zscore_normalize(image_data: np.ndarray) -> np.ndarray:
    """Per-image z-score; mean-subtract only when std <= 1
    (reference/imagereader.py:34-46)."""
    image_data = image_data.astype(np.float32)
    std = np.std(image_data)
    mean = np.mean(image_data)
    if std <= 1.0:
        return image_data - mean
    return (image_data - mean) / std


def imread(fp: str) -> np.ndarray:
    import imageio.v2 as iio
    return np.asarray(iio.imread(fp))


def imwrite(img: np.ndarray, fp: str) -> None:
    import imageio.v2 as iio
    iio.imwrite(fp, img)


def ensure_hwc(img: np.ndarray) -> np.ndarray:
    """Promote a 2-D grayscale image to HWC with one channel."""
    if img.ndim == 2:
        return img[:, :, None]
    return img
