"""On-device image preprocessing (port of `yolov3_tpu/data/device_pipeline.py`).

Only the serving path's `zscore_images` is ported so far.
"""

from __future__ import annotations

import torch


def zscore_images(images: torch.Tensor) -> torch.Tensor:
    """Per-image z-score of an NHWC batch, in float32, on the batch's device.

    Population std over each whole image; an image with std <= 1 is only
    mean-subtracted (reference/imagereader.py:34-46). Accepts raw integer
    pixels and converts them on the device.
    """
    x = images.to(torch.float32)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True))
    return torch.where(std <= 1.0, x - mean, (x - mean) / std)
