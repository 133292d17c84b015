"""yolov4_serve_mfu (%): YOLOv4's forward conv operations at the
configuration's image size (`work_yolov4.forward_ops`: the layer table's
110 convs, heads included, taps inside the image), times the images
served in the window, over the window's seconds and the bf16 peak
(989 TFLOP/s)."""

import work
import work_yolov4


def read(run):
    info = run.info
    ops = work_yolov4.forward_ops(info["model"]) * info["images"]
    return 100.0 * ops / info["window_s"] / work.PEAK_OPS_S["bfloat16"]
