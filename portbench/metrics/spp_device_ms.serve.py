"""spp_device_ms.serve (ms): in the traced slice, the union of the device
intervals of the kernels launched inside the program's `yolo.spp` spans
(YOLOv4's three max pools and their concatenation), per `yolo.serve`
call (`program_spans`)."""

import program_spans as P


def read(run):
    return P.device_ms(run, P.SERVE, "yolo.spp", "yolo.serve")
