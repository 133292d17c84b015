"""optimizer_device_ms.train (ms): in the traced slice, the union of the
device intervals of the kernels launched inside the program's
`yolo.step.optimizer` spans, per `yolo.step` (`program_spans`)."""

import program_spans as P


def read(run):
    return P.device_ms(run, P.TRAIN, "yolo.step.optimizer", "yolo.step")
