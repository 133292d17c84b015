"""optimizer_host_ms.train (ms): the host time inside the program's
`yolo.step.optimizer` spans, per `yolo.step`, in the traced slice, which
the profiler slows: compare it between commits, not with untraced times
(`program_spans`)."""

import program_spans as P


def read(run):
    return P.host_ms(run, P.TRAIN, "yolo.step.optimizer", "yolo.step")
