"""idle_in_program_pct.train (%): of the traced slice's time in which no
device op ran, the share during which the host was inside the program's
`yolo.step` or `yolo.feed`; the rest is the loop's draws and its reads of
each step's metrics (`program_spans`)."""

import program_spans as P


def read(run):
    return P.idle_in_program_pct(run, P.TRAIN)
