"""idle_in_program_pct.serve (%): of the traced slice's time in which no
device op ran, the share during which the host was inside the program's
`yolo.serve`; the rest is the caller's (copies, the next call's start)
(`program_spans`)."""

import program_spans as P


def read(run):
    return P.idle_in_program_pct(run, P.SERVE)
