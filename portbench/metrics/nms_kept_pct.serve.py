"""nms_kept_pct.serve (%): 100 x the program's `nms.kept` counter over its
`nms.candidates` (candidates at or above the score threshold after the
small-box filter), exact counts over the traced slice's calls, each
distinct call once (`program_spans.kept_pct`)."""

import program_spans as P


def read(run):
    return P.kept_pct(run)
