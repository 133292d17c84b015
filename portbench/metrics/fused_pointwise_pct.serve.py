"""fused_pointwise_pct.serve (%): of the 1x1 stride-1 conv blocks the
program ran in the traced slice's `yolo.serve` calls, the share that took
the fused 1x1 kernel: 100 x its `pointwise.fused` counter over
`pointwise.fused` + `pointwise.plain`, summed over those calls
(`program_spans`). None where the program counts neither."""

import program_spans as P


def read(run):
    line = P.lined(run, P.SERVE)
    tracing = P.recorder()
    if line is None or tracing is None:
        return None
    per_call = tracing.counters(by_call=True)
    fused = plain = 0.0
    for call in line.call_ids("yolo.serve"):
        counts = per_call.get(call, {})
        fused += counts.get("pointwise.fused", 0.0)
        plain += counts.get("pointwise.plain", 0.0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
