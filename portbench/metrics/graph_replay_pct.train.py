"""graph_replay_pct.train (%): of the traced slice's `yolo.step` calls,
the share the program replayed as a CUDA graph: 100 x its `step.replayed`
counter over `step.replayed` + `step.eager`, summed over those calls
(`program_spans`). None where the program counts neither (a commit before
the graph)."""

import program_spans as P


def read(run):
    line = P.lined(run, P.TRAIN)
    tracing = P.recorder()
    if line is None or tracing is None:
        return None
    per_call = tracing.counters(by_call=True)
    replayed = eager = 0.0
    for call in line.call_ids("yolo.step"):
        counts = per_call.get(call, {})
        replayed += counts.get("step.replayed", 0.0)
        eager += counts.get("step.eager", 0.0)
    if replayed + eager == 0:
        return None
    return 100.0 * replayed / (replayed + eager)
