"""serve_mfu (%): the forward's conv operations at the configuration's
image size (`work.forward_ops`, heads included, never the route taken),
times the images served in the window, over the window's seconds and
the configuration's peak (`work.PEAK_OPS_S`)."""

import work


def read(run):
    info = run.info
    ops = work.forward_ops(info["model"]) * info["images"]
    return 100.0 * ops / info["window_s"] / work.PEAK_OPS_S[info["peak"]]
