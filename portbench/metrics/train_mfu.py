"""train_mfu (%): three times the forward's conv operations at the
configuration's image size (`work.forward_ops`: forward, and a backward
of twice its work), times the images stepped in the window, over the
window's seconds (feed included) and the bf16 peak."""

import work


def read(run):
    info = run.info
    ops = 3 * work.forward_ops(info["model"]) * info["images"]
    return 100.0 * ops / info["window_s"] / work.PEAK_OPS_S[info["peak"]]
