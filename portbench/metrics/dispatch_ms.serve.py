"""dispatch_ms.serve (ms): the median host time of the window's calls from
entering the serving function to its return, before the outputs are
copied back (the host's share of a call that the device may hide)."""

import numpy as np


def read(run):
    return float(np.median(run.info["dispatch_s"])) * 1e3
