"""peak_mem_gib.train (GiB): `torch.cuda.max_memory_allocated()` over the
measured window, after `reset_peak_memory_stats` at its start."""


def read(run):
    return run.info["peak_window_bytes"] / 2 ** 30
