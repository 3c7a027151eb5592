"""device_peak_gb: ``torch.cuda.max_memory_allocated()`` over the window,
counted from a reset at its start, less the bytes the harness holds for
the check alone (made in set-up, held through the window: a fixed number
a cell), in units of 1e9 bytes: the program's own peak."""


def read(run):
    if run.device.type != "cuda" or run.peak_bytes is None:
        return None
    return (run.peak_bytes - run.check_bytes) / 1e9
