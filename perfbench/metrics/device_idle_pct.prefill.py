"""device_idle_pct.prefill: the share of the traced stretch in which
nothing ran on the device, 100 x (1 - the union of the device's kernel,
copy and fill intervals / the stretch), in percent."""


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
