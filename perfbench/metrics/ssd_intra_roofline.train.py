"""ssd_intra_roofline.train: the least time the Mamba-2 intra-chunk steps
of the traced training step need, one forward a layer a microbatch
(``yardstick.ssd_intra_call_work``), over the device time of the kernels
named ``ssd_intra`` (both of the port's routes), in percent.  The
backward is torch ops and is not counted; the recompute's forward is
time but not work."""
from perfbench.bench import yardstick

PATTERNS = ("ssd_intra",)


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    kernel_s = run.trace.seconds_matching(PATTERNS)
    if kernel_s <= 0:
        return None
    accum = run.cell.traffic["grad_accum"]
    calls = accum * yardstick.mamba_layers(run.model)
    least = sum(calls * yardstick.least_seconds(*yardstick.ssd_intra_call_work(run.model, b // accum, s))
                for b, s in run.traced["units"])
    return 100.0 * least / kernel_s
