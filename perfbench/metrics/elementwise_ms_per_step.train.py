"""elementwise_ms_per_step.train: device milliseconds of the kernels that
are neither matmuls nor attention nor the SSD's kernel
(``yardstick.kernel_kind``: copies and casts, reductions, elementwise and
the rest, the torch-ops backwards' among them) in the traced stretch, per
training step."""
from perfbench.bench import yardstick


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    sec = sum(s for name, s in run.trace.seconds_by_name().items()
              if yardstick.kernel_kind(name) in yardstick.ELEMENTWISE_KINDS)
    return 1e3 * sec / len(run.traced["units"])
