"""elementwise_ms_per_ktok.prefill: device milliseconds of the kernels
that are neither matmuls nor attention nor the SSD's kernel
(``yardstick.kernel_kind``: copies and casts, reductions, elementwise and
the rest) in the traced stretch, per thousand prompt tokens."""
from perfbench.bench import yardstick


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    sec = sum(s for name, s in run.trace.seconds_by_name().items()
              if yardstick.kernel_kind(name) in yardstick.ELEMENTWISE_KINDS)
    return 1e3 * sec / (run.traced["tokens"] / 1e3)
