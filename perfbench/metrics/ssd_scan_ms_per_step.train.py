"""ssd_scan_ms_per_step.train: stream milliseconds of the program's
``ssd.scan`` spans (``kernels/ssd/ops.py::ssd_scan``: the chunk
recurrence and the inter-chunk output, in the forward and in the
recompute) in the device-only traced stretch, per training step
(``bench/spans.py``: the stream's time from a span's start to its end).

Host-paced: the loop's small ops leave the device idle inside the span
while the host issues them, so the reading follows the host's speed more
than the kernels' (188-478 ms over eight seeds on one H100); a change to
the scan is judged by ``train_tokens_per_s``, not by this reading alone."""
from perfbench.bench import spans

before_stretch = spans.before_stretch


def read(run):
    ms = spans.device_ms(run, "ssd.scan")
    return None if ms is None else ms / len(run.traced["units"])
