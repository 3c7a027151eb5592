"""optimizer_ms_per_step.train: device milliseconds of the program's
``adamw_update`` spans (``train/optimizer.py``) in the device-only
traced stretch, per training step (``bench/spans.py``: the stream's time
from a span's start to its end)."""
from perfbench.bench import spans

before_stretch = spans.before_stretch


def read(run):
    ms = spans.device_ms(run, "adamw_update")
    return None if ms is None else ms / len(run.traced["units"])
