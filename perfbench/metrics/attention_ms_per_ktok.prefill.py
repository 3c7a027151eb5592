"""attention_ms_per_ktok.prefill: device milliseconds of the program's
``attention`` spans (``models/attention.py``: the projections, RoPE and
#6) in the device-only traced stretch, per thousand prompt tokens
(``bench/spans.py``: the stream's time from a span's start to its end)."""
from perfbench.bench import spans

before_stretch = spans.before_stretch


def read(run):
    ms = spans.device_ms(run, "attention")
    return None if ms is None else ms / (run.traced["tokens"] / 1e3)
