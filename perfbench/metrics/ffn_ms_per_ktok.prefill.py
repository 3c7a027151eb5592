"""ffn_ms_per_ktok.prefill: device milliseconds of the program's ``ffn``
spans (``models/model.py::ffn_block``: ``ln2`` and the SwiGLU MLP) in
the device-only traced stretch, per thousand prompt tokens
(``bench/spans.py``: the stream's time from a span's start to its end)."""
from perfbench.bench import spans

before_stretch = spans.before_stretch


def read(run):
    ms = spans.device_ms(run, "ffn")
    return None if ms is None else ms / (run.traced["tokens"] / 1e3)
