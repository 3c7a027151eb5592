"""recompute_ms_per_step.train: stream milliseconds of the program's
``layer`` spans inside its ``backward`` span (``train/train_step.py``):
the layers the backward recomputes in the device-only traced stretch,
per training step (``bench/spans.py``: the stream's time from a span's
start to its end).

Partly host-paced: the recomputed Mamba layers run ``ssd.scan``'s loop,
whose idle the span holds (697-829 ms over eight seeds on one H100); a
change to the recompute is judged by ``train_tokens_per_s``, not by this
reading alone."""
from perfbench.bench import spans

before_stretch = spans.before_stretch


def read(run):
    ms = spans.device_ms(run, "layer", under="backward")
    return None if ms is None else ms / len(run.traced["units"])
