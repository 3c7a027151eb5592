"""Performance autotuning for the score stage (see perf/tuning.py; the
sweep that fills the table is ``python -m repro_torch.perf.tune``)."""
from repro_torch.perf.tuning import (  # noqa: F401
    DEFAULT_PATH,
    LCSTuning,
    SCHEMA,
    TuningTable,
    cached_table,
    device_kind,
    quantize_pairs,
    resolve_wavefront_dtype,
    tuning_path,
)
