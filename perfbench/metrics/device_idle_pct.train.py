"""device_idle_pct.train: the share of the traced training step in which
nothing ran on the device, read as ``device_idle_pct.prefill`` reads its
stretch."""
from pathlib import Path

from perfbench.bench import spec

read = spec.load_module(Path(__file__).with_name("device_idle_pct.prefill.py"),
                        "perfbench_metric_device_idle_pct.prefill").read
