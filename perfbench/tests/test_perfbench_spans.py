"""The nine readers of the program's spans on a made-up run: totals of
``repro_torch.core.trace`` made up before and after the stretch, read
through ``bench/spans.py`` as a CUDA run would read them."""
import json

import pytest
import torch
from conftest import REPO

from perfbench.bench import spans, spec
from perfbench.bench.runner import Run
from perfbench.bench.trace import Trace

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]


def entry(calls, device_ms):
    return {"calls": calls, "device_ms": device_ms, "self_device_ms": device_ms, "host_ms": device_ms}


# totals before the stretch: whatever ran earlier (set-up, the window, the
# host-traced stretch) is left out by the delta
BEFORE = {
    "layer": entry(400, 9000.0),
    "layer/rmsnorm": entry(400, 800.0),
    "forward/layer": entry(540, 20000.0),
    "backward/layer": entry(540, 21000.0),
    "adamw_update": entry(5, 900.0),
}
# spans that closed in the stretch: a prefill cycle's and a training step's
STRETCH = {
    "layer": entry(40, 1000.0),
    "layer/rmsnorm": entry(80, 60.0),
    "layer/attention": entry(40, 300.0),
    "layer/attention/rope": entry(80, 40.0),
    "layer/ffn": entry(40, 500.0),
    "layer/ffn/rmsnorm": entry(40, 30.0),
    "rmsnorm": entry(1, 1.0),
    "forward": entry(2, 1500.0),
    "forward/layer": entry(108, 1400.0),
    "forward/layer/ssd.scan": entry(108, 100.0),
    "backward": entry(2, 3500.0),
    "backward/layer": entry(108, 1200.0),
    "backward/layer/ssd.scan": entry(108, 110.0),
    "backward/flash_attention.bwd": entry(18, 900.0),
    "backward/ssd_intra.bwd": entry(108, 850.0),
    "grad_accumulate": entry(3, 80.0),
    "adamw_update": entry(1, 200.0),
}
TOKENS, STEPS = 73_728, 1
EXPECTED = {
    "norm_ms_per_ktok.prefill": (60.0 + 30.0 + 1.0) / (TOKENS / 1e3),
    "rope_ms_per_ktok.prefill": 40.0 / (TOKENS / 1e3),
    "attention_ms_per_ktok.prefill": 300.0 / (TOKENS / 1e3),
    "ffn_ms_per_ktok.prefill": 500.0 / (TOKENS / 1e3),
    "attn_bwd_ms_per_step.train": 900.0 / STEPS,
    "ssd_bwd_ms_per_step.train": 850.0 / STEPS,
    "ssd_scan_ms_per_step.train": (100.0 + 110.0) / STEPS,
    "recompute_ms_per_step.train": 1200.0 / STEPS,
    "optimizer_ms_per_step.train": 200.0 / STEPS,
}


class FakeTracer:
    """``trace.totals()`` as the program gives it: BEFORE, then BEFORE
    plus STRETCH."""

    def __init__(self, stretch=STRETCH):
        self.reads = [BEFORE, add(BEFORE, stretch)]

    def totals(self):
        return self.reads.pop(0) if len(self.reads) > 1 else self.reads[0]


def add(a, b):
    out = {p: dict(t) for p, t in a.items()}
    for p, t in b.items():
        out[p] = {k: out.get(p, {}).get(k, 0) + v for k, v in t.items()}
    return out


def make_run(name, device="cuda"):
    cell = spec.load_cell("granite-prefill-2k" if name.endswith(".prefill") else "zamba2-train-4k", REPO)
    run = Run(cell=cell, seed=1, device=torch.device(device))
    run.trace = Trace(window=None, device=[(0.0, 1.0, "k")], spans=[], ops=[], wall_s=1.0)
    run.traced = {"tokens": TOKENS, "units": [(8, 2048)] * 4} if name.endswith(".prefill") else \
        {"tokens": 16_384 * STEPS, "units": [(4, 4096)] * STEPS}
    return run


def read(name, run, tracer, monkeypatch):
    monkeypatch.setattr(spans, "_tracer", lambda: tracer)
    reader = spec.metric_reader(REPO, name)
    reader.before_stretch(run)
    return reader.read(run)


def test_the_nine_metrics_are_the_benchmarks():
    assert sorted(SPAN_METRICS) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_its_spans_over_the_stretch(name, monkeypatch):
    got = read(name, make_run(name), FakeTracer(), monkeypatch)
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_off_cuda_or_without_the_tracer(name, monkeypatch):
    assert read(name, make_run(name, device="cpu"), FakeTracer(), monkeypatch) is None
    # a checkout whose program has no tracer
    assert read(name, make_run(name), None, monkeypatch) is None
    # no span of the name closed in the stretch
    assert read(name, make_run(name), FakeTracer(stretch={}), monkeypatch) is None


def test_matches_counts_nested_spans_of_one_name_once():
    assert spans.matches("backward/layer", "layer", under="backward")
    assert not spans.matches("forward/layer", "layer", under="backward")
    assert not spans.matches("layer/layer", "layer")
    assert spans.matches("layer/attention/rope", "rope")
    assert not spans.matches("layer/attention", "rope")
