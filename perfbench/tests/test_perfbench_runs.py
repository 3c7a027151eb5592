"""Whole runs of tiny cells on the CPU: the harness drives the port's
serve and train steps and the plain reference, with the look for a card
skipped (the runner is called with ``device="cpu"``)."""
import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import REPO, TINY_CELLS

from perfbench.bench import runner, spec

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(root, cell, seed=20_000_000_017, trace=False, seconds=0.3):
    return runner.run_cell(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                           root=root, log=lambda m: None)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_port_agrees_with_the_reference(tiny_root, cell):
    """The port on the CPU (bf16 activations, the kernels' plain versions)
    within the committed limits of the reference, on every number."""
    res = run(tiny_root, cell)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contracts_keys(tiny_root, trace):
    res = run(tiny_root, "tiny-dense-prefill", trace=trace)
    assert list(res) == RESULT_KEYS
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    # off the card only set-up is a number: nothing of the CPU run is
    # written under a device metric's name
    assert set(res["metrics"]) <= {"setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_cell_config_traffic_and_metrics_added_as_files_are_found(tiny_root, tmp_path):
    """A new configuration, traffic mix, cell and two per-layer metrics
    (one reading a span of the trace, one a program counter) added as new
    files and entries, no file that is there edited."""
    import shutil

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root, symlinks=True)
    pb = root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    cfg = json.loads((pb / "configs" / "tiny-dense.json").read_text())
    cfg["model"].update(name="tiny-dense-wide", d_ff=192)
    (pb / "configs" / "tiny-dense-wide.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny-prefill-short.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 2, "lengths": [16, 32], "max_len": 32}))
    (pb / "cells" / "wide-short.json").write_text((pb / "cells" / "tiny-dense-prefill.json").read_text())
    (pb / "metrics" / "prefill_span_s.wide.py").write_text(
        "def read(run):\n"
        "    return None if run.host_trace is None else run.host_trace.span_seconds('prefill')\n")
    (pb / "metrics" / "prefill_calls.wide.py").write_text(
        "from repro_torch.serve import serve_step\n"
        "def before_stretch(run):\n"
        "    run.calls_before = serve_step.prefill_calls\n"
        "def read(run):\n"
        "    return serve_step.prefill_calls - run.calls_before\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense-wide", "source": cfg["source"],
                             "file": "perfbench/configs/tiny-dense-wide.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "wide-short", "config": "tiny-dense-wide",
                               "traffic": "tiny-prefill-short", "chips": 1, "why": "t"})
    for name, src in (("prefill_span_s.wide", "program_span"), ("prefill_calls.wide", "program_counter")):
        bench["per_layer"].append({"name": name, "unit": "s", "better": "lower", "source": src,
                                   "layer": "Serve step", "moves": "prefill_tokens_per_s",
                                   "workloads": ["wide-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from repro_torch.serve import serve_step

    real = serve_step.prefill_with_cache
    serve_step.prefill_calls = 0

    def counted(*a, **k):   # a counter the program would add
        serve_step.prefill_calls += 1
        return real(*a, **k)

    serve_step.prefill_with_cache = counted
    try:
        cell = spec.load_cell("wide-short", root)
        assert cell.config["model"]["d_ff"] == 192 and cell.traffic["lengths"] == [16, 32]
        assert [m["name"] for m in cell.per_layer] == ["prefill_span_s.wide", "prefill_calls.wide"]
        res = run(root, "wide-short", trace=True)
    finally:
        serve_step.prefill_with_cache = real
        del serve_step.prefill_calls
    assert res["correct"], res["checks"]
    assert res["metrics"]["prefill_calls.wide"]["value"] == 2   # one cycle of two lengths
    assert res["metrics"]["prefill_span_s.wide"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", ["tiny-dense-prefill", "tiny-hybrid-train"])
def test_check_bytes_are_the_buffers_the_check_holds(tiny_root, cell):
    """``device_peak_gb`` leaves out what the harness holds through the
    window for the check alone: set-up counts exactly those bytes."""
    c = spec.load_cell(cell, tiny_root)
    r = runner.Run(cell=c, seed=5, device=torch.device("cpu"), log=lambda m: None,
                   reference=spec.reference(tiny_root, c.config["reference"]))
    drv = spec.driver(tiny_root, c.kind).Driver(r)
    drv.setup()
    if c.kind == "prefill":
        held = [drv.kept_logits, drv.kept_tokens] + [t for b in drv.kept_buffers for t in b.values()]
    else:
        held = [t for b in drv.batches for t in b.values()]
    assert r.check_bytes == sum(t.numel() * t.element_size() for t in held) > 0


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "granite-prefill-2k",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    the run cannot import the program and prints no result."""
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path[:0] = [sys.argv[1]]\n"
            "sys.modules['repro_torch'] = None\n"
            "from perfbench.bench import runner\n"
            "print(runner.run_cell('granite-prefill-2k', 1, 1.0, False, t_start=time.perf_counter(),"
            " device='cpu', root=sys.argv[1]))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "repro_torch" in proc.stderr


def test_no_forbidden_module_on_the_run_path(tiny_root):
    """A whole run in a fresh process loads neither JAX nor the JAX
    package (top-level names compared whole), and the reference alone
    loads nothing of the program."""
    code = ("import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "from perfbench.bench import runner, spec\n"
            "ref = spec.reference(sys.argv[1], 'lm')\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "assert not tops & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}, tops\n"
            "r = runner.run_cell('tiny-hybrid-train', 3, 0.1, True, t_start=time.perf_counter(),"
            " device='cpu', root=sys.argv[1], log=lambda m: None)\n"
            "assert 'repro_torch' in {m.split('.')[0] for m in sys.modules}\n"
            "print(runner.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tiny_root)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
