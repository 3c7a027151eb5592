"""One run of one cell: set up, measure for ``seconds``, optionally trace
a further stretch, check the outputs against the reference, and build
the result line.

A run is driven by the cell's files (``bench/spec.py``): the traffic's
``kind`` names the driver (``perfbench/drivers/<kind>.py``), the
configuration names its reference (``perfbench/reference/<name>.py``),
and every metric the cell reports is read by ``perfbench/metrics/
<name>.py``.  The driver's class ``Driver(run)`` has:

- ``setup()``: make the weights and inputs from the seed, build the
  program's objects, warm every shape the traffic uses;
- ``window(seconds) -> dict``: the measured loop, closing at the first
  completion at or after ``seconds``: ``{"seconds", "tokens", "units":
  [(batch, seq_len), ...], "attempted", "failed"}``;
- ``stretch() -> dict``: a part run under the profiler (``--trace 1``),
  in the same form: once with the host's and the device's activity
  traced, whose idle gaps the ``breakdown`` labels, then once with the
  device's alone, which the per-layer metrics read;
- ``release()``: free the program's state;
- ``check() -> dict``: the compared numbers, by name, each against the
  cell's limit of that name.

A metric reader's ``read(run)`` sees this module's :class:`Run`: the
cell, the window's and the traced stretch's units and seconds, the
window's memory peak and the check's share of it, and the parsed traces (``bench/trace.py``): the
device's activity over the last stretch (``run.trace``) and the host's
and the device's over the stretch before it (``run.host_trace``, where
the program's spans are).  A reader's optional ``before_stretch(run)``
runs before the last stretch, to take a program counter's value.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from perfbench.bench import spec
from perfbench.bench.trace import Trace, top, traced

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a run hands its driver and its metric readers."""
    cell: spec.Cell
    seed: int
    device: torch.device
    reference: object = None
    log: object = _stderr
    setup_s: float | None = None
    peak_bytes: int | None = None
    # bytes the driver holds through the window for the check alone (the
    # checked rows' buffers, made in set-up): in the peak, not the program's
    check_bytes: int = 0
    window: dict | None = None
    traced: dict | None = None
    trace: Trace | None = None
    host_trace: Trace | None = None

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def _metrics(run: Run, entries: list, readers: list) -> dict:
    out = {}
    for m, reader in zip(entries, readers):
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _device(run: Run) -> dict:
    if run.device.type != "cuda":
        return {"platform": run.device.type, "kind": "cpu", "count": run.cell.chips,
                "memory_peak_bytes": run.peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", root=spec.ROOT, log=_stderr) -> dict:
    """One run; returns the result object (the last line's JSON)."""
    cell = spec.load_cell(cell_name, root)
    dev = torch.device(device)
    run = Run(cell=cell, seed=seed, device=dev, log=log,
              reference=spec.reference(root, cell.config["reference"]))
    drv = spec.driver(root, cell.kind).Driver(run)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)   # the CUDA context
    log(f"process start to the CUDA context: {time.perf_counter() - t_start:.3f} s")
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_start
    entries = cell.per_layer if trace else cell.end_to_end
    readers = [spec.metric_reader(root, m["name"]) for m in entries]
    run.window = drv.window(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    log(f"window: {run.window['seconds']:.3f} s, {run.window['tokens']} tokens, "
        f"{len(run.window['units'])} units; set-up {run.setup_s:.3f} s; peak {run.peak_bytes}, "
        f"the check's {run.check_bytes}")
    result = {"correct": False, "attempted": run.window["attempted"], "failed": run.window["failed"]}
    if trace:
        t0 = time.perf_counter()
        run.host_trace = traced(drv.stretch, dev, host=True)
        for reader in readers:
            if hasattr(reader, "before_stretch"):
                reader.before_stretch(run)
        box = {}
        run.trace = traced(lambda: box.update(drv.stretch()), dev, host=False)
        run.traced = box
        log(f"traced stretches: {time.perf_counter() - t0:.3f} s")
    result["metrics"] = _metrics(run, entries, readers)
    drv.release()
    t0 = time.perf_counter()
    numbers = drv.check()
    log(f"check: {time.perf_counter() - t0:.3f} s")
    limits = cell.own["limits"]
    # a number the check could not work out reads None, and fails
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    result["correct"] = run.window["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["device"] = _device(run)
    if trace and dev.type == "cuda":
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": top(run.trace.seconds_by_name()),
                               "idle_gaps": top(run.host_trace.idle_by_label())}
    result["checks"] = checks
    return result
