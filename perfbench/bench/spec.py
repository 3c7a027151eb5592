"""The benchmark's data, found by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found from the names in it, so a cell, a configuration, a traffic mix or a
metric is added by adding files and entries, and no file that is there is
edited:

- the configuration: ``configs[].file`` (JSON: the model's sizes, its
  source, its deployment, ``reduced`` and ``assumed``; ``reference`` names
  the module of ``perfbench/reference/`` that computes it);
- the traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind``
  names the driver ``perfbench/drivers/<kind>.py`` that plays it;
- the cell's own file: ``perfbench/cells/<workload>.json`` (the limits of
  its comparisons, the rows it checks);
- each metric: ``perfbench/metrics/<name>.py``, a ``read(ctx)`` that
  returns the number, or None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    entry: dict            # the workloads entry
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    own: dict              # the cell's own file
    end_to_end: list       # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list        # BENCHMARK.json's per-layer metrics this cell reports

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files."""
    root = Path(root)
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without ``workloads`` goes wherever the metric it
    # moves is reported
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(root=root, name=name, entry=entry, config=_json(root / config_entry["file"]),
                traffic=_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json"),
                own=_json(root / "perfbench" / "cells" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``
    (once: a second call for the same file returns the same module)."""
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__) == Path(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """``perfbench/metrics/<name>.py``."""
    return load_module(Path(root) / "perfbench" / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def driver(root: Path, kind: str):
    """``perfbench/drivers/<kind>.py``."""
    return load_module(Path(root) / "perfbench" / "drivers" / f"{kind}.py", f"perfbench_driver_{kind}")


def reference(root: Path, name: str):
    """``perfbench/reference/<name>.py``."""
    return load_module(Path(root) / "perfbench" / "reference" / f"{name}.py", f"perfbench_reference_{name}")
