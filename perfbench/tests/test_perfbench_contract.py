"""BENCHMARK.json and the files it names, held to the benchmark's rules:
the keys and names, a file for every configuration, traffic mix, cell
and metric, every cell reporting set-up, another end-to-end metric and a
per-layer one, and a run length that fits a check of 24 cells."""
import json
import re

import pytest
from conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expand|_dim$|_rank$|d_model|d_ff|experts_per)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_the_contracts_keys(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= keys, (e["name"], set(e) - keys)
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter",
                                                     "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_has_its_files_and_reports_enough():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        assert (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "perfbench" / "cells" / f"{w['name']}.json").is_file()
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
    assert used == set(configs)
    for c in configs.values():
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert (REPO / "perfbench" / "reference" / f"{cfg['reference']}.py").is_file()


def test_cells_limits_are_set():
    for w in BENCH["workloads"]:
        own = json.loads((REPO / "perfbench" / "cells" / f"{w['name']}.json").read_text())
        assert own["limits"] and all(0 < v < 1 for v in own["limits"].values())
