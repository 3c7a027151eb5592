"""Fixtures of the benchmark's CPU tests: a checkout of the benchmark with
tiny cells added as files, and the card where a test needs one.

Run them from the root of the repo: ``python -m pytest -q perfbench/tests``
(the repo's own test run, which collects ``tests/``, does not collect
them); on a machine with a card, ``-m cuda`` runs the ones that need it.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

TINY_MODELS = {
    "tiny-dense": ("granite-3-8b", dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                                         d_ff=128, vocab_size=9000)),
    # heads of 2 x d_model / num_heads, as the cell's shared block has them
    "tiny-hybrid": ("zamba2-2.7b", dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32,
                                         d_ff=128, vocab_size=9000, ssm_state=16, ssm_head_dim=16,
                                         ssm_chunk=16, shared_attn_every=2)),
}
TINY_TRAFFIC = {
    "tiny-prefill": ("prefill-2k", dict(batch=4, lengths=[16, 32, 32, 64], max_len=64)),
    "tiny-train": ("train-4k", dict(batch=4, seq_len=32)),
}
# cell -> (configuration, traffic, the committed cell whose file it copies)
TINY_CELLS = {
    "tiny-dense-prefill": ("tiny-dense", "tiny-prefill", "granite-prefill-2k"),
    "tiny-hybrid-prefill": ("tiny-hybrid", "tiny-prefill", "granite-prefill-2k"),
    "tiny-dense-train": ("tiny-dense", "tiny-train", "zamba2-train-4k"),
    "tiny-hybrid-train": ("tiny-hybrid", "tiny-train", "zamba2-train-4k"),
}


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def make_root(root: Path) -> Path:
    """A checkout of the benchmark under ``root`` (the program linked in
    from this repo) with the tiny configurations, traffic and cells added
    as new files and entries, nothing that is there edited."""
    shutil.copytree(REPO / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(REPO / "src")
    bench = _read(root / "BENCHMARK.json")
    pb = root / "perfbench"
    for name, (base, sizes) in TINY_MODELS.items():
        cfg = _read(pb / "configs" / f"{base}.json")
        cfg["name"] = name
        cfg["model"].update(name=name, **sizes)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": cfg["source"], "file": f"perfbench/configs/{name}.json",
                                 "reduced": sorted(sizes), "why": "a CPU test's size"})
    for name, (base, params) in TINY_TRAFFIC.items():
        traffic = _read(pb / "traffic" / f"{base}.json")
        traffic.update(params)
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, (config, traffic, base) in TINY_CELLS.items():
        shutil.copy(pb / "cells" / f"{base}.json", pb / "cells" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                   "why": "a CPU test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """The CUDA device a ``cuda`` test runs on; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
