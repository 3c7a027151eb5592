"""The port's dry-run and perf drivers against the JAX package's, on the CPU.

- ``model_flops``, ``pick_grad_accum``, ``_layer_period``, ``_opt_bits`` and
  ``enumerate_cells`` equal the reference's functions for every
  architecture and shape (pure arithmetic over the same configs: exactly).
- ``Roofline``: given the reference's constants as its rates, the port's
  ``dominant``, ``step_time_s``, ``mfu`` and ``useful_flops_ratio`` equal
  the reference's on the same counts (the same float64 arithmetic:
  exactly); the port's source holds none of the reference's TPU constants.
- ``VARIANTS``: the reference's list, field for field.
- The derived collective bytes (``collective_bytes_derived``,
  ``anotherme_collective_bytes``) equal the counters of the mesh the
  program runs on, exactly, for a data- and expert-parallel training step,
  an expert-parallel prefill and decode step, and the sharded AnotherMe
  pipeline on CPU meshes.
- The drivers end to end on the CPU: every cell derived (and written out),
  a cell's step measured at one layer period (the wall clock only: the
  device times are the card's), a variant too big for the card recorded
  with the bytes that kept it off.

The reference's dry-run and perf modules set ``XLA_FLAGS`` when imported;
they are imported once JAX's devices are bound, and the variable restored.
"""
import dataclasses
import json
import math
import os
import pathlib
import re

import jax
import pytest
import torch

from conftest import REPO

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import hlo_analysis as jH

from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import compat
from repro_torch.launch import dryrun, perf
from repro_torch.launch import roofline as R
from repro_torch.launch.inputs import make_inputs
from repro_torch.models import moe
from repro_torch.models.model import forward, init_params
from repro_torch.serve.kvcache import init_cache
from repro_torch.serve.serve_step import make_decode_step
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

CPU = "cpu"


@pytest.fixture(scope="module")
def jref():
    """The reference's dry-run and perf modules (imported with this
    process's device count already bound, ``XLA_FLAGS`` restored)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
        import repro.launch.perf as jperf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry, jperf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", all_archs())
def test_cell_arithmetic_equals_jax(jref, arch):
    jdry, _ = jref
    jc, tc = j_get_config(arch), get_config(arch)
    assert dryrun._opt_bits(tc) == jdry._opt_bits(jc)
    assert dryrun._layer_period(tc) == jdry._layer_period(jc)
    for sname, shape in SHAPES.items():
        assert dryrun.model_flops(tc, shape) == jdry.model_flops(jc, J_SHAPES[sname]), sname
        for dp in (1, 2, 16, 32, 256):
            assert dryrun.pick_grad_accum(tc, shape, dp) == jdry.pick_grad_accum(jc, J_SHAPES[sname], dp)


def test_enumerate_cells_equals_jax(jref):
    assert dryrun.enumerate_cells() == jref[0].enumerate_cells()


def test_variants_equal_jax(jref):
    assert perf.VARIANTS == jref[1].VARIANTS


@pytest.mark.parametrize("counts", [(1e15, 3e11, 4e9, 6e17, 256), (2e12, 9e12, 1e10, 0.0, 512),
                                    (1e10, 1e8, 5e12, 1e14, 16), (0.0, 0.0, 0.0, 0.0, 1)])
def test_roofline_equals_jax_at_its_constants(counts):
    flops, nbytes, coll, mf, chips = counts
    want = jH.Roofline(compute_s=flops / jH.PEAK_FLOPS, memory_s=nbytes / jH.HBM_BW,
                       collective_s=coll / jH.ICI_BW, hlo_flops=flops, hlo_bytes=nbytes,
                       coll_bytes=coll, model_flops=mf, chips=chips)
    got = R.Roofline.from_counts(flops, nbytes, coll, model_flops=mf, chips=chips,
                                 peak_flops=jH.PEAK_FLOPS, hbm_bw=jH.HBM_BW, link_bw=jH.ICI_BW)
    for name in ("compute_s", "memory_s", "collective_s", "dominant", "step_time_s", "mfu",
                 "useful_flops_ratio"):
        assert getattr(got, name) == getattr(want, name), name
    h100 = R.Roofline.from_counts(flops, nbytes, coll, model_flops=mf, chips=chips)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12, 450e9)


def test_no_tpu_constant_in_the_port():
    root = pathlib.Path(REPO) / "src" / "repro_torch"
    # 50e9 is the reference's ICI rate, and also its 50-billion-parameter
    # threshold for 8-bit moments (``_opt_bits``), which the port keeps
    tpu = re.compile(r"(?<![\d.])(197e12|197e\+12|819e9|8\.19e11|50e9)|(?<!\w)(ICI_BW|PEAK_FLOPS|HBM_BW)\b")
    hits = {f"{f.name}: {line.strip()}" for f in root.rglob("*.py") for line in f.read_text().splitlines()
            if tpu.search(line) and "param_count(cfg) > 50e9" not in line}
    assert not hits


def _cpu_mesh(shape):
    return compat.make_mesh(shape, ("data", "model"), devices=(CPU,) * math.prod(shape))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
@pytest.mark.parametrize("accum", [1, 2])
def test_derived_train_collectives_equal_the_mesh(shape, accum):
    cfg = get_config("deepseek-v2-236b").reduced()
    run = ShapeConfig("t", 8, 8, "train")
    params = init_params(cfg, 0, CPU, dtype=torch.float32)
    mesh = _cpu_mesh(shape)
    tcfg = TrainConfig(grad_accum=accum)
    make_train_step(cfg, tcfg, mesh)(params, make_train_state(params, tcfg),
                                     make_inputs(cfg, run, seed=0, device=CPU))
    assert mesh.collective_bytes == dryrun.collective_bytes_derived(cfg, run, mesh.shape, accum)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_derived_serving_collectives_equal_the_mesh(kind):
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    run = ShapeConfig("t", 8, 4, kind)
    params = init_params(cfg, 0, CPU)
    mesh = _cpu_mesh((2, 2))
    with torch.inference_mode():
        if kind == "prefill":
            forward(params, make_inputs(cfg, run, seed=0, device=CPU), cfg, mesh, last_only=True)
        else:
            make_decode_step(cfg, mesh)(params, init_cache(cfg, 4, 8, CPU), torch.zeros(4, 1, dtype=torch.long))
    assert mesh.collective_bytes == dryrun.collective_bytes_derived(cfg, run, mesh.shape)
    moe.reset_dropped()


def test_anotherme_collectives_and_measure_on_the_cpu():
    v = next(v for v in perf.VARIANTS if v["name"] == "anotherme/v1-nodedup")
    world = perf.anotherme_world(1024, 16, CPU)
    # the reference's plan for 2 shards but 4,096 scored slots a shard (2^18
    # slots of the plain LCS take seconds on the CPU; no collective moves them)
    plan = dataclasses.replace(perf.anotherme_plan(1024, 2), scored_cap=4096)
    rec = perf.measure_anotherme(v, device=CPU, n_shards=2, n_traj=1024, world=world, plan=plan)
    assert rec["collective_bytes"] == perf.anotherme_collective_bytes(plan)
    assert rec["plan"]["shingle_route_cap"] == perf.anotherme_plan(1024, 2).shingle_route_cap
    assert rec["peak_bytes"] is None and rec["device_ms_by_kind"] is None and rec["wall_ms"] > 0
    assert rec["scored_pairs"] > 0 and rec["capped"] == any(rec["overflow (join, pair route, scored)"])
    derived = perf.derive_anotherme()
    assert derived["plan"]["n_shards"] == 256 and derived["plan"]["local_n"] == 4096
    assert derived["roofline"]["rates"]["peak_flops"] == R.H100_INT32_OPS


def test_dryrun_derives_every_cell(tmp_path):
    out = tmp_path / "dry.json"
    records = dryrun.main(["--out", str(out)])
    runnable = [c for c in dryrun.enumerate_cells() if c[2]]
    assert len(records) == 2 * len(runnable) and json.loads(out.read_text()) == records
    for r in records:
        assert r["status"] == "ok" and "measured" not in r
        d = r["derived"]
        assert d["per_rank_bytes"]["params"] > 0 and d["roofline"]["step_time_bound_s"] > 0
        assert ("opt_state" in d["per_rank_bytes"]) == (r["shape"] == "train_4k")
        assert ("cache" in d["per_rank_bytes"]) == (r["shape"] in ("decode_32k", "long_500k"))
    assert dryrun.main(["--list"]) == []


@pytest.mark.parametrize("arch,sname", [("granite-3-8b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
                                        ("deepseek-v2-236b", "prefill_32k")])
def test_measure_cell_runs_each_kind_on_the_cpu(monkeypatch, arch, sname):
    """A cell of each kind at one layer period, at a short length."""
    cfg = get_config(arch).reduced()
    monkeypatch.setitem(dryrun.SHAPES, sname, dataclasses.replace(SHAPES[sname], seq_len=32))
    rec = dryrun.measure_cell(arch, sname, device=CPU, cfg=cfg, batch=2)
    assert rec["layers"] == dryrun._layer_period(cfg) and rec["batch"] == 2 and rec["wall_ms"] > 0
    assert rec["peak_bytes"] is None and rec["device_ms_by_kind"] is None  # the card's numbers


def test_perf_records_what_does_not_fit(tmp_path):
    kimi = next(v for v in perf.VARIANTS if v["name"] == "kimi/v3-accum2")
    rec = perf.run_variant(kimi, device=CPU)  # measuring: refused before any allocation
    assert rec["status"] == "ok" and "measured" not in rec
    need = rec["derived"]["one_period_train_state_bytes"]
    assert need["total"] > perf.CARD_BYTES and "past the card" in rec["not_measured"]
    out = tmp_path / "perf.json"
    records = perf.main(["--derive-only", "--out", str(out)])
    assert [r["name"] for r in records] == [v["name"] for v in perf.VARIANTS]
    assert all(r["status"] == "ok" and "derived" in r and "measured" not in r for r in records)
