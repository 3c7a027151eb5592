"""The port's LCS tuning table, its sweep and ``autotune=True``, on the CPU.

``repro_torch.perf`` mirrors ``repro.perf`` case for case (the classes
below follow ``tests/test_perf_tuning.py``): P quantization, validation,
save/load and the path override, the empty table on every mismatch (the
header names the torch version and the device kind where the JAX table
names the jax version and the backend), exact and nearest-P lookups, the
dtype precedence and the planner's flag.  The port's table never reads or
writes the JAX package's ``TUNING.json``.

``repro_torch.perf.tune`` keeps the JAX sweep's rules: candidates are
checked bit for bit before one may win, and a block cap is swept only where
it changes the block that runs (on the CPU none runs; on the card every
width launches one block under every cap of the JAX grid).

With ``autotune=True`` every engine path (one-shot with the kernel and the
wavefront impls, two shards in both score modes, a host-join and a
device-join stream) runs the record its table holds, equal to the JAX
engine given the same record in its own table (``REPRO_TUNING_PATH``),
tolerance 0: the scored buffer, similar pairs, communities and every stats
count, ``runner_builds`` and ``score_traces`` among them.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.api as japi
import repro.data as jdata
import repro.perf as jperf
from repro.core.types import TrajectoryBatch as JBatch
from repro_torch.api import (
    AnotherMeEngine, CapacityPlanner, EngineConfig, ExecutionPlan, StreamingEngine,
)
from repro_torch.core import similarity as tsim
from repro_torch.core.types import TrajectoryBatch
from repro_torch.data import synthetic_setup
from repro_torch.kernels.lcs import kernel as lcs_kernel
from repro_torch.kernels.lcs import ops as lcs_ops
from repro_torch.perf import (
    DEFAULT_PATH, LCSTuning, SCHEMA, TuningTable, device_kind, quantize_pairs,
    resolve_wavefront_dtype, tuning_path,
)
from repro_torch.perf import tune as ttune

from conftest import REPO, run_subprocess

CPU = "cpu"
WORLD = dict(num_types=10, classes_per_type=5, num_places=200, seed=7)
N_ROWS = 150
# a record every lookup of the worlds below hits (nearest P at H 3, L 10):
# a cap above every batch keeps the CPU's "kernel" dispatch on the
# wavefront (the JAX package's would otherwise run Pallas interpret mode),
# and int32 is not the default dtype, so the record visibly reaches it
RECORD = LCSTuning(block_b=1 << 16, wavefront_dtype="int32")
RECORD_CELL = (1024, 3, 10)
SCORED = ("left", "right", "level_lcs", "mss", "count", "overflow")


def _table_with(key_cells):
    t = TuningTable(device=CPU)
    for (pairs, levels, length), tuning in key_cells.items():
        t.record(pairs, levels, length, tuning)
    return t


# ---------------------------------------------------------------------------
# the table (mirrors tests/test_perf_tuning.py)
# ---------------------------------------------------------------------------
class TestQuantize:
    def test_ceiling_pow2(self):
        assert quantize_pairs(1) == 1
        assert quantize_pairs(2) == 2
        assert quantize_pairs(3) == 4
        assert quantize_pairs(4096) == 4096
        assert quantize_pairs(4097) == 8192
        for p in (1, 3, 1000, 4097, 123_456):
            assert quantize_pairs(p) == jperf.quantize_pairs(p)

    def test_degenerate(self):
        assert quantize_pairs(0) == 1 == jperf.quantize_pairs(0)


class TestLCSTuningValidation:
    def test_rejects_non_pow2_block(self):
        with pytest.raises(ValueError, match="power of two"):
            LCSTuning(block_b=96, wavefront_dtype="int32")

    def test_rejects_unknown_dtype(self):
        with pytest.raises(ValueError, match="wavefront_dtype"):
            LCSTuning(block_b=128, wavefront_dtype="float32")

    def test_record_rejects_int8_at_long_lengths(self):
        t = TuningTable(device=CPU)
        with pytest.raises(ValueError, match="unsafe"):
            t.record(1024, 3, 127, LCSTuning(128, "int8"))
        t.record(1024, 3, 127, LCSTuning(128, "int32"))
        t.record(1024, 3, 126, LCSTuning(128, "int8"))


class TestRoundTrip:
    def test_save_load(self, tmp_path):
        path = tmp_path / "TUNING_torch.json"
        t = _table_with({
            (4096, 3, 32): LCSTuning(256, "int8", pairs_per_sec=1e5),
            (1024, 3, 16): LCSTuning(512, "int32"),
        })
        t.save(path)
        back = TuningTable.load(path, device=CPU)
        assert back.entries == t.entries and back.kind == "cpu"
        assert back.lookup(4096, 3, 32) == LCSTuning(256, "int8", 1e5)
        # the keys are the JAX package's for the CPU backend
        jt = jperf.TuningTable()
        jt.record(4096, 3, 32, jperf.LCSTuning(256, "int8"))
        jt.record(1024, 3, 16, jperf.LCSTuning(512, "int32"))
        assert set(back.entries) == set(jt.entries)

    def test_env_path_override(self, tmp_path, monkeypatch):
        p = tmp_path / "elsewhere.json"
        monkeypatch.setenv("REPRO_TORCH_TUNING_PATH", str(p))
        assert tuning_path() == p
        _table_with({(64, 3, 16): LCSTuning(128, "int32")}).save()
        assert p.exists()
        assert TuningTable.load(device=CPU).lookup(64, 3, 16) is not None

    def test_never_the_jax_table(self, tmp_path, monkeypatch):
        """The port's default file is its own, the JAX override does not
        move it, and a table the JAX package wrote loads empty here (and
        the port's loads empty there)."""
        monkeypatch.delenv("REPRO_TORCH_TUNING_PATH", raising=False)
        monkeypatch.setenv("REPRO_TUNING_PATH", str(tmp_path / "jax.json"))
        assert tuning_path() == DEFAULT_PATH
        assert DEFAULT_PATH.name == "TUNING_torch.json"
        assert DEFAULT_PATH != jperf.DEFAULT_PATH
        assert DEFAULT_PATH.parent == jperf.DEFAULT_PATH.parent
        jt = jperf.TuningTable()
        jt.record(4096, 3, 32, jperf.LCSTuning(256, "int8"))
        jt.save(tmp_path / "jax.json")
        assert TuningTable.load(tmp_path / "jax.json", device=CPU).entries == {}
        _table_with({(4096, 3, 32): LCSTuning(256, "int8")}).save(tmp_path / "port.json")
        assert jperf.TuningTable.load(tmp_path / "port.json").entries == {}


class TestInvalidation:
    """Every mismatch degrades to the EMPTY table, never a partial one."""

    def _saved(self, tmp_path):
        path = tmp_path / "TUNING_torch.json"
        _table_with({(4096, 3, 32): LCSTuning(256, "int8")}).save(path)
        return path

    def test_missing_file(self, tmp_path):
        assert TuningTable.load(tmp_path / "nope.json", device=CPU).entries == {}

    def test_corrupt_json(self, tmp_path):
        path = tmp_path / "TUNING_torch.json"
        path.write_text("{not json")
        assert TuningTable.load(path, device=CPU).entries == {}

    @pytest.mark.parametrize("field,value", [
        ("schema", "repro-torch-tuning/v0"),
        ("torch_version", "0.0.1"),
        ("device_kind", "NVIDIA H100 80GB HBM3"),
    ])
    def test_header_mismatch(self, tmp_path, field, value):
        path = self._saved(tmp_path)
        raw = json.loads(path.read_text())
        assert raw["schema"] == SCHEMA and raw["device_kind"] == "cpu"
        raw[field] = value
        path.write_text(json.dumps(raw))
        assert TuningTable.load(path, device=CPU).entries == {}

    def test_corrupt_cell_discards_whole_table(self, tmp_path):
        path = self._saved(tmp_path)
        raw = json.loads(path.read_text())
        key = next(iter(raw["entries"]))
        raw["entries"]["P64-H3-L16-cpu"] = {"block_b": 96, "wavefront_dtype": "int32"}
        path.write_text(json.dumps(raw))
        t = TuningTable.load(path, device=CPU)
        assert t.entries == {}          # the GOOD cell is gone too
        assert key not in t.entries


class TestLookup:
    def test_exact_hit_is_p_quantized(self):
        t = _table_with({(4096, 3, 32): LCSTuning(256, "int8")})
        assert t.lookup(3000, 3, 32) == LCSTuning(256, "int8")

    def test_nearest_p_fallback(self):
        t = _table_with({
            (1024, 3, 32): LCSTuning(128, "int8"),
            (65536, 3, 32): LCSTuning(512, "int8"),
        })
        assert t.lookup(2048, 3, 32) == LCSTuning(128, "int8")
        assert t.lookup(32768, 3, 32) == LCSTuning(512, "int8")

    def test_miss_on_different_shape(self):
        t = _table_with({(4096, 3, 32): LCSTuning(256, "int8")})
        assert t.lookup(4096, 5, 32) is None   # H differs
        assert t.lookup(4096, 3, 64) is None   # L differs

    def test_miss_on_another_device_kind(self):
        """A cell recorded for a card's kind is never a CPU table's hit,
        and the device kind with spaces and dashes still parses."""
        t = _table_with({(4096, 3, 32): LCSTuning(256, "int8")})
        t.entries["P8192-H3-L32-NVIDIA H100 80GB HBM3"] = LCSTuning(128, "int32")
        assert t.lookup(8192, 3, 32) == LCSTuning(256, "int8")
        card = TuningTable(device=CPU)
        card.kind = "NVIDIA H100 80GB HBM3"
        card.record(8192, 3, 32, LCSTuning(128, "int32"))
        assert card.lookup(2048, 3, 32) == LCSTuning(128, "int32")
        assert device_kind(CPU) == "cpu"


class TestDtypeResolution:
    def test_untuned_falls_back_to_env_default(self, monkeypatch):
        monkeypatch.delenv("REPRO_LCS_DTYPE", raising=False)
        assert resolve_wavefront_dtype(None) == tsim.wavefront_dtype_from_env() == torch.int8
        assert jperf.resolve_wavefront_dtype(None) == jnp.int8

    def test_tuned_dtype_wins_when_unpinned(self, monkeypatch):
        monkeypatch.delenv("REPRO_LCS_DTYPE", raising=False)
        assert resolve_wavefront_dtype(LCSTuning(128, "int32")) == torch.int32
        assert resolve_wavefront_dtype(LCSTuning(128, "int8")) == torch.int8

    def test_env_pin_outranks_tuned(self, monkeypatch):
        monkeypatch.setenv("REPRO_LCS_DTYPE", "int32")
        assert resolve_wavefront_dtype(LCSTuning(128, "int8")) == torch.int32
        monkeypatch.setenv("REPRO_LCS_DTYPE", "int8")
        assert resolve_wavefront_dtype(LCSTuning(128, "int32")) == torch.int8


class TestPlannerPlumbing:
    def test_autotune_off_returns_none(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_TUNING_PATH", str(tmp_path / "T.json"))
        _table_with({(4096, 3, 32): LCSTuning(256, "int8")}).save()
        assert CapacityPlanner().plan_tuning(4096, 3, 32) is None

    def test_autotune_on_reads_table(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_TUNING_PATH", str(tmp_path / "T.json"))
        _table_with({(4096, 3, 32): LCSTuning(256, "int8")}).save()
        planner = CapacityPlanner(autotune=True)
        assert planner.plan_tuning(4096, 3, 32, device=CPU) == LCSTuning(256, "int8")
        assert planner.plan_tuning(4096, 9, 32, device=CPU) is None

    def test_autotune_on_rereads_a_saved_table(self, tmp_path, monkeypatch):
        """The planner parses the table once per version of the file: a new
        save (here of the same size) is read, a removed file reads empty."""
        path = tmp_path / "T.json"
        monkeypatch.setenv("REPRO_TORCH_TUNING_PATH", str(path))
        planner = CapacityPlanner(autotune=True)
        for record in (LCSTuning(128, "int8"), LCSTuning(256, "int8"), LCSTuning(256, "int32")):
            _table_with({(4096, 3, 32): record}).save()
            assert planner.plan_tuning(4096, 3, 32, device=CPU) == record
            assert planner.plan_tuning(4096, 3, 32, device=CPU) == record
        path.unlink()
        assert planner.plan_tuning(4096, 3, 32, device=CPU) is None

    def test_execution_plan_flags(self):
        assert ExecutionPlan().autotune is False
        assert ExecutionPlan().overlap_chunks == 1
        ExecutionPlan(overlap_chunks=4)
        with pytest.raises(ValueError, match="power of two"):
            ExecutionPlan(overlap_chunks=3)
        with pytest.raises(ValueError, match="power of two"):
            ExecutionPlan(overlap_chunks=0)


class TestTunedDispatchParity:
    def test_tuned_lcs_bit_identical(self):
        """A tuned (block_b, dtype) through ops.lcs matches the default, and
        the JAX wavefront."""
        from repro.core.similarity import lcs_wavefront as j_wavefront

        rng = np.random.default_rng(0)
        B, L = 300, 12
        a = rng.integers(0, 6, size=(B, L)).astype(np.int32)
        b = rng.integers(0, 6, size=(B, L)).astype(np.int32)
        base = lcs_ops.lcs(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(base.numpy(), np.asarray(j_wavefront(a, b)))
        for t in (LCSTuning(128, "int8"), LCSTuning(256, "int32")):
            got = lcs_ops.lcs(torch.tensor(a), torch.tensor(b), block_b=t.block_b,
                              wavefront_dtype=resolve_wavefront_dtype(t))
            assert torch.equal(got, base)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def test_tune_records_a_bit_identical_default(tmp_path):
    path, cells = ttune.tune(grid=[(256, 3, 16)], device=CPU, out_path=tmp_path / "T.json",
                             repeats=1)
    (cell,) = cells
    assert (cell.P, cell.H, cell.L) == (256, 3, 16)
    assert cell.winner.block_b == 512 and cell.winner.pairs_per_sec > 0
    assert [(t.block_b, t.wavefront_dtype) for t in cell.trials] == [(512, "int8"), (512, "int32")]
    assert all(t.block is None and t.ms > 0 for t in cell.trials)
    table = TuningTable.load(path, device=CPU)
    assert table.lookup(256, 3, 16) == cell.winner
    # the next sweep merges into the table it loads
    ttune.tune(grid=[(128, 3, 8)], device=CPU, out_path=path, repeats=1)
    assert set(TuningTable.load(path, device=CPU).entries) == {"P256-H3-L16-cpu", "P128-H3-L8-cpu"}


def test_tune_refuses_a_divergent_candidate(tmp_path, monkeypatch):
    real = lcs_ops.lcs

    def corrupt(a, b, **kw):
        out = real(a, b, **kw)
        return out + 1 if kw.get("wavefront_dtype") == torch.int32 else out

    monkeypatch.setattr(ttune.lcs_ops, "lcs", corrupt)
    with pytest.raises(AssertionError, match="refusing to record"):
        ttune.tune(grid=[(64, 3, 8)], device=CPU, out_path=tmp_path / "T.json", repeats=1)
    assert not (tmp_path / "T.json").exists()


def test_tune_refuses_a_reference_off_the_plain_version(tmp_path, monkeypatch):
    monkeypatch.setattr(ttune, "lcs_plain", lambda a, b: lcs_kernel.lcs_plain(a, b) + 1)
    with pytest.raises(AssertionError, match="diverges from the plain version"):
        ttune.tune(grid=[(64, 3, 8)], device=CPU, out_path=tmp_path / "T.json", repeats=1)
    assert not (tmp_path / "T.json").exists()


def test_tune_candidates_and_grids():
    """JAX's CPU candidates: 512 only.  On a card, every cap of the JAX
    grid launches the same block at the grids' widths and at L = 40 (the
    register route's 128 threads; the shared route's shared-memory cap),
    so 512 stays the only candidate."""
    assert ttune.block_candidates(3072, 16, CPU) == (512,)
    card = torch.device("cuda")
    for B, L in ((3072, 16), (12288, 32), (49152, 32), (20480, 32), (12288, 40), (100, 40)):
        blocks = {ttune.launched_block(B, L, bb, card) for bb in ttune.BLOCK_CAPS}
        assert len(blocks) == 1, (B, L, blocks)
        assert ttune.block_candidates(B, L, card) == (512,)
    assert ttune.launched_block(12288, 40, 512, card) == 128
    assert ttune.launched_block(12288, 60, 512, card) == 64
    assert ttune.launched_block(3072, 16, 512, card) == 128
    assert ttune.launched_block(3072, 16, 512, CPU) is None
    assert ttune.SMOKE_GRID == ((1024, 3, 16), (4096, 3, 32))
    assert ttune.FULL_GRID == ((1024, 3, 16), (4096, 3, 16), (4096, 3, 32),
                               (16384, 3, 32), (4096, 5, 32))


def test_make_inputs_matches_the_jax_generator():
    sys.path.insert(0, REPO)
    try:
        from benchmarks.bench_score import _make_inputs
    finally:
        sys.path.remove(REPO)
    for P, H, L in ((1024, 3, 16), (64, 5, 7)):
        for got, want in zip(ttune.make_inputs(P, H, L, device=CPU), _make_inputs(P, H, L)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# autotune=True on every engine path, against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Each package's table holding RECORD, at its own path."""
    monkeypatch.setenv("REPRO_TORCH_TUNING_PATH", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNING_PATH", str(tmp_path / "jax.json"))
    monkeypatch.delenv("REPRO_LCS_DTYPE", raising=False)
    _table_with({RECORD_CELL: RECORD}).save()
    jt = jperf.TuningTable()
    jt.record(*RECORD_CELL, jperf.LCSTuning(RECORD.block_b, RECORD.wavefront_dtype))
    jt.save()
    return tmp_path


@pytest.fixture(scope="module")
def world():
    jb, jf = jdata.synthetic_setup(N_ROWS, **WORLD)
    tb, tf = synthetic_setup(N_ROWS, device=CPU, **WORLD)
    return tb, tf, jb, jf


@pytest.fixture
def dtypes_seen(monkeypatch):
    """The dtypes the port's wavefront ran with (the "wavefront" impl, and
    the "kernel" impl's CPU dispatch and plain version, all reach it)."""
    seen = []
    real = tsim.lcs_wavefront

    def spy(a, b, *, dtype=torch.int8):
        seen.append(dtype)
        return real(a, b, dtype=dtype)

    monkeypatch.setattr(tsim, "lcs_wavefront", spy)
    monkeypatch.setattr(lcs_ops, "lcs_wavefront", spy)
    monkeypatch.setattr(lcs_kernel, "lcs_wavefront", spy)
    return seen


def assert_scored(got, want):
    for f in SCORED:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("impl", ["kernel", "wavefront"])
def test_one_shot_autotune_matches_jax(tables, world, dtypes_seen, impl):
    tb, tf, jb, jf = world
    cfg = dict(lcs_impl=impl, community_mode="components")
    eng = AnotherMeEngine(tf, EngineConfig(**cfg), ExecutionPlan(autotune=True), device=CPU)
    assert eng.planner.autotune
    assert eng.planner.plan_tuning(1 << 20, 3, 10, device=CPU) == RECORD
    got = eng.run(tb)
    want = japi.AnotherMeEngine(jf, japi.EngineConfig(**cfg), japi.ExecutionPlan(autotune=True)).run(jb)
    assert_scored(got.scored, want.scored)
    assert got.similar_pairs == want.similar_pairs and got.communities == want.communities
    assert dtypes_seen and set(dtypes_seen) == {torch.int32}
    # the untuned run: the same results on the default dtype
    dtypes_seen.clear()
    plain = AnotherMeEngine(tf, EngineConfig(**cfg), device=CPU).run(tb)
    assert_scored(plain.scored, want.scored)
    assert set(dtypes_seen) == {torch.int8}


JAX_SHARDED = r"""
import os
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import json, numpy as np
from repro.api import AnotherMeEngine, EngineConfig, ExecutionPlan
from repro.data import synthetic_setup
from repro.perf import LCSTuning, TuningTable

SPEC = json.loads(%(spec)r)
t = TuningTable()
t.record(*SPEC["cell"], LCSTuning(**SPEC["record"]))
t.save()
batch, forest = synthetic_setup(SPEC["n"], **SPEC["world"])
arrays, meta = {}, {}
for name, c in SPEC["cases"].items():
    eng = AnotherMeEngine(forest, EngineConfig(lcs_impl=c["impl"], community_mode="components"),
                          ExecutionPlan(n_shards=2, score_mode=c["mode"], autotune=True))
    res = eng.run(batch)
    for f in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        arrays[f"{name}/{f}"] = np.asarray(getattr(res.scored, f))
    meta[name] = dict(similar=sorted(map(list, res.similar_pairs)),
                      communities=sorted(sorted(c) for c in res.communities),
                      runners=len(eng._runner_cache))
np.savez(%(path)r + ".npz", **arrays)
print("META" + json.dumps(meta))
"""
SHARDED_CASES = {"replicate-kernel": dict(mode="replicate", impl="kernel"),
                 "shuffle-wavefront": dict(mode="shuffle", impl="wavefront")}


def test_sharded_autotune_matches_jax(tables, world, dtypes_seen):
    tb, tf, _, _ = world
    spec = dict(n=N_ROWS, world=WORLD, cell=RECORD_CELL, record=dataclasses.asdict(RECORD),
                cases=SHARDED_CASES)
    path = str(tables / "sharded")
    out = run_subprocess(JAX_SHARDED % dict(spec=json.dumps(spec), path=path), devices=2)
    meta = json.loads(out.split("META", 1)[1])
    arrays = np.load(path + ".npz")
    for name, c in SHARDED_CASES.items():
        eng = AnotherMeEngine(tf, EngineConfig(lcs_impl=c["impl"], community_mode="components"),
                              ExecutionPlan(n_shards=2, score_mode=c["mode"], devices=(CPU,) * 2,
                                            autotune=True), device=CPU)
        res = eng.run(tb)
        for f in SCORED:
            np.testing.assert_array_equal(getattr(res.scored, f).numpy(), arrays[f"{name}/{f}"],
                                          err_msg=f"{name} {f}")
        assert sorted(map(list, res.similar_pairs)) == meta[name]["similar"], name
        assert sorted(sorted(x) for x in res.communities) == meta[name]["communities"], name
        assert len(eng._runner_cache) == meta[name]["runners"], name
        assert any(RECORD in key for key in eng._runner_cache), name
    assert set(dtypes_seen) == {torch.int32}


@pytest.mark.parametrize("delta_join", ["host", "device"])
def test_stream_autotune_matches_jax(tables, world, dtypes_seen, delta_join):
    tb, tf, jb, jf = world
    places, lengths = tb.places.numpy(), tb.lengths.numpy()
    cfg = dict(lcs_impl="kernel", community_mode="components")
    plan = dict(delta_join=delta_join, autotune=True)
    t = StreamingEngine(tf, EngineConfig(**cfg), ExecutionPlan(**plan), window=2, device=CPU)
    j = japi.StreamingEngine(jf, japi.EngineConfig(**cfg), japi.ExecutionPlan(**plan), window=2)
    untuned = StreamingEngine(tf, EngineConfig(**cfg), ExecutionPlan(delta_join=delta_join),
                              window=2, device=CPU)
    for lo, hi in ((0, 50), (50, 100), (100, N_ROWS)):
        p, ln = places[lo:hi], lengths[lo:hi]
        got = t.update(TrajectoryBatch(places=torch.tensor(p), lengths=torch.tensor(ln),
                                       user_id=torch.arange(hi - lo, dtype=torch.int32)))
        want = j.update(JBatch(places=jnp.asarray(p), lengths=jnp.asarray(ln),
                               user_id=jnp.arange(hi - lo, dtype=jnp.int32)))
        assert_scored(got.scored, want.scored)
        assert got.similar_pairs == want.similar_pairs
        assert got.communities == want.communities
        for key in ("runner_builds", "score_traces", "num_delta_pairs", "num_similar"):
            assert got.stats[key] == want.stats[key], key
        plain = untuned.update(TrajectoryBatch(places=torch.tensor(p), lengths=torch.tensor(ln),
                                               user_id=torch.arange(hi - lo, dtype=torch.int32)))
        assert_scored(plain.scored, want.scored)
    if delta_join == "device":
        assert t.runner_builds > 0 and any(RECORD in key for key in t._runner_cache)
    assert torch.int32 in dtypes_seen
