"""The port's one-shot sharded pipeline against the JAX package's, on the CPU.

``AnotherMeEngine(..., ExecutionPlan(n_shards=n, devices=("cpu",) * n))``
runs the sharded program on an in-process mesh of n CPU shards.  A JAX
subprocess (``conftest.run_subprocess``: n virtual CPU devices) runs the same
seeded world through the JAX engine and dumps every output; the port runs
the same plans here, tolerance 0:

* every per-shard array of the program (``left``, ``right``, ``level_lcs``,
  ``mss``, ``overflow``, ``pruned``), slot by slot;
* the ``DistributedPlan`` (after any retry), the scored buffer, the similar
  pairs, the communities and every stats entry but the times;
* the similar pairs and communities also against the port's one-shard
  engine.

Tier 1 runs four shards: "ssh" in both score modes, the prune off and on,
``overlap_chunks`` 1 and 4 (shuffle), whole trajectories and windows of 4,
the other backends in replicate mode, a run under shrunken capacities that
retries, and the legacy ``make_distributed_anotherme``.  The ``slow`` matrix
runs every backend in every mode at 2, 3 and 8 shards.  In-process, where
numpy suffices: ``plan_capacities`` on skewed keys, the int32 hashes at their
edges, ``pad_to_shards`` and the mesh's collectives.
"""
import concurrent.futures
import json

import numpy as np
import pytest
import torch

import repro.api.sharded as jsharded
from repro_torch.api import (
    AnotherMeEngine, CallableBackend, EngineConfig, ExecutionPlan,
    StreamingEngine,
)
from repro_torch.api import engine as tengine
from repro_torch.api import sharded as tsharded
from repro_torch.core import compat
from repro_torch.core.types import PAD_ID, PAD_KEY, TrajectoryBatch
from repro_torch.data import synthetic_setup
from repro_torch.launch.mesh import make_executor_mesh

from conftest import run_subprocess

CPU = "cpu"
WORLD = dict(num_types=10, classes_per_type=5, num_places=200, seed=3)
N = 301  # not a multiple of the shard counts: the engine pads
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
HASH_TO_INT32_MIN = -1936480083  # _positive_hash mixes it to INT32_MIN
OUT_FIELDS = ("left", "right", "level_lcs", "mss", "overflow", "pruned")
SCORED_FIELDS = ("left", "right", "level_lcs", "mss", "count", "overflow")


def case(n, backend="ssh", mode="replicate", oc=1, prune=False, window=None, impl="fused",
         slack=1.3):
    # with the prune on, a rho the bound min(len) can miss: rows hold 5-10
    # places and windows of 4 up to 4
    rho = (3.5 if window else 6.5) if prune else 2.0
    return dict(n_shards=n, backend=backend, score_mode=mode, overlap_chunks=oc, rho=rho,
                score_prune=prune, subtraj_window=window, lcs_impl=impl, shard_slack=slack)


def matrix(shard_counts, backends):
    """Every backend x {replicate, shuffle, shuffle chunked} x prune x
    {whole rows, windows of 4}; the impl alternates between the fused
    scorer and the gathered LCS impls."""
    out = {}
    for n in shard_counts:
        for b in backends:
            for mode, oc in (("replicate", 1), ("shuffle", 1), ("shuffle", 4)):
                for prune in (False, True):
                    for window in (None, 4):
                        impl = ("fused" if not prune
                                else "kernel" if window is None else "wavefront")
                        name = f"n{n}-{b}-{mode}{oc}-prune{int(prune)}-w{window or 0}-{impl}"
                        out[name] = case(n, b, mode, oc, prune, window, impl)
    return out


TIER1 = {
    **matrix([4], ["ssh"]),
    **{f"n4-{b}-replicate": case(4, b) for b in ("minhash", "brp", "udf")},
    "n4-ssh-replicate-retry": case(4, slack=0.2),
    "n4-ssh-shuffle4-retry": case(4, mode="shuffle", oc=4, slack=0.2, impl="wavefront"),
}
SLOW = matrix([2, 3, 8], ["ssh", "minhash", "brp", "udf"])

JAX_DUMP = r"""
import os
# one thread a process: the dump runs beside the suite's other workers
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import json, numpy as np, jax, jax.numpy as jnp
import repro.api.engine as E
from repro.api import AnotherMeEngine, EngineConfig, ExecutionPlan
from repro.api.sharded import make_distributed_anotherme, pad_to_shards, plan_capacities
from repro.core import compat
from repro.core.encoding import encode_types, forest_tables
from repro.core.shingling import shingles_from_types
from repro.core.similarity import default_betas
from repro.data import synthetic_setup

SPEC = json.loads(%(spec)r)
captured = {}
_execute = E._ShardedEncodeJoinScoreStage._execute

def _capture(self, *a, **k):
    out, dplan = _execute(self, *a, **k)
    captured["out"] = {f: np.asarray(v) for f, v in out.items()}
    return out, dplan

E._ShardedEncodeJoinScoreStage._execute = _capture
batch, forest = synthetic_setup(SPEC["n"], **SPEC["world"])
arrays, meta = {}, {}
for name, c in SPEC["cases"].items():
    plan = ExecutionPlan(n_shards=c["n_shards"], score_mode=c["score_mode"],
                         overlap_chunks=c["overlap_chunks"], shard_slack=c["shard_slack"])
    cfg = EngineConfig(backend=c["backend"], score_prune=c["score_prune"], rho=c["rho"],
                       subtraj_window=c["subtraj_window"], lcs_impl=c["lcs_impl"])
    res = AnotherMeEngine(forest, cfg, plan).run(batch)
    for f, v in captured.pop("out").items():
        arrays[f"{name}/out/{f}"] = v
    for f in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        arrays[f"{name}/scored/{f}"] = np.asarray(getattr(res.scored, f))
    meta[name] = dict(
        similar=sorted(map(list, res.similar_pairs)),
        communities=sorted(sorted(c) for c in res.communities),
        stats={k: v for k, v in res.stats.items() if not k.startswith("t_")},
    )
places, lengths = pad_to_shards(np.asarray(batch.places), np.asarray(batch.lengths), 4)
tables = forest_tables(forest)
keys = np.asarray(shingles_from_types(encode_types(jnp.asarray(places), tables),
                                      jnp.asarray(lengths), k=3, num_types=forest.num_types))
for mode in ("replicate", "shuffle") if SPEC["legacy"] else ():
    plan = plan_capacities(keys, 4, score_mode=mode)
    run = make_distributed_anotherme(compat.make_mesh((4,), ("ex",), devices=jax.devices()[:4]),
                                     plan, tables=tables, k=3, num_types=forest.num_types,
                                     betas=default_betas(3), score_mode=mode)
    for f, v in run(jnp.asarray(places), jnp.asarray(lengths)).items():
        arrays[f"legacy-{mode}/out/{f}"] = np.asarray(v)
np.savez(%(path)r + ".npz", **arrays)
with open(%(path)r + ".json", "w") as fh:
    json.dump(meta, fh)
print("OK")
"""


def jax_dump(path, cases, devices, parts=3):
    """Run the JAX dump in ``parts`` concurrent subprocesses (each compiles
    its share of the cases; the last one also runs the legacy entry point)
    and merge their outputs."""
    names = list(cases)
    shares = [names[i::parts] for i in range(parts)]

    def dump(i):
        spec = json.dumps({"n": N, "world": WORLD, "legacy": i == parts - 1,
                           "cases": {k: cases[k] for k in shares[i]}})
        run_subprocess(JAX_DUMP % {"spec": spec, "path": f"{path}-{i}"}, devices=devices,
                       timeout=1800)

    with concurrent.futures.ThreadPoolExecutor(parts) as pool:
        list(pool.map(dump, range(parts)))
    arrays, meta = {}, {}
    for i in range(parts):
        with np.load(f"{path}-{i}.npz") as z:
            arrays.update({k: z[k] for k in z.files})
        with open(f"{path}-{i}.json") as fh:
            meta.update(json.load(fh))
    return arrays, meta


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's shards run small tensors through many short ops: with a
    thread pool each, the suite's parallel workers oversubscribe the cores
    (one case took 57 s with 8 threads and 7.5 s with 1 beside six busy
    processes on an 8-core CPU), so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tier1(tmp_path_factory):
    return jax_dump(tmp_path_factory.mktemp("sharded") / "tier1", TIER1, devices=4)


@pytest.fixture(scope="module")
def slow_dump(tmp_path_factory):
    return jax_dump(tmp_path_factory.mktemp("sharded") / "slow", SLOW, devices=8)


@pytest.fixture(scope="module")
def world():
    return synthetic_setup(N, device=CPU, **WORLD)


_ONE_SHARD: dict = {}


def one_shard(world, c):
    """The port's one-shard engine result for a case's config (cached)."""
    key = (c["backend"], c["score_prune"], c["subtraj_window"], c["rho"])
    if key not in _ONE_SHARD:
        batch, forest = world
        cfg = EngineConfig(backend=c["backend"], score_prune=c["score_prune"], rho=c["rho"],
                           subtraj_window=c["subtraj_window"])
        _ONE_SHARD[key] = AnotherMeEngine(forest, cfg, device=CPU).run(batch)
    return _ONE_SHARD[key]


def run_port(world, c, monkeypatch):
    """The port's engine on a CPU mesh; returns (result, the program's
    per-shard outputs, the engine)."""
    captured = {}
    execute = tengine._ShardedEncodeJoinScoreStage._execute

    def capture(self, *a, **k):
        out, dplan, retries = execute(self, *a, **k)
        captured["out"] = out
        return out, dplan, retries

    monkeypatch.setattr(tengine._ShardedEncodeJoinScoreStage, "_execute", capture)
    batch, forest = world
    n = c["n_shards"]
    plan = ExecutionPlan(n_shards=n, devices=(CPU,) * n, score_mode=c["score_mode"],
                         overlap_chunks=c["overlap_chunks"], shard_slack=c["shard_slack"])
    cfg = EngineConfig(backend=c["backend"], score_prune=c["score_prune"], rho=c["rho"],
                       subtraj_window=c["subtraj_window"], lcs_impl=c["lcs_impl"])
    eng = AnotherMeEngine(forest, cfg, plan, device=CPU)
    res = eng.run(batch)
    return res, captured["out"], eng


def assert_exact(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def check_case(name, c, dump, world, monkeypatch):
    arrays, meta = dump
    res, out, eng = run_port(world, c, monkeypatch)
    for f in OUT_FIELDS:
        assert_exact(out[f], arrays[f"{name}/out/{f}"], f"{name} out {f}")
    for f in SCORED_FIELDS:
        assert_exact(getattr(res.scored, f), arrays[f"{name}/scored/{f}"], f"{name} scored {f}")
    want = meta[name]
    assert sorted(map(list, res.similar_pairs)) == want["similar"]
    assert sorted(sorted(x) for x in res.communities) == want["communities"]
    stats = {k: v for k, v in res.stats.items() if not k.startswith("t_")}
    assert stats == want["stats"]
    assert all(k in res.stats for k in ("t_keys", "t_plan", "t_execute", "t_communities"))
    ref = one_shard(world, c)
    assert res.similar_pairs == ref.similar_pairs and res.communities == ref.communities
    if c["shard_slack"] < 1:
        assert eng.last_shard_retries > 0, "the shrunken plan should have retried"
    if c["score_prune"] and c["backend"] == "ssh":
        assert res.stats["num_pruned"] > 0, "the prune dropped nothing"
    assert res.stats["join_overflow"] == 0


@pytest.mark.parametrize("name", list(TIER1))
def test_engine_matches_jax_shard_by_shard(name, tier1, world, monkeypatch):
    check_case(name, TIER1[name], tier1, world, monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW))
def test_engine_matrix_matches_jax(name, slow_dump, world, monkeypatch):
    check_case(name, SLOW[name], slow_dump, world, monkeypatch)


@pytest.mark.parametrize("mode", ["replicate", "shuffle"])
def test_make_distributed_anotherme_matches_jax(mode, tier1, world):
    from repro_torch.core.encoding import encode_types, forest_tables
    from repro_torch.core.shingling import shingles_from_types
    from repro_torch.core.similarity import default_betas

    arrays, _ = tier1
    batch, forest = world
    places, lengths = tsharded.pad_to_shards(batch.places.numpy(), batch.lengths.numpy(), 4)
    places, lengths = torch.as_tensor(places), torch.as_tensor(lengths)
    tables = forest_tables(forest, device=CPU)
    keys = shingles_from_types(encode_types(places, tables), lengths, k=3,
                               num_types=forest.num_types).numpy()
    plan = tsharded.plan_capacities(keys, 4, score_mode=mode)
    want_plan = jsharded.plan_capacities(keys, 4, score_mode=mode)
    assert plan.__dict__ == want_plan.__dict__
    run = tsharded.make_distributed_anotherme(
        make_executor_mesh(devices=(CPU,) * 4), plan, tables=tables, k=3,
        num_types=forest.num_types, betas=default_betas(3, device=CPU), score_mode=mode,
    )
    out = run(places, lengths)
    for f in OUT_FIELDS:
        assert_exact(out[f], arrays[f"legacy-{mode}/out/{f}"], f"legacy {mode} {f}")
    assert tsharded.gather_similar_pairs(out, 2.0) == jsharded.gather_similar_pairs(
        {f: arrays[f"legacy-{mode}/out/{f}"] for f in OUT_FIELDS}, 2.0)


# ---------------------------------------------------------------------------
# in-process: the numpy planner, the hashes, the padding, the mesh
# ---------------------------------------------------------------------------
def skewed_keys(rng, n, s, hot=0.3, alphabet=50):
    """PAD-padded keys where a few hot keys take ``hot`` of the slots."""
    keys = rng.integers(0, alphabet, size=(n, s)).astype(np.int32)
    keys[rng.random((n, s)) < hot] = 7
    keys[rng.random((n, s)) < 0.2] = PAD_KEY
    return np.sort(keys, axis=1)


PLAN_CASES = {
    "replicate": dict(),
    "shuffle": dict(score_mode="shuffle"),
    "shuffle-chunks": dict(score_mode="shuffle", overlap_chunks=4),
    "prune": dict(prune=True),
    "shuffle-prune-chunks": dict(score_mode="shuffle", overlap_chunks=2, prune=True),
    "windows": dict(score_mode="shuffle", windows_per_row=3, overlap_chunks=4, prune=True),
    "past-exact-limit": dict(exact_pair_limit=50),
    "past-exact-limit-chunks": dict(exact_pair_limit=50, score_mode="shuffle", overlap_chunks=4),
}


@pytest.mark.parametrize("n_shards", [3, 8])
@pytest.mark.parametrize("case_name", list(PLAN_CASES))
def test_plan_capacities_matches_jax(case_name, n_shards):
    kw = dict(PLAN_CASES[case_name])
    rng = np.random.default_rng(sorted(PLAN_CASES).index(case_name) + 10 * n_shards)
    nw = kw.get("windows_per_row", 1)
    keys = skewed_keys(rng, 40 * nw, 6)
    if kw.pop("prune", False):
        kw.update(lengths_np=rng.integers(0, 11, size=keys.shape[0]).astype(np.int32),
                  prune_tau=2.0, betas_sum=1.0)
    got = tsharded.plan_capacities(keys, n_shards, **kw)
    want = jsharded.plan_capacities(keys, n_shards, **kw)
    assert dataclasses_dict(got) == dataclasses_dict(want)
    if case_name.startswith("past"):
        assert got.owner_route_cap == 0  # the uniform-hash bound took over


def dataclasses_dict(plan):
    import dataclasses

    return dataclasses.asdict(plan)


EDGE_IDS = np.array([0, 1, -1, 13, INT32_MIN, INT32_MAX, INT32_MIN + 1, HASH_TO_INT32_MIN,
                     PAD_ID, 8191, 8192, -8192], np.int32)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_pair_hash_np_and_shard_of_match_jax(n_shards):
    lo, hi = np.meshgrid(EDGE_IDS, EDGE_IDS)
    lo, hi = lo.reshape(-1), hi.reshape(-1)
    assert jsharded._positive_hash_np(np.array([HASH_TO_INT32_MIN], np.int32))[0] == INT32_MIN
    got = tsharded._pair_hash_np(lo, hi)
    want = jsharded._pair_hash_np(lo, hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got % n_shards, want % n_shards)
    # the device hashes agree with the host ones, shard destinations too
    t_pair = tsharded._pair_hash(torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(t_pair.numpy(), want)
    np.testing.assert_array_equal((t_pair % n_shards).numpy(), want % n_shards)
    t_key = tsharded._positive_hash(torch.as_tensor(EDGE_IDS))
    np.testing.assert_array_equal((t_key % n_shards).numpy(),
                                  jsharded._positive_hash_np(EDGE_IDS) % n_shards)
    assert int(t_key[EDGE_IDS == HASH_TO_INT32_MIN][0]) == INT32_MIN


@pytest.mark.parametrize("n", [8, 9, 11])
def test_pad_to_shards_matches_jax(n):
    rng = np.random.default_rng(n)
    places = rng.integers(0, 50, size=(n, 6)).astype(np.int32)
    lengths = rng.integers(1, 7, size=n).astype(np.int32)
    for shards in (1, 3, 4):
        got = tsharded.pad_to_shards(places, lengths, shards)
        want = jsharded.pad_to_shards(places, lengths, shards)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_mesh_collectives_match_numpy(n):
    mesh = compat.make_mesh((n,), ("ex",), devices=(CPU,) * n)
    rng = np.random.default_rng(n)
    cap = 5
    xs = [rng.integers(-9, 9, size=(n * cap, 2)).astype(np.int32) for _ in range(n)]
    got = mesh.all_to_all([torch.as_tensor(x) for x in xs])
    for j in range(n):
        want = np.concatenate([x.reshape(n, cap, 2)[j] for x in xs])
        np.testing.assert_array_equal(got[j].numpy(), want)
    ys = [rng.integers(0, 9, size=(3 + i, 2)).astype(np.int32) for i in range(n)]
    for g in mesh.all_gather([torch.as_tensor(y) for y in ys]):
        np.testing.assert_array_equal(g.numpy(), np.concatenate(ys))
    for g in mesh.pmax([torch.as_tensor(x) for x in xs]):
        np.testing.assert_array_equal(g.numpy(), np.maximum.reduce(xs))
    rows = mesh.shard_rows(torch.arange(4 * n))
    assert [r.tolist() for r in rows] == [list(range(4 * i, 4 * i + 4)) for i in range(n)]
    assert list(mesh.axis_index()) == list(range(n))


def test_shard_map_specs_and_mesh_refusals():
    mesh = compat.make_mesh((2,), ("ex",), devices=(CPU, CPU))
    P = compat.P
    fn = compat.shard_map(lambda a, t: ([x + t[i].sum() for i, x in enumerate(a)],),
                          mesh=mesh, in_specs=(P("ex", None), P(None)), out_specs=(P("ex"),))
    (out,) = fn(torch.arange(6).reshape(6, 1), torch.ones(3, dtype=torch.int64))
    assert out.shape == (2, 3, 1) and out.reshape(-1).tolist() == [3, 4, 5, 6, 7, 8]
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_rows(torch.arange(5))
    with pytest.raises(ValueError, match="one to three axes"):
        compat.make_mesh((2, 2, 2, 2), ("a", "b", "c", "d"), devices=(CPU,) * 16)
    with pytest.raises(ValueError, match="given 3 devices"):
        compat.make_mesh((2, 2), ("data", "model"), devices=(CPU,) * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            compat.make_mesh((2,), ("ex",))


def test_sharded_refusals(world):
    batch, forest = world
    sharded = ExecutionPlan(n_shards=4, devices=(CPU,) * 4)
    # autotuning runs; whatever the table holds, the untuned result
    tuned = AnotherMeEngine(forest, EngineConfig(), ExecutionPlan(n_shards=4, devices=(CPU,) * 4,
                                                                  autotune=True), device=CPU)
    untuned = AnotherMeEngine(forest, EngineConfig(), sharded, device=CPU)
    got, want = tuned.run(batch), untuned.run(batch)
    for f in SCORED_FIELDS:
        assert torch.equal(getattr(got.scored, f), getattr(want.scored, f)), f
    assert got.similar_pairs == want.similar_pairs and got.communities == want.communities
    # the streaming engine runs on the mesh, on both joins, and equals one shard
    stream = TrajectoryBatch(places=batch.places[:60], lengths=batch.lengths[:60],
                             user_id=batch.user_id[:60])
    cfg = EngineConfig(community_mode="components")
    one = StreamingEngine(forest, cfg, device=CPU).update(stream)
    for plan in (sharded, ExecutionPlan(n_shards=2, delta_join="device", devices=(CPU,) * 2)):
        got = StreamingEngine(forest, cfg, plan, device=CPU).update(stream)
        for f in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, f), getattr(one.scored, f)), (plan, f)
        assert got.similar_pairs == one.similar_pairs and got.communities == one.communities
    with pytest.raises(ValueError, match="no join keys"):
        AnotherMeEngine(forest, EngineConfig(), sharded, device=CPU,
                        backend=CallableBackend(lambda enc, b: None))
    with pytest.raises(ValueError, match="power of two"):
        ExecutionPlan(n_shards=4, overlap_chunks=3)
    with pytest.raises(ValueError, match="needs 4 devices"):
        AnotherMeEngine(forest, EngineConfig(), ExecutionPlan(n_shards=4, devices=(CPU,) * 2),
                        device=CPU).run(batch)
    # the join program runs on two shards: no keys in, empty slabs out
    join = tsharded.make_streaming_join_pipeline(compat.make_mesh((2,), ("ex",), devices=(CPU,) * 2),
                                                 tsharded.StreamJoinPlan(2, *[16] * 7))
    pad = torch.full((32,), PAD_KEY, dtype=torch.int32)
    out = join(pad, torch.full((32,), PAD_ID, dtype=torch.int32), pad,
               torch.full((32,), PAD_ID, dtype=torch.int32))
    assert out["left"].shape == (2, 16) and bool((out["left"] == PAD_ID).all())
    assert out["count"].tolist() == [0, 0] and int(out["overflow"].sum()) == 0
    with pytest.raises(ValueError, match="plan of 2 shards"):
        tsharded.make_streaming_join_pipeline(compat.make_mesh((1,), ("ex",), devices=(CPU,)),
                                              tsharded.StreamJoinPlan(2, *[16] * 7))
    if not torch.cuda.is_available():
        # the default mesh is the first n CUDA devices: none here
        with pytest.raises(ValueError, match="CUDA devices"):
            AnotherMeEngine(forest, EngineConfig(), ExecutionPlan(n_shards=2),
                            device=CPU).run(batch)
