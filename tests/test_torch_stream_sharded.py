"""The port's sharded streaming and serving against the JAX package's, on the CPU.

``StreamingEngine(..., ExecutionPlan(n_shards=4, devices=("cpu",) * 4))``
keeps its world as the round-robin places slab of an in-process mesh of four
CPU shards, on the host join (``BucketIndex`` pairs scored in per-shard
chunks) and on the device join (key-sharded slabs), in both score modes.  A
JAX subprocess (``conftest.run_subprocess``: four virtual CPU devices) feeds
the same seeded world through the JAX engines in five micro-batches (a TTL,
a window, a retire, a compaction whose first live row is not a multiple of
4) and dumps every update; the port runs the same plans here, tolerance 0,
at every update:

* the round-robin places slab, each shard's slab keys and rows, the sticky
  ``StreamShardPlan`` (host join), ``StreamJoinPlan`` and score caps
  (device join);
* the accumulated scored buffer slot by slot, the similar pairs, the
  communities and every stats entry but the times and ``driver_bytes_in``
  (each engine's own transfers); ``join_traces`` is held to at most the JAX
  count (the JAX engine traces a join plan again when the slab input
  changes sharding);
* every query's answer and serving counter over both sharded worlds, with
  ``serve_prune`` off and on; ``serve_traces`` and ``probe_traces`` are
  held to at most the JAX counts and to one build per plan (the JAX engine
  traces a program again when an input changes sharding: a REPOSE round's
  carried top-k that the program itself returned, a slab the join program
  returned);
* the scored buffer, similar pairs and communities also against the port's
  one-shard host-join stream of the same rows.

Fault injection (``REPRO_FAULT_INJECT=1``) runs on the device join.  In
process: ``plan_stream_capacities`` against the JAX planner on skewed pairs
at 3 and 8 shards, and the join and score programs at 2 shards against the
JAX programs on a two-device mesh, output by output.  The ``slow`` matrix
runs 2, 3 and 8 shards with every key backend on both joins.
"""
import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api.sharded as jsharded
import repro.data as jdata
from repro_torch.api import EngineConfig, ExecutionPlan, QueryEngine, StreamingEngine
from repro_torch.api import sharded as tsharded
from repro_torch.core import compat
from repro_torch.core.types import PAD_ID, PAD_KEY, TrajectoryBatch
from repro_torch.data import synthetic_setup

from conftest import run_subprocess

CPU = "cpu"
N = 200
WORLD = dict(num_types=6, classes_per_type=3, num_places=40, min_len=2, max_len=8, seed=41)
# micro-batch bounds off the multiples of 4: the first two batches expire at
# update 3 (a window of 3, a TTL of 2), the first live row is then 81, and
# the compaction rebases to 80 with row 80 (dead) resident
CUTS = [37, 81, 122, 160]
RETIRE_AFTER, RETIRED = 2, [40, 45, 50, 90, 101]
QUERY_ROWS = list(range(3, N, 23))
SCORED_FIELDS = ("left", "right", "level_lcs", "mss", "count", "overflow")
# stats that count what each engine ships, how long it took, or its traces
SKIP_STATS = ("compact_ms_total", "driver_bytes_in", "join_traces")
SKIP_QUERY_STATS = ("driver_bytes_in", "serve_traces", "probe_traces")


def case(n, join="host", mode="replicate", oc=1, prune=False, impl="fused", backend="ssh",
         cimpl="unionfind", fault=False, queries=False):
    # with the prune on, a rho the bound (betas_sum * min length) can miss
    return dict(n_shards=n, delta_join=join, score_mode=mode, overlap_chunks=oc,
                score_prune=prune, rho=4.5 if prune else 2.0, lcs_impl=impl,
                backend=backend, components_impl=cimpl, fault=fault, queries=queries)


TIER1 = {
    "host-replicate": case(4, queries=True),
    "host-shuffle1-prune-kernel": case(4, mode="shuffle", prune=True, impl="kernel", cimpl="jit"),
    "host-shuffle4": case(4, mode="shuffle", oc=4),
    "host-shuffle4-prune-minhash": case(4, mode="shuffle", oc=4, prune=True, backend="minhash"),
    "device-replicate-prune": case(4, join="device", prune=True, queries=True),
    "device-shuffle4-prune": case(4, join="device", mode="shuffle", oc=4, prune=True),
    "device-shuffle-kernel": case(4, join="device", mode="shuffle", impl="kernel", cimpl="jit"),
    "device-replicate-fault": case(4, join="device", fault=True, backend="minhash"),
    "device-shuffle-fault": case(4, join="device", mode="shuffle", fault=True),
}
SLOW = {
    f"n{n}-{b}-{j}-{m}{oc}": case(n, join=j, mode=m, oc=oc, backend=b, prune=(m == "shuffle"),
                                  queries=(m == "replicate"))
    for n in (2, 3, 8) for b in ("ssh", "minhash", "brp")
    for j, m, oc in (("host", "replicate", 1), ("host", "shuffle", 4),
                     ("device", "replicate", 1), ("device", "shuffle", 1))
}

JAX_DUMP = r"""
import os
# one thread a process: the dump runs beside the suite's other workers
os.environ["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
import repro.api as japi
import repro.api.sharded as js
import repro.data as jdata
from repro.core import compat
from repro.core.types import TrajectoryBatch

SPEC = json.loads(%(spec)r)
arrays, meta = {}, {}

def batch(p, ln):
    return TrajectoryBatch(places=jnp.asarray(p), lengths=jnp.asarray(ln),
                           user_id=jnp.arange(p.shape[0], dtype=jnp.int32))

jb, jf = jdata.synthetic_setup(SPEC["n"], **SPEC["world"])
places, lengths = np.asarray(jb.places), np.asarray(jb.lengths)
bounds = [0] + SPEC["cuts"] + [SPEC["n"]]
q = np.asarray(SPEC["query_rows"])
for name, c in SPEC["cases"].items():
    os.environ["REPRO_FAULT_INJECT"] = "1" if c["fault"] else "0"
    plan = japi.ExecutionPlan(n_shards=c["n_shards"], delta_join=c["delta_join"],
                              score_mode=c["score_mode"], overlap_chunks=c["overlap_chunks"])
    cfg = japi.EngineConfig(backend=c["backend"], score_prune=c["score_prune"], rho=c["rho"],
                            lcs_impl=c["lcs_impl"], community_mode="components")
    st = japi.StreamingEngine(jf, cfg, plan, components_impl=c["components_impl"], window=3)
    qes = [japi.QueryEngine(st, k=4, serve_prune=p) for p in (False, True)] if c["queries"] else []
    for u, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        w = max(int(lengths[a:b].max()), 1)
        res = st.update(batch(places[a:b, :w], lengths[a:b]), ttl=2 if u == 1 else None)
        key = f"{name}/{u}"
        for f in ("left", "right", "level_lcs", "mss", "count", "overflow"):
            arrays[f"{key}/scored/{f}"] = np.asarray(getattr(res.scored, f))
        arrays[f"{key}/places"] = np.asarray(st._places_dev)
        if st._slab_keys is not None:
            arrays[f"{key}/slab_keys"] = np.asarray(st._slab_keys)
            arrays[f"{key}/slab_rows"] = np.asarray(st._slab_rows)
        m = dict(similar=sorted(map(list, res.similar_pairs)),
                 communities=sorted(sorted(x) for x in res.communities),
                 stats={k: v for k, v in res.stats.items() if not k.startswith("t_")},
                 stream_plan=st._stream_plan and dataclasses.asdict(st._stream_plan),
                 join_plan=st._join_plan and dataclasses.asdict(st._join_plan),
                 score_caps=st._score_caps, base=st._base, queries=[])
        if u == SPEC["retire_after"]:
            m["retired"] = st.retire(SPEC["retired"])
        for qe in qes:
            r = qe.query(batch(places[q], lengths[q]))
            arrays[f"{key}/query{qe.serve_prune:d}/ids"] = r.match_ids
            arrays[f"{key}/query{qe.serve_prune:d}/mss"] = r.mss
            m["queries"].append(r.stats)
        meta[key] = m
# the join and score programs on two devices, for the in-process checks
if SPEC["programs"]:
    inputs = np.load(%(path)r + "-programs-in.npz")
    mesh = compat.make_mesh((2,), ("ex",), devices=jax.devices()[:2])
    jplan = js.StreamJoinPlan(**SPEC["programs"]["join_plan"])
    out = js.make_streaming_join_pipeline(mesh, jplan)(
        *(jnp.asarray(inputs[k]) for k in ("slab_keys", "slab_rows", "keys", "rows")))
    for f, v in out.items():
        arrays[f"programs/join/{f}"] = np.asarray(v)
    eng = japi.StreamingEngine(jf, japi.EngineConfig(rho=4.5))
    for tag, p in SPEC["programs"]["score_plans"].items():
        fn = js.make_streaming_score_pipeline(
            mesh, js.StreamShardPlan(**p["plan"]), betas=eng.betas, score_mode=p["mode"],
            lcs_impl="fused", score_prune=True, prune_tau=4.5)
        out = fn(jnp.asarray(inputs["world"]), jnp.asarray(inputs["left"]),
                 jnp.asarray(inputs["right"]), eng.tables)
        for f, v in out.items():
            arrays[f"programs/{tag}/{f}"] = np.asarray(v)
np.savez(%(path)r + ".npz", **arrays)
with open(%(path)r + ".json", "w") as fh:
    json.dump(meta, fh)
print("OK")
"""


# ---------------------------------------------------------------------------
# the two-shard programs' inputs (built here, run by both packages)
# ---------------------------------------------------------------------------
JOIN_PLAN = dict(n_shards=2, slab_cap=64, key_in_cap=32, key_route_cap=32, nn_cap=256,
                 no_cap=256, pair_route_cap=256, pair_cap=256)
SCORE_PLANS = {
    "replicate": dict(mode="replicate", plan=dict(n_shards=2, cap_local=32, pair_cap=32,
                                                  hop_cap=0, out_cap=32)),
    "shuffle": dict(mode="shuffle", plan=dict(n_shards=2, cap_local=32, pair_cap=32,
                                              hop_cap=32, out_cap=32)),
    "shuffle-chunks": dict(mode="shuffle", plan=dict(n_shards=2, cap_local=32, pair_cap=32,
                                                     hop_cap=16, out_cap=16, n_chunks=2)),
}


def program_inputs():
    """Seeded inputs of the two-shard programs: each shard's sorted slab of
    the keys it owns (with tombstones), PAD-padded incoming chunks, a
    round-robin world slab of 40 rows, and pairs in per-shard slices."""
    rng = np.random.default_rng(7)
    slabs = []
    for s in range(2):
        ent = []
        while len(ent) < 20:
            k = int(rng.integers(-4, 12))
            if int(tsharded._positive_hash_np(np.array([k], np.int32))[0]) % 2 == s:
                ent.append((k, len(ent) * 2 + s if rng.random() > 0.2 else PAD_ID))
        ent.sort(key=lambda kr: kr[0])
        kk = np.full(64, PAD_KEY, np.int32)
        rr = np.full(64, PAD_ID, np.int32)
        kk[:20], rr[:20] = np.array(ent, np.int64).T
        slabs.append((kk, rr))
    keys = np.full(64, PAD_KEY, np.int32)
    rows = np.full(64, PAD_ID, np.int32)
    for s, n in ((0, 25), (1, 19)):
        keys[32 * s:32 * s + n] = rng.integers(-4, 12, size=n)
        rows[32 * s:32 * s + n] = 40 + 32 * s + np.arange(n)
    jb, _ = jdata.synthetic_setup(40, **WORLD)
    places = np.asarray(jb.places)
    g = np.arange(64)
    world = np.full((64, places.shape[1]), -1, np.int32)
    world[(g[:40] % 2) * 32 + g[:40] // 2] = places
    pairs = np.sort(rng.integers(0, 40, size=(50, 2)), axis=1).astype(np.int32)
    left = np.full(64, PAD_ID, np.int32)
    right = np.full(64, PAD_ID, np.int32)
    for s, seg in ((0, slice(0, 25)), (1, slice(25, 50))):
        left[32 * s:32 * s + 25], right[32 * s:32 * s + 25] = pairs[seg, 0], pairs[seg, 1]
    return dict(slab_keys=np.concatenate([k for k, _ in slabs]),
                slab_rows=np.concatenate([r for _, r in slabs]),
                keys=keys, rows=rows, world=world, left=left, right=right)


def jax_dump(path, cases, devices, programs, parts=3):
    """Run the JAX dump in ``parts`` concurrent subprocesses and merge."""
    names = list(cases)
    shares = [names[i::parts] for i in range(parts)]
    if programs:
        np.savez(f"{path}-0-programs-in.npz", **program_inputs())

    def dump(i):
        spec = json.dumps({
            "n": N, "world": WORLD, "cuts": CUTS, "retire_after": RETIRE_AFTER,
            "retired": RETIRED, "query_rows": QUERY_ROWS,
            "cases": {k: cases[k] for k in shares[i]},
            "programs": (dict(join_plan=JOIN_PLAN, score_plans=SCORE_PLANS)
                         if programs and i == 0 else None),
        })
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
    """Many short ops on small tensors: one torch thread, so the suite's
    parallel workers do not oversubscribe the cores (as test_torch_sharded)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tier1(tmp_path_factory):
    return jax_dump(tmp_path_factory.mktemp("stream_sharded") / "tier1", TIER1, 4, True)


@pytest.fixture(scope="module")
def slow_dump(tmp_path_factory):
    return jax_dump(tmp_path_factory.mktemp("stream_sharded") / "slow", SLOW, 8, False)


@pytest.fixture(scope="module")
def world():
    jb, _ = jdata.synthetic_setup(N, **WORLD)
    _, tf = synthetic_setup(N, device=CPU, **WORLD)
    return np.asarray(jb.places), np.asarray(jb.lengths), tf


def tbatch(p, ln):
    return TrajectoryBatch(places=torch.tensor(p), lengths=torch.tensor(ln),
                           user_id=torch.arange(p.shape[0], dtype=torch.int32))


def micro_batches(places, lengths):
    bounds = [0] + CUTS + [N]
    for a, b in zip(bounds[:-1], bounds[1:]):
        w = max(int(lengths[a:b].max()), 1)
        yield np.ascontiguousarray(places[a:b, :w]), lengths[a:b].copy()


def config(c):
    return EngineConfig(backend=c["backend"], score_prune=c["score_prune"], rho=c["rho"],
                        lcs_impl=c["lcs_impl"], community_mode="components")


_ONE_SHARD: dict = {}


def one_shard(world, c):
    """The port's one-shard host-join results, update by update (cached)."""
    key = (c["backend"], c["score_prune"], c["rho"])
    if key not in _ONE_SHARD:
        places, lengths, tf = world
        st = StreamingEngine(tf, config(c), components_impl="unionfind", window=3, device=CPU)
        results = []
        for u, (p, ln) in enumerate(micro_batches(places, lengths)):
            results.append(st.update(tbatch(p, ln), ttl=2 if u == 1 else None))
            if u == RETIRE_AFTER:
                st.retire(RETIRED)
        _ONE_SHARD[key] = results
    return _ONE_SHARD[key]


def assert_exact(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def check_case(name, c, dump, world, monkeypatch):
    arrays, meta = dump
    places, lengths, tf = world
    monkeypatch.setenv("REPRO_FAULT_INJECT", "1" if c["fault"] else "0")
    n = c["n_shards"]
    plan = ExecutionPlan(n_shards=n, devices=(CPU,) * n, delta_join=c["delta_join"],
                         score_mode=c["score_mode"], overlap_chunks=c["overlap_chunks"])
    st = StreamingEngine(tf, config(c), plan, components_impl=c["components_impl"], window=3,
                         device=CPU)
    qes = ([QueryEngine(st, k=4, serve_prune=p) for p in (False, True)]
           if c["queries"] else [])
    ref = one_shard(world, c)
    q = np.asarray(QUERY_ROWS)
    retries = 0
    for u, (p, ln) in enumerate(micro_batches(places, lengths)):
        res = st.update(tbatch(p, ln), ttl=2 if u == 1 else None)
        key, want = f"{name}/{u}", meta[f"{name}/{u}"]
        for f in SCORED_FIELDS:
            assert_exact(getattr(res.scored, f), arrays[f"{key}/scored/{f}"], f"{key} scored {f}")
        assert sorted(map(list, res.similar_pairs)) == want["similar"], key
        assert sorted(sorted(x) for x in res.communities) == want["communities"], key
        stats = {k: v for k, v in res.stats.items() if not k.startswith("t_")}
        assert {k: v for k, v in stats.items() if k not in SKIP_STATS} == \
            {k: v for k, v in want["stats"].items() if k not in SKIP_STATS}, key
        assert set(stats) == set(want["stats"]), key
        assert stats["join_traces"] <= want["stats"]["join_traces"], key
        assert_exact(st._places_dev, arrays[f"{key}/places"], f"{key} places slab")
        if c["delta_join"] == "device":
            assert_exact(st._slab_keys, arrays[f"{key}/slab_keys"], f"{key} slab keys")
            assert_exact(st._slab_rows, arrays[f"{key}/slab_rows"], f"{key} slab rows")
            assert stats["driver_pair_rows"] == 0 and stats["host_index_entries"] == 0
            retries += st.join_timing["attempts"] - 1 if st.join_timing["attempts"] else 0
        assert (st._stream_plan and dataclasses.asdict(st._stream_plan)) == want["stream_plan"]
        assert (st._join_plan and dataclasses.asdict(st._join_plan)) == want["join_plan"]
        assert (list(st._score_caps) if st._score_caps else None) == want["score_caps"]
        assert st._base == want["base"], key
        # against the port's one-shard stream of the same rows
        one = ref[u]
        for f in ("left", "right", "level_lcs", "mss", "count"):
            assert torch.equal(getattr(res.scored, f), getattr(one.scored, f)), (key, f)
        assert res.similar_pairs == one.similar_pairs and res.communities == one.communities
        if u == RETIRE_AFTER:
            assert st.retire(RETIRED) == want["retired"]
        for qe, qstats in zip(qes, want["queries"]):
            r = qe.query(tbatch(places[q], lengths[q]))
            tag = f"{key}/query{qe.serve_prune:d}"
            assert_exact(r.match_ids, arrays[f"{tag}/ids"], f"{tag} ids")
            assert_exact(r.mss, arrays[f"{tag}/mss"], f"{tag} mss")
            assert {k: v for k, v in r.stats.items() if k not in SKIP_QUERY_STATS} == \
                {k: v for k, v in qstats.items() if k not in SKIP_QUERY_STATS}, tag
            assert set(r.stats) == set(qstats), tag
            for k in ("serve_traces", "probe_traces"):
                assert r.stats[k] <= qstats[k], (tag, k)
            assert r.stats["serve_traces"] + r.stats["probe_traces"] == r.stats["runner_builds"]
    assert st.compactions >= 1 and st._base % n == 0 and st._base > 0
    assert res.stats["retired_total"] > 0 and res.stats["join_overflow"] == 0
    if c["fault"]:
        assert retries > 0, "fault injection fired no join retry"
    if c["score_prune"]:
        assert sum(meta[f"{name}/{u}"]["stats"]["num_pruned"] for u in range(5)) > 0
    return st


@pytest.mark.parametrize("name", list(TIER1))
def test_stream_matches_jax_shard_by_shard(name, tier1, world, monkeypatch):
    check_case(name, TIER1[name], tier1, world, monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW))
def test_stream_matrix_matches_jax(name, slow_dump, world, monkeypatch):
    check_case(name, SLOW[name], slow_dump, world, monkeypatch)


def test_compaction_base_is_a_multiple_of_the_shards(tier1, world, monkeypatch):
    """The first two batches expire with row 81 the first live one: the
    base moves to 80, the dead row 80 stays resident, and every live row
    keeps its owner shard (its slot in the rolled slab holds its places)."""
    st = check_case("device-replicate-prune", TIER1["device-replicate-prune"], tier1, world,
                    monkeypatch)
    places, _, _ = world
    live = np.nonzero(st._alive_np[: st.n - st._base])[0]
    assert st._base == 80 and live[0] == 1 and not st._alive_np[0]
    slab = st._places_dev.numpy()
    cl, w = st._cap // 4, min(st.L, places.shape[1])
    for g in live:
        np.testing.assert_array_equal(slab[(g % 4) * cl + g // 4][:w], places[st._base + g][:w])


# ---------------------------------------------------------------------------
# in-process: the planner, and the two-shard programs output by output
# ---------------------------------------------------------------------------
def skewed_pairs(rng, p, n_rows, hot=0.4):
    """Deduped (lo, hi) pairs where a hot row takes ``hot`` of them."""
    a = rng.integers(0, n_rows, size=p)
    b = rng.integers(0, n_rows, size=p)
    a[rng.random(p) < hot] = 5
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    ok = lo != hi
    packed = np.unique((lo[ok].astype(np.int64) << 32) | hi[ok])
    return (packed >> 32).astype(np.int32), (packed & 0xFFFFFFFF).astype(np.int32)


@pytest.mark.parametrize("n_shards", [3, 8])
@pytest.mark.parametrize("kw", [
    dict(), dict(score_mode="shuffle"), dict(score_mode="shuffle", overlap_chunks=4),
    dict(score_mode="shuffle", overlap_chunks=2, pair_cap_floor=256),
    dict(score_mode="shuffle", windows_per_row=3), dict(score_mode="shuffle", empty=True),
], ids=["replicate", "shuffle", "chunks", "sticky-floor", "windows", "empty"])
def test_plan_stream_capacities_matches_jax(n_shards, kw):
    kw = dict(kw)
    rng = np.random.default_rng(n_shards + 7 * len(kw))
    lo, hi = skewed_pairs(rng, 0 if kw.pop("empty", False) else 400, 120)
    got = tsharded.plan_stream_capacities(lo, hi, n_shards, 64, **kw)
    want = jsharded.plan_stream_capacities(lo, hi, n_shards, 64, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pair_cap % got.n_chunks == 0


def test_join_program_two_shards_matches_jax(tier1):
    arrays, _ = tier1
    inp = program_inputs()
    mesh = compat.make_mesh((2,), ("ex",), devices=(CPU, CPU))
    out = tsharded.make_streaming_join_pipeline(mesh, tsharded.StreamJoinPlan(**JOIN_PLAN))(
        *(torch.tensor(inp[k]) for k in ("slab_keys", "slab_rows", "keys", "rows")))
    assert set(out) == {k.split("/")[-1] for k in arrays if k.startswith("programs/join/")}
    for f, v in out.items():
        assert_exact(v, arrays[f"programs/join/{f}"], f"join {f}")
    assert int(out["count"].sum()) > 0 and int(out["examined"].sum()) > 0


@pytest.mark.parametrize("tag", list(SCORE_PLANS))
def test_score_program_two_shards_matches_jax(tag, tier1, world):
    arrays, _ = tier1
    inp = program_inputs()
    _, _, tf = world
    eng = StreamingEngine(tf, EngineConfig(rho=4.5), device=CPU)
    mesh = compat.make_mesh((2,), ("ex",), devices=(CPU, CPU))
    spec = SCORE_PLANS[tag]
    fn = tsharded.make_streaming_score_pipeline(
        mesh, tsharded.StreamShardPlan(**spec["plan"]), betas=eng.betas, score_mode=spec["mode"],
        lcs_impl="fused", score_prune=True, prune_tau=4.5)
    out = fn(*(torch.tensor(inp[k]) for k in ("world", "left", "right")), eng.tables)
    for f, v in out.items():
        assert_exact(v, arrays[f"programs/{tag}/{f}"], f"{tag} {f}")
    assert int(out["pruned"].sum()) > 0 and int((out["left"] != PAD_ID).sum()) > 0
