"""The port's top-k query serving against the JAX ``QueryEngine``, on the CPU.

The same numpy worlds go through a JAX streaming engine and the port's
(``device="cpu"``), and the same query batches through both
``QueryEngine``s: ``match_ids`` equal and float32 ``mss`` bit-equal
(tolerance 0), with ties, ``k`` beyond the world, per-query ``k`` and
``rho``, empty and keyless queries, ``serve_prune`` on and off, and queries
interleaved with updates, retires and compactions.  The JAX engines run
``lcs_impl="wavefront"`` (their own suite pins every impl to it); the port
runs each of its impl families.  The port's result is also held to a
whole-world brute force, and its segmented top-k to a numpy reference.
Over a device-join world (``delta_join="device"``) every answer equals the
JAX engine's and the port's host-join world's, the host ``BucketIndex`` is
never probed, and the slab probe and the places-slab score function equal
the JAX programs output by output.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.api as japi
import repro.api.serving as jserving
import repro.data as jdata
from repro.core.types import TrajectoryBatch as JBatch
from repro_torch.api import (
    CapacityPlanner, EngineConfig, ExecutionPlan, QueryEngine, StreamingEngine,
)
from repro_torch.api import serving as tserving
from repro_torch.core import device_index as tdi
from repro_torch.core.encoding import encode_codes
from repro_torch.core.similarity import mss_scores, multi_level_lcs
from repro_torch.core.types import PAD_ID, PAD_PLACE, TrajectoryBatch
from repro_torch.data import synthetic_setup

CPU = "cpu"
RHO = 1.0
WORLD = dict(num_types=5, classes_per_type=3, num_places=30, min_len=2, max_len=8)


def world(seed=0, n=24):
    jb, jf = jdata.synthetic_setup(n, seed=seed, **WORLD)
    _, tf = synthetic_setup(n, seed=seed, device=CPU, **WORLD)
    return np.asarray(jb.places), np.asarray(jb.lengths), jf, tf


def jbatch(p, ln):
    return JBatch(places=jnp.asarray(p), lengths=jnp.asarray(ln),
                  user_id=jnp.arange(p.shape[0], dtype=jnp.int32))


def tbatch(p, ln):
    return TrajectoryBatch(places=torch.tensor(p), lengths=torch.tensor(ln),
                           user_id=torch.arange(p.shape[0], dtype=torch.int32))


class Pair:
    """A JAX and a port streaming engine fed alike, and a QueryEngine over
    each; ``query`` asserts the two answers equal and returns the port's."""

    def __init__(self, jf, tf, impl="wavefront", serve_prune=False, k=5, **kw):
        cfg = dict(rho=RHO, k=1)  # k=1 shingles: every pair with mss > 0 is a candidate
        self.js = japi.StreamingEngine(jf, japi.EngineConfig(**cfg), **kw)
        self.ts = StreamingEngine(tf, EngineConfig(lcs_impl=impl, **cfg), device=CPU, **kw)
        self.jq = japi.QueryEngine(self.js, k=k, serve_prune=serve_prune)
        self.tq = QueryEngine(self.ts, k=k, serve_prune=serve_prune)

    def update(self, p, ln):
        self.js.update(jbatch(p, ln))
        self.ts.update(tbatch(p, ln))

    def retire(self, ids):
        assert self.ts.retire(ids) == self.js.retire(ids)

    def query(self, p, ln, **kw):
        got = self.tq.query(tbatch(p, ln), **kw)
        want = self.jq.query(jbatch(p, ln), **kw)
        assert got.match_ids.dtype == want.match_ids.dtype == np.int32
        assert got.mss.dtype == want.mss.dtype == np.float32
        np.testing.assert_array_equal(got.match_ids, want.match_ids)
        np.testing.assert_array_equal(got.mss, want.mss)
        assert got.stats == want.stats
        return got


def brute_topk(stream, q_places, q_lengths, k_vec, rho_vec):
    """The port's own whole-world brute force: every query against every
    live row, ranked by (mss desc, row asc)."""
    span = stream.n - stream._base
    live = np.nonzero(stream._alive_np[:span])[0]
    codes = stream._codes_dev[live]
    lens = stream._len_dev[live]
    L = max(codes.shape[-1], q_places.shape[1])
    codes = torch.nn.functional.pad(codes, (0, L - codes.shape[-1]), value=-1)
    qp = np.full((q_places.shape[0], L), PAD_PLACE, np.int32)
    qp[:, : q_places.shape[1]] = q_places
    qc = encode_codes(torch.tensor(qp), stream.tables)
    out = []
    for q in range(qc.shape[0]):
        n = len(live)
        lvl = multi_level_lcs(qc[q:q + 1].expand(n, -1, -1),
                              torch.full((n,), int(q_lengths[q]), dtype=torch.int32), codes, lens)
        mss = mss_scores(lvl, stream.betas).numpy()
        order = sorted(range(n), key=lambda r: (-mss[r], live[r]))
        out.append([(int(live[r] + stream._base), np.float32(mss[r])) for r in order
                    if mss[r] > rho_vec[q]][: int(k_vec[q])])
    return out


def lists(res):
    return [[(int(r), m) for r, m in zip(ids, mss) if r != PAD_ID]
            for ids, mss in zip(res.match_ids, res.mss)]


@pytest.mark.parametrize("serve_prune", [False, True])
@pytest.mark.parametrize("impl", ["wavefront", "ref", "fused", "kernel"])
def test_topk_matches_jax_and_brute_force(impl, serve_prune):
    places, lengths, jf, tf = world()
    pair = Pair(jf, tf, impl, serve_prune)
    pair.update(places, lengths)
    res = pair.query(places[3:9], lengths[3:9])
    assert lists(res) == brute_topk(pair.ts, places[3:9], lengths[3:9],
                                    np.full(6, 5), np.full(6, RHO, np.float32))
    assert np.all(res.mss[res.match_ids == PAD_ID] == np.float32(-1.0))


def test_ties_break_toward_smaller_row_id():
    places, lengths, jf, tf = world(seed=3, n=8)
    pair = Pair(jf, tf, "fused", k=6)
    pair.update(np.concatenate([places, places]), np.concatenate([lengths, lengths]))
    res = pair.query(places[:4], lengths[:4])
    for q in range(4):
        assert [r for r, _ in lists(res)[q][:2]] == [q, q + 8]


@pytest.mark.parametrize("serve_prune", [False, True])
def test_k_beyond_world_and_per_query_k_rho(serve_prune):
    places, lengths, jf, tf = world(n=10)
    pair = Pair(jf, tf, "fused", serve_prune, k=3)
    pair.update(places, lengths)
    k_vec = np.array([50, 0, 1, 3])
    rho_vec = np.array([RHO, RHO, 1e9, 0.5], np.float32)
    res = pair.query(places[:4], lengths[:4], k=k_vec, rho=rho_vec)
    want = brute_topk(pair.ts, places[:4], lengths[:4], k_vec, rho_vec)
    assert lists(res) == want and want[0] and want[1] == [] == want[2]
    assert res.match_ids.shape == (4, 50)
    assert np.all(res.match_ids[1] == PAD_ID) and np.all(res.match_ids[3][3:] == PAD_ID)


def test_empty_and_keyless_queries():
    places, lengths, jf, tf = world(n=12)
    pair = Pair(jf, tf, "fused", k=3)
    empty = pair.query(np.zeros((0, 4), np.int32), np.zeros((0,), np.int32))
    assert empty.match_ids.shape == (0, 0)  # k_max of no queries is 0
    qp, ql = places[:3].copy(), lengths[:3].copy()  # before any update: empty world
    assert np.all(pair.query(qp, ql).match_ids == PAD_ID)
    pair.update(places, lengths)
    qp[1], ql[1] = 0, 0
    res = pair.query(qp, ql)
    assert lists(res)[1] == [] and lists(res)[0]
    res = pair.query(np.zeros((2, 4), np.int32), np.zeros((2,), np.int32))
    assert np.all(res.match_ids == PAD_ID)


@pytest.mark.parametrize("impl", ["wavefront", "fused"])
def test_queries_interleave_with_updates_retires_and_compaction(impl):
    """Queries mutate nothing, see the world as of each call, and speak
    global ids after compaction moved the base."""
    places, lengths, jf, tf = world(n=40)
    pair = Pair(jf, tf, impl, serve_prune=True, k=4, window=2)
    qp, ql = places[2:8], lengths[2:8]
    for lo, hi in ((0, 12), (12, 24), (24, 32), (32, 40)):
        pair.update(places[lo:hi], lengths[lo:hi])
        before = (pair.ts.n, pair.ts._index.num_rows, pair.ts._index.pairs_examined_total,
                  pair.ts._acc_n, pair.ts._codes_dev.clone())
        res = pair.query(qp, ql)
        after = (pair.ts.n, pair.ts._index.num_rows, pair.ts._index.pairs_examined_total,
                 pair.ts._acc_n, pair.ts._codes_dev)
        assert before[:4] == after[:4] and torch.equal(before[4], after[4])
        assert lists(res) == brute_topk(pair.ts, qp, ql, np.full(6, 4),
                                        np.full(6, RHO, np.float32))
        if hi == 24:
            pair.retire([13, 20, 21])
    assert pair.ts._base > 0 and pair.ts.compactions == pair.js.compactions
    assert res.stats["world_size"] == 40


def test_local_topk_matches_numpy_and_jax():
    rng = np.random.default_rng(1)
    q_cap, k_cap, m = 8, 4, 64
    for trial in range(5):
        qid = rng.integers(0, q_cap, size=m).astype(np.int32)
        row = rng.integers(0, 10, size=m).astype(np.int32)
        mss = (rng.integers(0, 5, size=m) / 2.0).astype(np.float32)
        row[rng.random(m) < 0.3] = PAD_ID
        rho = np.full(q_cap, 0.4, np.float32)
        key = qid.astype(np.int64) * 1000 + row
        uniq, first = np.unique(key, return_index=True)
        mss = mss[first][np.searchsorted(uniq, key)]  # duplicates share a score
        t_row, t_neg = tserving._local_topk(
            torch.tensor(qid), torch.tensor(row), torch.tensor(mss),
            q_cap=q_cap, k_cap=k_cap, rho_vec=torch.tensor(rho))
        j_row, j_neg = jserving._local_topk(
            jnp.asarray(qid), jnp.asarray(row), jnp.asarray(mss),
            q_cap=q_cap, k_cap=k_cap, rho_vec=jnp.asarray(rho))
        np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row))
        np.testing.assert_array_equal(t_neg.numpy(), np.asarray(j_neg))
        for q in range(q_cap):
            cand = {int(r): float(s) for qi, r, s in zip(qid, row, mss)
                    if qi == q and r != PAD_ID and s > rho[q]}
            want = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))[:k_cap]
            got = [(int(r), float(-s)) for r, s in zip(t_row[q].tolist(), t_neg[q].tolist())
                   if r != PAD_ID]
            assert got == want, (trial, q)


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(2)
    for trial in range(5):
        rows = rng.integers(0, 6, size=(5, 12)).astype(np.int32)
        rows[rng.random(rows.shape) < 0.3] = PAD_ID
        negs = -(rows % 3).astype(np.float32)  # a row carries one score everywhere
        negs[rows == PAD_ID] = np.inf
        got = tserving._merge_topk(torch.tensor(rows), torch.tensor(negs), k_cap=4)
        want = jserving._merge_topk(jnp.asarray(rows), jnp.asarray(negs), k_cap=4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_query_plans_match_jax():
    rng = np.random.default_rng(4)
    prev_t = prev_j = None
    for trial in range(6):
        kw = dict(n_shards=1, cap_local=int(2 ** rng.integers(4, 8)), world_L=int(rng.integers(1, 9)),
                  q_len_max=int(rng.integers(1, 12)), cand_total=int(rng.integers(0, 300)))
        q, k = int(rng.integers(0, 40)), int(rng.integers(0, 20))
        got = CapacityPlanner().plan_query(q, k, **kw)
        want = japi.CapacityPlanner().plan_query(q, k, **kw)
        assert dataclasses_equal(got, want)
        prev_t = tserving.sticky_query_plan(got, prev_t)
        prev_j = jserving.sticky_query_plan(want, prev_j)
        assert dataclasses_equal(prev_t, prev_j)
    keys = rng.integers(0, 9, size=20).astype(np.int32)
    from repro.core.device_index import StreamJoinStats as JStats

    t_stats, j_stats = tdi.StreamJoinStats(2), JStats(2)
    for st in (t_stats, j_stats):
        st.commit(keys[:12], np.zeros(12, np.int64))
    got = tserving.plan_query_capacities(5, 3, n_shards=2, cap_local=16, world_L=6, q_len_max=4,
                                         keys_flat=keys[12:], stats=t_stats)
    want = jserving.plan_query_capacities(5, 3, n_shards=2, cap_local=16, world_L=6, q_len_max=4,
                                          keys_flat=keys[12:], stats=j_stats)
    assert dataclasses_equal(got, want)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_refusals():
    """The probe follows the world's join; the probe and score programs run
    on two shards, and the answers over two-shard worlds (both joins) equal
    the one-shard world's."""
    places, lengths, jf, tf = world(n=6)
    stream = StreamingEngine(tf, EngineConfig(rho=RHO), device=CPU)
    assert isinstance(QueryEngine(stream)._prober, tserving._HostProber)
    dev = StreamingEngine(tf, EngineConfig(rho=RHO), ExecutionPlan(delta_join="device"), device=CPU)
    assert isinstance(QueryEngine(dev)._prober, tserving._SlabProber)
    places, lengths, jf, tf = world(n=20)
    cfg = EngineConfig(rho=RHO, k=1)
    one = StreamingEngine(tf, cfg, device=CPU)
    one.update(tbatch(places, lengths))
    want = QueryEngine(one, k=4).query(tbatch(places[:5], lengths[:5]))
    for join in ("host", "device"):
        two = StreamingEngine(tf, cfg, ExecutionPlan(n_shards=2, devices=(CPU,) * 2,
                                                     delta_join=join), device=CPU)
        two.update(tbatch(places, lengths))
        for prune in (False, True):
            got = QueryEngine(two, k=4, serve_prune=prune).query(tbatch(places[:5], lengths[:5]))
            np.testing.assert_array_equal(got.match_ids, want.match_ids)
            np.testing.assert_array_equal(got.mss, want.mss)
            assert got.stats["rounds_run"] + got.stats["rounds_skipped"] == (2 if prune else 1)
    assert (want.match_ids != PAD_ID).any()


# ---------------------------------------------------------------------------
# serving over the device join's slab
# ---------------------------------------------------------------------------
class DevicePair(Pair):
    """``Pair`` over two device-join streams (the JAX one and the port's),
    with the port's host-join stream beside them: every answer also equals
    the host join's."""

    def __init__(self, jf, tf, impl="wavefront", serve_prune=False, k=5, **kw):
        cfg = dict(rho=RHO, k=1)
        self.js = japi.StreamingEngine(jf, japi.EngineConfig(**cfg),
                                       japi.ExecutionPlan(delta_join="device"), **kw)
        self.ts = StreamingEngine(tf, EngineConfig(lcs_impl=impl, **cfg),
                                  ExecutionPlan(delta_join="device"), device=CPU, **kw)
        self.hs = StreamingEngine(tf, EngineConfig(lcs_impl=impl, **cfg), device=CPU, **kw)
        self.jq = japi.QueryEngine(self.js, k=k, serve_prune=serve_prune)
        self.tq = QueryEngine(self.ts, k=k, serve_prune=serve_prune)
        self.hq = QueryEngine(self.hs, k=k, serve_prune=serve_prune)

    def update(self, p, ln):
        super().update(p, ln)
        self.hs.update(tbatch(p, ln))

    def retire(self, ids):
        super().retire(ids)
        self.hs.retire(ids)

    def query(self, p, ln, **kw):
        got = super().query(p, ln, **kw)
        host = self.hq.query(tbatch(p, ln), **kw)
        np.testing.assert_array_equal(got.match_ids, host.match_ids)
        np.testing.assert_array_equal(got.mss, host.mss)
        assert got.stats["candidates"] <= host.stats["candidates"]
        return got


@pytest.mark.parametrize("impl,serve_prune", [
    ("wavefront", False), ("fused", False), ("fused", True), ("kernel", True),
])
def test_device_join_topk_matches_jax(monkeypatch, impl, serve_prune):
    """Queries over the slab equal the JAX device join's and the host join's
    answers, per-query k and rho included, interleaved with updates, a
    retire and compactions; the host BucketIndex is never probed."""
    import repro.core.stream_index as jsi
    from repro_torch.core import stream_index as tsi

    places, lengths, jf, tf = world(n=40)
    pair = DevicePair(jf, tf, impl, serve_prune, k=4, window=2)

    def never(*a, **kw):
        raise AssertionError("BucketIndex.probe called on a device-join world")

    qp, ql = places[2:8], lengths[2:8]
    k_vec = np.array([1, 2, 3, 0, 9, 4])
    rho_vec = np.array([0.5, 1, 1, 1, 2, 0.1], np.float32)
    for lo, hi in ((0, 12), (12, 24), (24, 32), (32, 40)):
        pair.update(places[lo:hi], lengths[lo:hi])
        with monkeypatch.context() as m:
            m.setattr(jsi.BucketIndex, "probe", never)
            m.setattr(tsi.BucketIndex, "probe", never)
            before = (pair.ts._slab_keys.clone(), pair.ts._slab_rows.clone(),
                      dict(pair.ts._join_stats.counts))
            res = pair.tq.query(tbatch(qp, ql))
            want = pair.jq.query(jbatch(qp, ql))
            np.testing.assert_array_equal(res.match_ids, want.match_ids)
            np.testing.assert_array_equal(res.mss, want.mss)
            assert res.stats == want.stats
            assert torch.equal(before[0], pair.ts._slab_keys)
            assert torch.equal(before[1], pair.ts._slab_rows)
            assert before[2] == pair.ts._join_stats.counts
        pair.query(qp, ql, k=k_vec, rho=rho_vec)
        if hi == 24:
            pair.retire([13, 20, 21])
    assert pair.ts._base > 0 and pair.ts.compactions == pair.js.compactions
    assert pair.ts._index.num_keys_inserted == 0 and res.stats["probe_traces"] >= 1


def test_device_probe_and_score_functions_match_jax():
    """The probe and the places-slab score function, output by output,
    against the JAX programs on a one-device mesh."""
    import jax

    from repro.core import compat

    mesh = compat.make_mesh((1,), ("ex",), devices=jax.devices()[:1])
    places, lengths, jf, tf = world(n=24)
    ts = StreamingEngine(tf, EngineConfig(rho=RHO, k=1), ExecutionPlan(delta_join="device"),
                         device=CPU)
    js = japi.StreamingEngine(jf, japi.EngineConfig(rho=RHO, k=1),
                              japi.ExecutionPlan(delta_join="device"))
    ts.update(tbatch(places, lengths))
    js.update(jbatch(places, lengths))
    keys = ts._new_row_keys(places[:5], lengths[:5])
    k_flat, q_flat = tdi.flat_row_keys(keys)
    plan = tserving.plan_query_capacities(5, 3, n_shards=1, cap_local=ts._cap, world_L=ts.L,
                                          q_len_max=int(lengths[:5].max()), keys_flat=k_flat,
                                          stats=ts._join_stats)
    jplan = jserving.QueryPlan(**dataclasses_asdict(plan))
    in_k = np.full((plan.key_in_cap,), 2**31 - 1, np.int32)
    in_q = np.full((plan.key_in_cap,), PAD_ID, np.int32)
    in_k[: k_flat.size], in_q[: q_flat.size] = k_flat, q_flat
    t_counter, j_counter = [0], [0]
    t_mesh = ts._eng.mesh()
    got = tserving.make_query_probe_pipeline(t_mesh, plan, trace_counter=t_counter)(
        ts._slab_keys, ts._slab_rows, torch.tensor(in_k), torch.tensor(in_q))
    want = jserving.make_query_probe_pipeline(mesh, jplan, trace_counter=j_counter)(
        js._slab_keys, js._slab_rows, jnp.asarray(in_k), jnp.asarray(in_q))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert int(got["count"][0]) > 0 and t_counter == j_counter == [1]
    q_places = np.full((plan.q_cap, plan.L_pad), PAD_PLACE, np.int32)
    q_places[:5, : places.shape[1]] = places[:5]
    rho = np.full((plan.q_cap,), RHO, np.float32)
    active = np.ones((plan.q_cap, 1), bool)
    prev_row = np.full((plan.q_cap, plan.k_cap), PAD_ID, np.int32)
    prev_neg = np.full((plan.q_cap, plan.k_cap), np.inf, np.float32)
    args = (q_places, rho, active, prev_row, prev_neg)
    for impl in ("wavefront", "fused"):
        t_fn = tserving.make_query_score_pipeline(t_mesh, plan, betas=ts.betas, lcs_impl=impl)
        j_fn = jserving.make_query_score_pipeline(mesh, jplan, betas=js.betas)
        out_t = t_fn(ts._places_dev, got["cand_row"].reshape(-1), got["cand_qid"].reshape(-1),
                     *(torch.tensor(a) for a in args), ts.tables)
        out_j = j_fn(js._places_dev, want["cand_row"].reshape(-1), want["cand_qid"].reshape(-1),
                     *(jnp.asarray(a) for a in args), js.tables)
        for name in out_j:
            np.testing.assert_array_equal(out_t[name].numpy(), np.asarray(out_j[name]))
        assert (out_t["top_row"][:5] != PAD_ID).any()


def dataclasses_asdict(x):
    import dataclasses

    return dataclasses.asdict(x)
