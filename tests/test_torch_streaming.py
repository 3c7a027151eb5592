"""The port's streaming engine against the JAX streaming engine, on the CPU.

The same numpy worlds (seeded, a few dozen to a few hundred trajectories)
go through ``repro.api.StreamingEngine`` and ``repro_torch.api.StreamingEngine``
(``device="cpu"``) update by update.  Tolerance 0 throughout: after every
update the accumulated scored buffer is equal slot by slot (``left``,
``right``, ``level_lcs`` equal, float32 ``mss`` bit-equal), and so are the
similar pairs, the communities and every stats count.  Two stats differ by
design and are left out: the phase times (``t_*``, ``compact_ms_total``) and
``driver_bytes_in``, which counts what each engine ships to its device (the
port ships the new rows and the scored pairs unpadded; the JAX engine pads
them to its compiled shapes).  The host pieces (``BucketIndex``,
``components_after_deletion``, ``StreamJoinStats``, ``ShardSummaries``)
are held to their JAX twins on random inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.api as japi
import repro.api.sharded as jsharded
import repro.core.communities as jcomm
import repro.core.device_index as jdi
import repro.core.stream_index as jsi
import repro.data as jdata
from repro.core.types import TrajectoryBatch as JBatch
from repro_torch.api import (
    LCS_IMPLS, AnotherMeEngine, CapacityExceeded, EngineConfig, ExecutionPlan,
    StreamingEngine,
)
from repro_torch.api import sharded as tsharded
from repro_torch.core import communities as tcomm
from repro_torch.core import device_index as tdi
from repro_torch.core import stream_index as tsi
from repro_torch.core.types import PAD_ID, PAD_KEY, TrajectoryBatch
from repro_torch.data import synthetic_setup

CPU = "cpu"
# stats that count what each engine ships or how long it took
TIMING_KEYS = ("compact_ms_total", "driver_bytes_in")


def world(seed, n=18):
    """A random small world as in the JAX streaming suite, built by both
    packages: (numpy places, numpy lengths, JAX forest, port forest)."""
    rng = np.random.default_rng(seed)
    kw = dict(num_types=int(rng.integers(4, 8)), classes_per_type=3,
              num_places=int(rng.integers(20, 60)), min_len=2, max_len=8, seed=seed)
    jb, jf = jdata.synthetic_setup(n, **kw)
    _, tf = synthetic_setup(n, device=CPU, **kw)
    return np.asarray(jb.places), np.asarray(jb.lengths), jf, tf


def pieces(places, lengths, cuts):
    """Rows split at ``cuts`` (repeats make empty pieces); each piece is cut
    to its own max length, so the world's width grows across updates."""
    bounds = [0] + sorted(cuts) + [places.shape[0]]
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        p, ln = places[a:b], lengths[a:b]
        w = max(int(ln.max()), 1) if ln.size else 1
        out.append((np.ascontiguousarray(p[:, :w]), ln.copy()))
    return out


def jbatch(p, ln):
    return JBatch(places=jnp.asarray(p), lengths=jnp.asarray(ln),
                  user_id=jnp.arange(p.shape[0], dtype=jnp.int32))


def tbatch(p, ln):
    return TrajectoryBatch(places=torch.tensor(p), lengths=torch.tensor(ln),
                           user_id=torch.arange(p.shape[0], dtype=torch.int32))


def assert_same(got, want, where=""):
    for field in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        g = getattr(got.scored, field).numpy()
        w = np.asarray(getattr(want.scored, field))
        assert g.dtype == w.dtype, (where, field)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {field}")
    assert got.similar_pairs == want.similar_pairs, where
    assert got.communities == want.communities, where
    counts = lambda s: {k: v for k, v in s.items()  # noqa: E731
                        if not k.startswith("t_") and k not in TIMING_KEYS}
    assert counts(got.stats) == counts(want.stats), where
    assert set(got.stats) == set(want.stats), where


class Pair:
    """One JAX and one port streaming engine driven in lockstep."""

    def __init__(self, jf, tf, cfg=None, plan=None, **kw):
        cfg = {"rho": 2.0, **(cfg or {})}
        self.j = japi.StreamingEngine(jf, japi.EngineConfig(**cfg),
                                      japi.ExecutionPlan(**(plan or {})), **kw)
        self.t = StreamingEngine(tf, EngineConfig(**cfg), ExecutionPlan(**(plan or {})),
                                 device=CPU, **kw)

    def update(self, p, ln, ttl=None):
        got = self.t.update(tbatch(p, ln), ttl=ttl)
        want = self.j.update(jbatch(p, ln), ttl=ttl)
        assert_same(got, want, f"update {self.t.updates}")
        return got

    def retire(self, ids):
        n = self.t.retire(ids)
        assert n == self.j.retire(ids)
        assert self.t.live_size == self.j.live_size
        return n

    def state(self):
        """The port's world state, for before/after comparisons."""
        t = self.t
        return (t.n, t.L, t._cap, t._base, t.updates, t._acc_n, t.live_size,
                t._places_np.copy(), t._lengths_np.copy(), t._alive_np.copy(),
                t._codes_dev.clone() if t._codes_dev is not None else None,
                frozenset(t.similar_pairs), t._index.num_keys_inserted)


def random_cuts(seed, n, k):
    rng = np.random.default_rng(1000 + seed)
    return sorted(rng.choice(np.arange(0, n + 1), size=k - 1).tolist())


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("backend", ["ssh", "minhash", "brp", "udf"])
def test_streaming_matches_jax_for_any_split(backend, prune):
    """Every update of random splits (empty pieces included) equals the JAX
    engine's, and the last one equals the port's one-shot run."""
    for seed in (0, 1, 2):
        places, lengths, jf, tf = world(seed)
        cfg = dict(backend=backend, score_prune=prune, community_mode="components")
        pair = Pair(jf, tf, cfg)
        for p, ln in pieces(places, lengths, random_cuts(seed, places.shape[0], 2 + seed)):
            got = pair.update(p, ln)
        once = AnotherMeEngine(tf, EngineConfig(rho=2.0, **cfg), device=CPU).run(
            tbatch(places, lengths))
        assert got.similar_pairs == once.similar_pairs
        assert got.communities == once.communities


def test_singleton_and_empty_updates():
    places, lengths, jf, tf = world(3, n=8)
    split = pieces(places, lengths, [0, 1, 4, 4, 7, 8])
    assert min(p.shape[0] for p, _ in split) == 0 and 1 in {p.shape[0] for p, _ in split}
    pair = Pair(jf, tf)
    for p, ln in split:
        pair.update(p, ln)
    assert pair.t.world_size == places.shape[0]


@pytest.mark.parametrize("impl", LCS_IMPLS)
def test_every_lcs_impl_matches_jax(impl):
    """The delta pairs go through the one-shot engine's lcs_impl dispatch:
    every name gives the JAX wavefront engine's buffers."""
    places, lengths, jf, tf = world(5, n=24)
    pair = Pair(jf, tf)
    pair.t = StreamingEngine(tf, EngineConfig(rho=2.0, lcs_impl=impl), device=CPU)
    for p, ln in pieces(places, lengths, [6, 12, 20]):
        pair.update(p, ln)


@pytest.mark.parametrize("mode", ["unionfind", "jit", "cliques"])
def test_community_paths_under_ttl_window_retire_and_compaction(mode):
    """TTL, a window, explicit retires and compactions: the community paths
    un-merge exactly as the JAX engine's, update by update, and the world
    table rolls to the JAX engine's."""
    places, lengths, jf, tf = world(11, n=60)
    cfg = dict(rho=1.5, community_mode="cliques" if mode == "cliques" else "components")
    pair = Pair(jf, tf, cfg, components_impl="jit" if mode == "jit" else "unionfind",
                window=3, compact_watermark=0.3)
    for u, (p, ln) in enumerate(pieces(places, lengths, [10, 20, 30, 40, 50])):
        pair.update(p, ln, ttl=2 if u == 1 else None)
        if u == 2:
            pair.retire([3, 12, 25, 26])
    for _ in range(3):
        pair.update(places[:0, :1], lengths[:0])
    assert pair.t.compactions >= 1 and pair.t._base > 0
    assert pair.t.compactions == pair.j.compactions and pair.t._base == pair.j._base
    np.testing.assert_array_equal(pair.t._labels, pair.j._labels)
    np.testing.assert_array_equal(pair.t._codes_dev.numpy(), np.asarray(pair.j._codes_dev))
    np.testing.assert_array_equal(pair.t._len_dev.numpy(), np.asarray(pair.j._len_dev))


def test_compaction_rebase_keeps_global_ids():
    """After a prefix compaction the port's results still speak global ids,
    equal to the JAX engine's, and equal a one-shot run over the survivors
    with ids mapped."""
    places, lengths, jf, tf = world(2, n=48)
    pair = Pair(jf, tf, dict(community_mode="components"), window=2)
    for p, ln in pieces(places, lengths, [12, 24, 36]):
        got = pair.update(p, ln)
    assert pair.t._base > 0
    live = np.nonzero(pair.t._alive_np[: pair.t.n - pair.t._base])[0] + pair.t._base
    once = AnotherMeEngine(tf, EngineConfig(rho=2.0, community_mode="components"),
                           device=CPU).run(tbatch(places[live], lengths[live]))
    assert {(int(live[a]), int(live[b])) for a, b in once.similar_pairs} == got.similar_pairs
    assert {frozenset(int(live[i]) for i in c) for c in once.communities} == got.communities


def test_ttl_and_window_timing_match_jax():
    places, lengths, jf, tf = world(0, n=8)
    empty = (places[:0, :1], lengths[:0])
    pair = Pair(jf, tf)
    pair.update(places, lengths, ttl=2)
    pair.update(*empty)
    assert pair.t.live_size == 8
    res = pair.update(*empty)
    assert pair.t.live_size == 0 and res.stats["num_expired"] == 8
    ceiling = Pair(jf, tf, window=1)
    ceiling.update(places, lengths, ttl=5)  # min(5, 1) = 1
    ceiling.update(*empty)
    assert ceiling.t.live_size == 0
    forever = Pair(jf, tf)
    forever.update(places, lengths)
    for _ in range(3):
        forever.update(*empty)
    assert forever.t.live_size == 8 and forever.t.retired_total == 0


def test_retire_validates_and_is_idempotent():
    places, lengths, jf, tf = world(0, n=8)
    pair = Pair(jf, tf)
    pair.update(places, lengths)
    for bad in ([8], [-1]):
        with pytest.raises(ValueError, match="cannot retire"):
            pair.t.retire(bad)
    assert pair.t.live_size == 8
    assert pair.retire([0, 1]) == 2
    assert pair.retire([0, 1]) == 0
    assert pair.retire([1, 2]) == 1
    assert pair.t.retired_total == pair.j.retired_total == 3
    pair.update(places[:3], lengths[:3])


def test_admission_refusal_leaves_world_untouched():
    places, lengths, jf, tf = world(3, n=24)
    first, second = pieces(places, lengths, [8])
    pair = Pair(jf, tf, dict(community_mode="components"))
    pair.update(*first)
    budget = pair.t.resident_bytes()
    assert budget == pair.j.resident_bytes()
    pair.t.max_resident_bytes = pair.j.max_resident_bytes = budget
    before = pair.state()
    with pytest.raises(CapacityExceeded) as err:
        pair.t.update(tbatch(*second))
    with pytest.raises(japi.CapacityExceeded) as jerr:
        pair.j.update(jbatch(*second))
    assert (err.value.needed_bytes, err.value.budget_bytes) == \
        (jerr.value.needed_bytes, jerr.value.budget_bytes)
    assert str(err.value) == str(jerr.value)
    after = pair.state()
    for a, b in zip(before, after):
        if isinstance(a, (np.ndarray, torch.Tensor)):
            assert a.shape == b.shape and (a == b).all()
        else:
            assert a == b
    pair.t.max_resident_bytes = pair.j.max_resident_bytes = None
    pair.update(*second)


@pytest.mark.parametrize("backend", ["ssh", "minhash"])
def test_fault_injection_is_bit_identical(monkeypatch, backend):
    """REPRO_FAULT_INJECT=1 derates the device join's plans only: on the host
    join both engines give the results of a run without it."""
    places, lengths, jf, tf = world(4, n=30)
    split = pieces(places, lengths, [9, 21])
    cfg = dict(backend=backend, community_mode="components")
    ref = StreamingEngine(tf, EngineConfig(rho=2.0, **cfg), device=CPU)
    wants = [ref.update(tbatch(p, ln)) for p, ln in split]
    monkeypatch.setenv("REPRO_FAULT_INJECT", "1")
    pair = Pair(jf, tf, cfg)
    for (p, ln), want in zip(split, wants):
        got = pair.update(p, ln)
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, field), getattr(want.scored, field))
        assert got.similar_pairs == want.similar_pairs
        assert got.communities == want.communities


def test_world_growth_and_preallocation_match_jax():
    places, lengths, jf, tf = world(0, n=64)
    split = pieces(places, lengths, list(range(4, 64, 4)))
    pair = Pair(jf, tf)
    caps = []
    for p, ln in split:
        caps.append(pair.update(p, ln).stats["world_capacity"])
    assert len(set(caps)) <= 4 and caps[-1] >= 64
    pre = Pair(jf, tf, world_capacity=64)
    for p, ln in split:
        pre.update(p, ln)
    assert pre.t._cap == pre.t._cap_floor == 64


def test_refusals():
    places, lengths, _, tf = world(0, n=12)
    # the device join in shuffle mode and two shards run, and equal one shard
    one = StreamingEngine(tf, device=CPU).update(tbatch(places, lengths))
    for plan in (ExecutionPlan(delta_join="device", score_mode="shuffle"),
                 ExecutionPlan(n_shards=2, devices=(CPU,) * 2),
                 ExecutionPlan(n_shards=2, delta_join="device", devices=(CPU,) * 2)):
        got = StreamingEngine(tf, plan=plan, device=CPU).update(tbatch(places, lengths))
        assert_same_result(got, one, str(plan))
    with pytest.raises(NotImplementedError, match="subtraj_window"):
        StreamingEngine(tf, EngineConfig(subtraj_window=4), device=CPU)
    with pytest.raises(ValueError, match="components_impl"):
        StreamingEngine(tf, components_impl="nope", device=CPU)
    with pytest.raises(ValueError, match="delta_join"):
        StreamingEngine(tf, plan=ExecutionPlan(delta_join="nope"), device=CPU)
    with pytest.raises(ValueError, match="window"):
        StreamingEngine(tf, window=0, device=CPU)
    with pytest.raises(ValueError, match="micro-batch"):
        StreamingEngine(tf, device=CPU).update_many([])
    # autotuning runs; whatever the table holds, the untuned result
    got = StreamingEngine(tf, plan=ExecutionPlan(n_shards=2, devices=(CPU,) * 2, autotune=True),
                          device=CPU).update(tbatch(places, lengths))
    assert_same_result(got, one, "autotune")
    with pytest.raises(ValueError, match="first shard"):  # the world lives on shard 0
        StreamingEngine(tf, plan=ExecutionPlan(n_shards=2, devices=("meta",) * 2), device=CPU)


def assert_same_result(got, want, where=""):
    """Two streaming results of the same rows equal: the scored buffer slot
    by slot, the similar pairs and the communities."""
    for field in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        assert torch.equal(getattr(got.scored, field), getattr(want.scored, field)), \
            (where, field)
    assert got.similar_pairs == want.similar_pairs, where
    assert got.communities == want.communities, where


def test_default_device_is_the_card():
    _, _, _, tf = world(0, n=4)
    if torch.cuda.is_available():
        assert StreamingEngine(tf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingEngine(tf)


# ---------------------------------------------------------------------------
# the host pieces against their JAX twins
# ---------------------------------------------------------------------------
def random_keys(rng, n, s=4, alphabet=9, pad=0.3):
    keys = rng.integers(0, alphabet, size=(n, s)).astype(np.int32)
    keys[rng.random(size=keys.shape) < pad] = PAD_KEY
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_index_matches_jax(seed):
    """insert (pair order slot by slot), probe, retire and the live
    full_join_size, interleaved."""
    rng = np.random.default_rng(seed)
    got, want = tsi.BucketIndex(hot_bucket_warn=None), jsi.BucketIndex(hot_bucket_warn=None)
    kept, next_id = {}, 0
    for step in range(6):
        keys = random_keys(rng, int(rng.integers(0, 7)))
        a, b = got.insert(keys), want.insert(keys)
        for x, y in zip(a[:2], b[:2]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a[2] == b[2]
        for r in range(keys.shape[0]):
            kept[next_id + r] = keys[r]
        next_id += keys.shape[0]
        q = random_keys(rng, 5)
        for x, y in zip(got.probe(q), want.probe(q)):
            assert np.array_equal(x, y)
        if kept:
            ret = rng.choice(sorted(kept), size=min(2, len(kept)), replace=False)
            rk = np.stack([kept.pop(int(i)) for i in ret])
            got.retire(ret, rk)
            want.retire(ret, rk)
            got.retire(ret, rk)  # idempotent
        assert got.full_join_size() == want.full_join_size()
        assert got.pairs_examined_total == want.pairs_examined_total
        assert got.num_keys_inserted == want.num_keys_inserted
        assert got.max_bucket_len() == want.max_bucket_len()
        assert got._buckets == want._buckets


def test_bucket_index_hot_key_and_order():
    keys = np.zeros((30, 1), np.int32)
    index = tsi.BucketIndex(hot_bucket_warn=8)
    with pytest.warns(RuntimeWarning, match="bucket for key 0"):
        lo, hi, examined = index.insert(keys)
    assert examined == 30 * 29 // 2 == index.full_join_size()
    assert index._warned_keys == {0}
    assert tsi.HOT_BUCKET_WARN == jsi.HOT_BUCKET_WARN
    with pytest.raises(ValueError, match="in order"):
        index.insert(keys[:2], first_id=99)


@pytest.mark.parametrize("seed", range(4))
def test_components_after_deletion_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n, size=(30, 2)) if a != b]
    uf = tcomm.UnionFind(n)
    for a, b in edges:
        uf.union(a, b)
    dead = rng.choice(n, size=5, replace=False).tolist()
    surviving = [(a, b) for a, b in edges if a not in dead and b not in dead]
    got = tcomm.components_after_deletion(uf.labels(), dead, surviving)
    want = jcomm.components_after_deletion(uf.labels(), dead, surviving)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    cold = tcomm.UnionFind(n)
    for a, b in surviving:
        cold.union(a, b)
    assert np.array_equal(got, cold.labels())
    assert np.array_equal(tcomm.components_after_deletion(uf.labels(), [], edges), uf.labels())


@pytest.mark.parametrize("n_sh", [1, 2, 4])
def test_shard_summaries_match_jax(n_sh):
    rng = np.random.default_rng(23 + n_sh)
    got, want = tdi.ShardSummaries(n_sh), jdi.ShardSummaries(n_sh)
    for _ in range(3):
        first = int(rng.integers(0, 5))
        lengths = rng.integers(1, 12, size=int(rng.integers(0, 30)))
        got.insert(first, lengths)
        want.insert(first, lengths)
        alive = rng.random(lengths.shape[0]) > 0.4
        got.rebuild(first * n_sh, lengths, alive)
        want.rebuild(first * n_sh, lengths, alive)
        assert np.array_equal(got.rows, want.rows) and np.array_equal(got.max_len, want.max_len)


def test_stream_join_stats_match_jax():
    rng = np.random.default_rng(5)
    got, want = tdi.StreamJoinStats(2), jdi.StreamJoinStats(2)
    for _ in range(4):
        keys = rng.integers(0, 7, size=12).astype(np.int32)
        owners = tsharded._positive_hash_np(keys) % 2
        for x, y in zip(got.plan_update(keys, owners), want.plan_update(keys, owners)):
            assert np.array_equal(x, y)
        got.commit(keys, owners)
        want.commit(keys, owners)
        got.retire(keys[:3], owners[:3])
        want.retire(keys[:3], owners[:3])
        assert got.dead_fraction() == want.dead_fraction()
        got.compact()
        want.compact()
        assert got.counts == want.counts and got.num_keys == want.num_keys
        assert np.array_equal(got.owner_entries, want.owner_entries)


def test_host_helpers_match_jax():
    x = np.random.default_rng(0).integers(-2**31, 2**31 - 1, size=1000).astype(np.int32)
    assert np.array_equal(tsharded._positive_hash_np(x), jsharded._positive_hash_np(x))
    for v in (0, 1, 15, 16, 17, 1000, 2**20 + 1):
        for floor in (0, 2, 4):
            assert tsharded._pow2(v, floor) == jsharded._pow2(v, floor)
    assert PAD_ID == 2**31 - 1
