"""The port's device-resident streaming join against the JAX package's, on the CPU.

``StreamingEngine(..., ExecutionPlan(delta_join="device"))`` keeps the join
state as a sorted slab on the device.  Here the same seeded numpy inputs go
through the JAX functions and their ports (``device="cpu"``), tolerance 0:

* the slab operations (``probe_pairs``, ``merge_insert``, ``probe_rows``,
  ``mark_dead_rows``, ``compact_slab``) on random slabs with tombstones and
  at the edges (an empty slab, all-PAD input, a full slab that overflows, a
  shrinking ``out_cap``), buffer for buffer against the JAX functions and
  against the JAX package's numpy oracles;
* the int32 hashes against the numpy ones on random and extreme values, the
  join plans, and the one-shard join and score functions against the JAX
  ``shard_map`` programs on a one-device mesh, output by output;
* the streaming engine update by update (the accumulated scored buffer slot
  by slot, similar pairs, communities and every stats count but the times,
  ``driver_bytes_in`` and ``join_traces``), and against the port's own
  host-join engine on the same stream.

``join_traces`` is left out of the engine comparison: the JAX engine traces a
join plan again when its slab input comes from the join program rather than
from a fresh allocation (the two differ in sharding), which a function built
once per plan does not mirror.  The port's count is held to its own rule
instead: one build per plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.api as japi
import repro.api.sharded as jsharded
import repro.core.device_index as jdi
from repro.core import compat
from repro_torch.api import (
    CapacityExceeded, CapacityPlanner, EngineConfig, ExecutionPlan, NotPortedError,
    StreamingEngine,
)
from repro_torch.api import sharded as tsharded
from repro_torch.api import streaming as tstreaming
from repro_torch.core import compat as tcompat
from repro_torch.core import device_index as tdi
from repro_torch.core.types import PAD_ID, PAD_KEY

from tests.test_torch_streaming import (
    Pair, assert_same, assert_same_result, jbatch, pieces, tbatch, world,
)

CPU = "cpu"
DEVICE = {"delta_join": "device"}
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
HASH_TO_INT32_MIN = -1936480083


# ---------------------------------------------------------------------------
# the slab operations
# ---------------------------------------------------------------------------
def make_slab(entries, cap):
    """Sorted slab from (key, row) pairs; tombstones keep their key with row
    PAD_ID (the JAX suite's construction)."""
    entries = sorted(entries, key=lambda kr: kr[0])
    kk = np.full((cap,), PAD_KEY, np.int32)
    rr = np.full((cap,), PAD_ID, np.int32)
    for i, (k, r) in enumerate(entries):
        kk[i], rr[i] = k, r
    return kk, rr


def pad_flat(vals, cap, pad):
    out = np.full((cap,), pad, np.int32)
    out[: len(vals)] = vals
    return out


def random_slab(rng, cap, n_ent, alphabet=7, dead=0.3, first_row=100):
    ent = [(int(rng.integers(-3, alphabet)), first_row + i if rng.random() > dead else PAD_ID)
           for i in range(n_ent)]
    return make_slab(ent, cap)


def random_incoming(rng, cap, n, alphabet=7, first_row=500):
    """PAD-padded incoming (key, row) occurrences, shuffled, as a route
    leaves them."""
    keys = pad_flat([int(rng.integers(-3, alphabet)) for _ in range(n)], cap, PAD_KEY)
    rows = pad_flat([first_row + i for i in range(n)], cap, PAD_ID)
    perm = rng.permutation(cap)
    return keys[perm], rows[perm]


def both(fn_t, fn_j, arrays, **kw):
    """Run the port on torch tensors and the JAX function on jnp arrays;
    assert every output equal (dtype too) and return the port's as numpy."""
    got = fn_t(*(torch.tensor(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out = []
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        out.append(g)
    return out


# (slab cap, slab entries, incoming cap, incoming rows, nn_cap, no_cap)
PROBE_CASES = {
    "random": (64, 40, 16, 12, 256, 256),
    "empty slab": (16, 0, 16, 12, 256, 256),
    "all-PAD input": (32, 20, 16, 0, 16, 16),
    "full slab": (32, 32, 16, 16, 256, 256),
    "overflow": (64, 48, 32, 30, 8, 8),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_pairs_matches_jax_and_reference(case):
    cap, n_ent, in_cap, n_in, nn_cap, no_cap = PROBE_CASES[case]
    rng = np.random.default_rng(sorted(PROBE_CASES).index(case))
    for trial in range(4):
        kk, rr = random_slab(rng, cap, n_ent)
        keys, rows = random_incoming(rng, in_cap, n_in)
        lo, hi, examined, overflow = both(
            tdi.probe_pairs, jdi.probe_pairs, (kk, rr, keys, rows), nn_cap=nn_cap, no_cap=no_cap)
        want_pairs, want_examined = jdi.probe_pairs_ref(kk, rr, keys, rows)
        assert int(examined) == want_examined
        got = sorted((int(a), int(b)) for a, b in zip(lo, hi) if a != PAD_ID)
        if case == "overflow":
            assert int(overflow) > 0 and len(got) <= nn_cap + no_cap
            assert set(got) <= set(want_pairs)
        else:
            assert int(overflow) == 0 and got == sorted(want_pairs)


@pytest.mark.parametrize("case", ["random", "empty slab", "all-PAD input", "full slab overflows"])
def test_merge_insert_matches_jax_and_reference(case):
    rng = np.random.default_rng(3)
    cap, n_ent, in_cap, n_in = {"random": (64, 30, 16, 12), "empty slab": (16, 0, 16, 10),
                                "all-PAD input": (32, 20, 16, 0),
                                "full slab overflows": (32, 28, 16, 12)}[case]
    for trial in range(4):
        # merge_insert's slabs hold live entries only (tombstones are for
        # the probes); row ids grow, as streaming ids do
        kk, rr = random_slab(rng, cap, n_ent, dead=0.0)
        keys, rows = random_incoming(rng, in_cap, n_in)
        k2, r2, overflow = both(tdi.merge_insert, jdi.merge_insert, (kk, rr, keys, rows))
        wk, wr, wov = jdi.merge_insert_ref(kk, rr, keys, rows, cap)
        np.testing.assert_array_equal(k2, wk)
        np.testing.assert_array_equal(r2, wr)
        assert int(overflow) == wov == max(n_ent + n_in - cap, 0)
        assert (int(overflow) > 0) == (case == "full slab overflows")


@pytest.mark.parametrize("case", ["random", "empty slab", "all-PAD input", "overflow"])
def test_probe_rows_matches_jax_and_reference(case):
    rng = np.random.default_rng(5)
    cap, n_ent, n_in, out_cap = {
        "random": (48, 30, 10, 256), "empty slab": (16, 0, 10, 16),
        "all-PAD input": (32, 20, 0, 16), "overflow": (48, 40, 12, 8),
    }[case]
    for trial in range(4):
        kk, rr = random_slab(rng, cap, n_ent)
        keys = pad_flat([int(rng.integers(-3, 7)) for _ in range(n_in)], 16, PAD_KEY)
        payload = pad_flat(list(range(n_in)), 16, PAD_ID)
        rows, pay, examined, overflow = both(
            tdi.probe_rows, jdi.probe_rows, (kk, rr, keys, payload), cap=out_cap)
        want, want_examined = jdi.probe_rows_ref(kk, rr, keys, payload)
        assert int(examined) == want_examined
        got = sorted((int(m), int(p)) for m, p in zip(rows, pay) if m != PAD_ID)
        if case == "overflow":
            assert int(overflow) > 0 and set(got) <= set(want)
        else:
            assert int(overflow) == 0 and got == sorted(want)


def test_mark_dead_rows_matches_jax_and_reference():
    rng = np.random.default_rng(7)
    for trial in range(8):
        cap = int(rng.integers(4, 64))
        n_live = int(rng.integers(0, cap))
        kk, rr = random_slab(rng, cap, n_live, dead=0.2)
        ids = rr[rr != PAD_ID]
        dead = rng.choice(ids, size=int(rng.integers(0, ids.size + 1)), replace=False) \
            if ids.size else np.zeros((0,), np.int32)
        dead_cap = 1 << max(int(np.ceil(np.log2(max(dead.size, 1)))), 2)
        dead_sorted = pad_flat(np.sort(dead).tolist(), dead_cap, PAD_ID)
        got = tdi.mark_dead_rows(torch.tensor(rr), torch.tensor(dead_sorted))
        want = jdi.mark_dead_rows(jnp.asarray(rr), jnp.asarray(dead_sorted))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dead_set = set(dead.tolist())
        np.testing.assert_array_equal(
            got.numpy(), np.array([PAD_ID if r in dead_set else r for r in rr.tolist()], np.int32))
        again = tdi.mark_dead_rows(got, torch.tensor(dead_sorted))  # idempotent
        assert torch.equal(again, got)


@pytest.mark.parametrize("out_cap_mode", ["same", "shrink", "grow", "tight"])
def test_compact_slab_matches_jax_and_reference(out_cap_mode):
    rng = np.random.default_rng(11)
    for trial in range(8):
        cap = int(rng.integers(8, 64))
        kk, rr = random_slab(rng, cap, int(rng.integers(0, cap)), dead=0.4)
        live = int(np.sum(rr != PAD_ID))
        shift = int(rng.integers(0, 50))
        out_cap = {"same": cap, "shrink": max(cap // 2, 1), "grow": cap + 8,
                   "tight": max(live, 1)}[out_cap_mode]
        ko, ro, lv, ov = tdi.compact_slab(torch.tensor(kk), torch.tensor(rr),
                                          torch.tensor(shift, dtype=torch.int32), out_cap=out_cap)
        jk, jr, jl, jo = jdi.compact_slab(jnp.asarray(kk), jnp.asarray(rr),
                                          jnp.asarray(shift, jnp.int32), out_cap=out_cap)
        for g, w in ((ko, jk), (ro, jr), (lv, jl), (ov, jo)):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        wk, wr, wlive, wov = jdi.compact_slab_ref(kk, rr, shift, out_cap)
        np.testing.assert_array_equal(ko.numpy(), wk)
        np.testing.assert_array_equal(ro.numpy(), wr)
        assert int(lv) == wlive == live and int(ov) == wov == max(live - out_cap, 0)


def test_flat_row_keys_is_the_per_row_key_set():
    keys = np.array([[3, 1, 3, PAD_KEY], [PAD_KEY] * 4, [7, 7, 7, 2]], np.int32)
    k, r = tdi.flat_row_keys(keys)
    assert k.tolist() == [1, 3, 2, 7] and r.tolist() == [0, 0, 2, 2]
    assert k.dtype == r.dtype == np.int32


# ---------------------------------------------------------------------------
# hashes and plans
# ---------------------------------------------------------------------------
def hash_inputs():
    rng = np.random.default_rng(0)
    # HASH_TO_INT32_MIN: the one int32 whose mix is INT32_MIN, so abs wraps
    extreme = [INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX, INT32_MAX - 1, 8191, 8192,
               -8192, 2**30, -2**30, 809234361, HASH_TO_INT32_MIN]
    return np.concatenate([np.array(extreme, np.int32),
                           rng.integers(INT32_MIN, INT32_MAX, size=4000, dtype=np.int64)
                           .astype(np.int32)])


def test_hashes_match_numpy_and_jax():
    x = hash_inputs()
    got = tsharded._positive_hash(torch.tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jsharded._positive_hash_np(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsharded._positive_hash(jnp.asarray(x))))
    assert got[13] == INT32_MIN  # abs(INT32_MIN) wraps, as in numpy
    y = np.roll(x, 7)
    pair = tsharded._pair_hash(torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(pair.numpy(), jsharded._pair_hash_np(x, y))
    np.testing.assert_array_equal(
        pair.numpy(), np.asarray(jsharded._pair_hash(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(tsharded._positive_hash_np(x), jsharded._positive_hash_np(x))


def plans_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_join_plans_match_jax():
    rng = np.random.default_rng(9)
    t_stats, j_stats = tdi.StreamJoinStats(1), jdi.StreamJoinStats(1)
    t_prev = j_prev = None
    for step in range(6):
        keys = rng.integers(-5, 40, size=int(rng.integers(0, 60))).astype(np.int32)
        got = CapacityPlanner().plan_stream_join(keys, 1, t_stats)
        want = japi.CapacityPlanner().plan_stream_join(keys, 1, j_stats)
        assert plans_equal(got, want)
        for n_sh in (2, 4):  # the planner's arithmetic at more shards too
            assert plans_equal(tsharded.plan_stream_join(keys, n_sh, tdi.StreamJoinStats(n_sh)),
                               jsharded.plan_stream_join(keys, n_sh, jdi.StreamJoinStats(n_sh)))
        t_prev = tsharded.sticky_join_plan(got, t_prev)
        j_prev = jsharded.sticky_join_plan(want, j_prev)
        assert plans_equal(t_prev, j_prev)
        owners = np.zeros(keys.shape, np.int64)
        t_stats.commit(keys, owners)
        j_stats.commit(keys, owners)
        if step == 3:
            for st in (t_stats, j_stats):
                st.retire(keys[:5], owners[:5])
                st.compact()


# ---------------------------------------------------------------------------
# the one-shard join and score functions against the JAX programs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1,), ("ex",), devices=jax.devices()[:1])


def assert_outputs(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("caps", [
    dict(key_route_cap=64, nn_cap=256, no_cap=256, pair_route_cap=512, pair_cap=256),
    dict(key_route_cap=16, nn_cap=16, no_cap=16, pair_route_cap=16, pair_cap=8),  # overflows
])
def test_join_pipeline_matches_jax(mesh, caps):
    rng = np.random.default_rng(13)
    plan = tsharded.StreamJoinPlan(n_shards=1, slab_cap=128, key_in_cap=32, **caps)
    jplan = jsharded.StreamJoinPlan(**dataclasses.asdict(plan))
    t_counter, j_counter = [0], [0]
    t_fn = tsharded.make_streaming_join_pipeline(tcompat.make_mesh((1,), ("ex",), devices=(CPU,)),
                                                 plan, trace_counter=t_counter)
    j_fn = jsharded.make_streaming_join_pipeline(mesh, jplan, trace_counter=j_counter)
    kk, rr = random_slab(rng, 128, 24, dead=0.0, first_row=0)
    for step in range(3):
        keys, rows = random_incoming(rng, 32, 20, first_row=24 + 20 * step)
        got = t_fn(torch.tensor(kk), torch.tensor(rr), torch.tensor(keys), torch.tensor(rows))
        want = j_fn(jnp.asarray(kk), jnp.asarray(rr), jnp.asarray(keys), jnp.asarray(rows))
        assert_outputs(got, want)
        if int(got["overflow"].sum()) == 0:
            kk, rr = got["slab_keys"].numpy(), got["slab_rows"].numpy()
    assert t_counter == j_counter == [1]
    assert (int(got["overflow"].sum()) > 0) == (caps["pair_cap"] == 8)


@pytest.mark.parametrize("impl", ["wavefront", "fused", "kernel"])
@pytest.mark.parametrize("prune", [False, True])
def test_score_pipeline_matches_jax(mesh, impl, prune):
    places, lengths, jf, tf = world(21, n=40)
    cap, L = 64, places.shape[1]
    slab = np.full((cap, L), -1, np.int32)
    slab[: places.shape[0]] = places
    rng = np.random.default_rng(17)
    pairs = np.sort(rng.integers(0, places.shape[0], size=(40, 2)), axis=1).astype(np.int32)
    left = pad_flat(pairs[:, 0].tolist(), 64, PAD_ID)
    right = pad_flat(pairs[:, 1].tolist(), 64, PAD_ID)
    plan = tsharded.StreamShardPlan(n_shards=1, cap_local=cap, pair_cap=64, hop_cap=0,
                                    out_cap=64)
    t_eng = StreamingEngine(tf, EngineConfig(rho=4.5), device=CPU)
    j_eng = japi.StreamingEngine(jf, japi.EngineConfig(rho=4.5))
    t_fn = tsharded.make_streaming_score_pipeline(
        tcompat.make_mesh((1,), ("ex",), devices=(CPU,)), plan, betas=t_eng.betas,
        lcs_impl=impl, score_prune=prune, prune_tau=4.5)
    j_fn = jsharded.make_streaming_score_pipeline(
        mesh, jsharded.StreamShardPlan(**dataclasses.asdict(plan)), betas=j_eng.betas,
        lcs_impl="wavefront", score_prune=prune, prune_tau=4.5)
    got = t_fn(torch.tensor(slab), torch.tensor(left), torch.tensor(right), t_eng.tables)
    want = j_fn(jnp.asarray(slab), jnp.asarray(left), jnp.asarray(right), j_eng.tables)
    assert_outputs(got, want)
    assert (int(got["pruned"][0]) > 0) == prune


def test_one_shard_only():
    """The join and score programs on a mesh of two CPU shards against the
    same programs on one: the union of the shards' deduped pairs, their
    counts and examined counts, each shard's merged slab (the one-shard
    slab's entries of the keys it owns, in order), and every pair's score
    in both score modes."""
    rng = np.random.default_rng(19)
    meshes = {n: tcompat.make_mesh((n,), ("ex",), devices=(CPU,) * n) for n in (1, 2)}
    caps = dict(slab_cap=128, key_in_cap=32, key_route_cap=32, nn_cap=256, no_cap=256,
                pair_route_cap=512, pair_cap=256)
    join = {n: tsharded.make_streaming_join_pipeline(
        meshes[n], tsharded.StreamJoinPlan(n_shards=n, **caps)) for n in (1, 2)}
    kk, rr = random_slab(rng, 128, 40, dead=0.2, first_row=0)
    owner = tsharded._positive_hash_np(kk) % 2
    halves = [make_slab([(int(k), int(r)) for k, r, o in zip(kk, rr, owner)
                         if k != PAD_KEY and o == s], 128) for s in (0, 1)]
    keys, rows = random_incoming(rng, 32, 24, first_row=40)
    one = join[1](*(torch.tensor(a) for a in (kk, rr, keys, rows)))
    two = join[2](torch.tensor(np.concatenate([h[0] for h in halves])),
                  torch.tensor(np.concatenate([h[1] for h in halves])),
                  torch.tensor(np.concatenate([keys[:16], np.full(16, PAD_KEY, np.int32),
                                               keys[16:], np.full(16, PAD_KEY, np.int32)])),
                  torch.tensor(np.concatenate([rows[:16], np.full(16, PAD_ID, np.int32),
                                               rows[16:], np.full(16, PAD_ID, np.int32)])))

    def pairs(out):
        left, right = out["left"].reshape(-1), out["right"].reshape(-1)
        ok = left != PAD_ID
        return sorted(zip(left[ok].tolist(), right[ok].tolist()))

    assert pairs(two) == pairs(one) and len(pairs(one)) > 0
    assert int(two["count"].sum()) == int(one["count"].sum())
    assert two["max_count"].tolist() == [int(two["count"].max())] * 2
    assert int(two["examined"].sum()) == int(one["examined"].sum())
    assert int(two["overflow"].sum()) == int(one["overflow"].sum()) == 0
    merged = (one["slab_keys"].numpy(), one["slab_rows"].numpy())
    for s in (0, 1):
        sk = two["slab_keys"].reshape(2, 128)[s].numpy()
        sr = two["slab_rows"].reshape(2, 128)[s].numpy()
        mine = (merged[0] != PAD_KEY) & (tsharded._positive_hash_np(merged[0]) % 2 == s)
        n = int(mine.sum())
        np.testing.assert_array_equal(sk[:n], merged[0][mine])
        np.testing.assert_array_equal(sr[:n], merged[1][mine])
        assert (sk[n:] == PAD_KEY).all()

    places, lengths, _, tf = world(21, n=40)
    t_eng = StreamingEngine(tf, EngineConfig(rho=4.5), device=CPU)
    L = places.shape[1]
    lo, hi = (np.sort(rng.integers(0, 40, size=(40, 2)), axis=1).astype(np.int32).T)
    world1 = np.full((64, L), -1, np.int32)
    world1[:40] = places
    g = np.arange(64)
    world2 = np.full((64, L), -1, np.int32)
    world2[(g % 2) * 32 + g // 2] = world1  # the round-robin slab
    for mode, chunks in (("replicate", 1), ("shuffle", 1), ("shuffle", 2)):
        scored = {}
        for n, slab in ((1, world1), (2, world2)):
            plan = tsharded.StreamShardPlan(n_shards=n, cap_local=64 // n, pair_cap=64 // n,
                                            hop_cap=64, out_cap=64, n_chunks=chunks)
            if mode == "replicate":
                plan = dataclasses.replace(plan, hop_cap=0, out_cap=plan.pair_cap)
            left = np.full((n, 64 // n), PAD_ID, np.int32)
            right = np.full((n, 64 // n), PAD_ID, np.int32)
            for s in range(n):
                seg = slice(s * 40 // n, (s + 1) * 40 // n)
                left[s, : seg.stop - seg.start], right[s, : seg.stop - seg.start] = lo[seg], hi[seg]
            fn = tsharded.make_streaming_score_pipeline(
                meshes[n], plan, betas=t_eng.betas, score_mode=mode, lcs_impl="fused",
                score_prune=True, prune_tau=4.5)
            out = fn(torch.tensor(slab), torch.tensor(left.reshape(-1)),
                     torch.tensor(right.reshape(-1)), t_eng.tables)
            assert int(out["overflow"].sum()) == 0
            ok = out["left"].reshape(-1) != PAD_ID
            scored[n] = (int(out["pruned"].sum()), sorted(zip(
                out["left"].reshape(-1)[ok].tolist(), out["right"].reshape(-1)[ok].tolist(),
                map(tuple, out["level_lcs"].reshape(ok.shape[0], -1)[ok].tolist()),
                out["mss"].reshape(-1)[ok].tolist())))
        assert scored[2] == scored[1] and scored[1][0] > 0 and scored[1][1], mode


# ---------------------------------------------------------------------------
# the streaming engine, update by update
# ---------------------------------------------------------------------------
def tombstones_examined(stream, p, ln):
    """The slab tombstones an update of rows (p, ln) examined: each of its
    rows' keys meets every resident tombstone of that key (the count
    mirror's dead ledger)."""
    if not p.shape[0]:
        return 0
    k_flat, _ = tdi.flat_row_keys(stream._new_row_keys(p, ln))
    dead = stream._join_stats.dead_counts
    return sum(dead.get(int(k), 0) for k in k_flat)


class DevicePair(Pair):
    """A JAX and a port device-join engine in lockstep, and the port's
    host-join engine beside them: every update equals the JAX one's (all
    counts but ``join_traces``) and the host join's result."""

    def __init__(self, jf, tf, cfg=None, **kw):
        super().__init__(jf, tf, cfg, DEVICE, **kw)
        cfg = {"rho": 2.0, **(cfg or {})}
        self.h = StreamingEngine(tf, EngineConfig(**cfg), device=CPU, **kw)
        self.tombstones = 0

    def update(self, p, ln, ttl=None):
        got = self.t.update(tbatch(p, ln), ttl=ttl)
        want = self.j.update(jbatch(p, ln), ttl=ttl)
        host = self.h.update(tbatch(p, ln), ttl=ttl)
        where = f"update {self.t.updates}"
        check_device_update(got, want, where)
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, field), getattr(host.scored, field)), where
        assert got.similar_pairs == host.similar_pairs and got.communities == host.communities
        # the host join drops retired rows from its buckets at once; the
        # slab keeps them as tombstones (examined, never emitted) until a
        # compaction, so its count exceeds the host's by exactly those
        tombs = tombstones_examined(self.t, p, ln)
        self.tombstones += tombs
        assert got.stats["pairs_examined"] == host.stats["pairs_examined"] + tombs, where
        assert (got.stats.get("num_pruned"), got.stats["num_candidates"]) == \
            (host.stats.get("num_pruned"), host.stats["num_candidates"]), where
        return got

    def retire(self, ids):
        n = super().retire(ids)
        assert self.h.retire(ids) == n
        return n


def check_device_update(got, want, where):
    """Everything ``assert_same`` holds, with ``join_traces`` held to the
    port's one-build-per-plan rule in place of the JAX trace count."""
    stats = dict(got.stats)
    assert stats.pop("join_traces") == got.stats["runner_builds"] - got.stats["score_traces"]
    assert want.stats["join_traces"] >= got.stats["join_traces"], where
    assert got.stats["driver_pair_rows"] == 0 and got.stats["host_index_entries"] == 0, where
    assert got.stats["delta_join"] == "device"
    shown = type(got)(scored=got.scored, similar_pairs=got.similar_pairs,
                      communities=got.communities, stats={**stats, "join_traces": 0})
    wanted = type(want)(scored=want.scored, similar_pairs=want.similar_pairs,
                        communities=want.communities, stats={**want.stats, "join_traces": 0})
    assert_same(shown, wanted, where)


SCHEDULE = [8, 8, 17, 25, 33]  # cuts: an empty piece, then growing widths


@pytest.mark.parametrize("backend,prune,community", [
    ("ssh", False, "unionfind"), ("ssh", True, "jit"), ("minhash", False, "cliques"),
    ("brp", True, "unionfind"),
])
def test_device_join_matches_jax_update_by_update(backend, prune, community):
    """Splits with an empty update, a TTL, a window, a retire and a
    compaction with a base shift: every update equals the JAX device join's
    and the port's host join's."""
    places, lengths, jf, tf = world(31, n=40)
    cfg = dict(backend=backend, score_prune=prune,
               community_mode="cliques" if community == "cliques" else "components")
    pair = DevicePair(jf, tf, cfg, components_impl="jit" if community == "jit" else "unionfind",
                      window=3)
    for u, (p, ln) in enumerate(pieces(places, lengths, SCHEDULE)):
        pair.update(p, ln, ttl=2 if u == 2 else None)
        if u == 3:
            pair.retire([18, 20, 24])
    for _ in range(2):
        got = pair.update(places[:0, :1], lengths[:0])
    t, j = pair.t, pair.j
    assert t.compactions >= 1 and t._base > 0
    assert (t.compactions, t._base) == (j.compactions, j._base)
    assert t.retired_total == j.retired_total > 0 and pair.tombstones > 0
    np.testing.assert_array_equal(t._places_dev.numpy(), np.asarray(j._places_dev))
    np.testing.assert_array_equal(t._slab_keys.numpy(), np.asarray(j._slab_keys))
    np.testing.assert_array_equal(t._slab_rows.numpy(), np.asarray(j._slab_rows))
    assert t._join_stats.counts == j._join_stats.counts
    assert got.stats["resident_bytes"] == t.resident_bytes() > 0


def test_join_slab_capacity_presizes_the_slab():
    places, lengths, jf, tf = world(32, n=30)
    pair = Pair(jf, tf, dict(community_mode="components"), DEVICE, join_slab_capacity=512)
    for p, ln in pieces(places, lengths, [10, 20]):
        check_device_update(pair.t.update(tbatch(p, ln)), pair.j.update(jbatch(p, ln)),
                            "slab floor")
    assert pair.t._slab_cap == pair.j._slab_cap == 512
    assert pair.t._slab_keys.shape == (512,)


def test_admission_refusal_leaves_the_device_world_untouched():
    places, lengths, jf, tf = world(33, n=24)
    first, second = pieces(places, lengths, [8])
    pair = Pair(jf, tf, dict(community_mode="components"), DEVICE)
    check_device_update(pair.t.update(tbatch(*first)), pair.j.update(jbatch(*first)), "first")
    budget = pair.t.resident_bytes()
    assert budget == pair.j.resident_bytes()
    pair.t.max_resident_bytes = pair.j.max_resident_bytes = budget
    before = (pair.t._slab_keys.clone(), pair.t._slab_rows.clone(), pair.t._places_dev.clone(),
              dict(pair.t._join_stats.counts), pair.t.n, pair.t._acc_n)
    with pytest.raises(CapacityExceeded) as err:
        pair.t.update(tbatch(*second))
    with pytest.raises(japi.CapacityExceeded) as jerr:
        pair.j.update(jbatch(*second))
    assert str(err.value) == str(jerr.value)
    after = (pair.t._slab_keys, pair.t._slab_rows, pair.t._places_dev,
             pair.t._join_stats.counts, pair.t.n, pair.t._acc_n)
    for a, b in zip(before, after):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    pair.t.max_resident_bytes = pair.j.max_resident_bytes = None
    check_device_update(pair.t.update(tbatch(*second)), pair.j.update(jbatch(*second)), "second")


def test_fault_injection_retries_and_matches_jax(monkeypatch):
    """REPRO_FAULT_INJECT=1 derates the fresh plans: the join reruns (and
    compacts first when the slab holds tombstones) and every update still
    equals the JAX engine's and the run without it."""
    places, lengths, jf, tf = world(34, n=27)
    split = pieces(places, lengths, [9, 18])
    cfg = dict(backend="minhash", community_mode="components")
    ref = StreamingEngine(tf, EngineConfig(rho=2.0, **cfg), ExecutionPlan(**DEVICE),
                          device=CPU, window=2)
    wants = [ref.update(tbatch(p, ln)) for p, ln in split]
    monkeypatch.setenv("REPRO_FAULT_INJECT", "1")
    pair = Pair(jf, tf, cfg, DEVICE, window=2)
    attempts = 0
    for (p, ln), want in zip(split, wants):
        got = pair.t.update(tbatch(p, ln))
        check_device_update(got, pair.j.update(jbatch(p, ln)), "fault injection")
        attempts += pair.t.join_timing["attempts"] - 1
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, field), getattr(want.scored, field))
        assert got.similar_pairs == want.similar_pairs
    assert attempts > 0  # at least one retry fired


def test_refuses_a_lossy_commit(monkeypatch):
    """A join that still overflows after the retries (an undersized plan,
    or the join function patched to report overflow) raises and adopts
    nothing: the slab and the count mirror stay as they were."""
    places, lengths, _, tf = world(35, n=30)
    first, second = pieces(places, lengths, [15])

    def tiny(self, keys_flat, n_shards, stats, *, floor_pow2=4):
        return tsharded.StreamJoinPlan(n_shards=n_shards, slab_cap=4, key_in_cap=256,
                                       key_route_cap=4, nn_cap=4, no_cap=4,
                                       pair_route_cap=4, pair_cap=4)

    with monkeypatch.context() as m:
        m.setattr(CapacityPlanner, "plan_stream_join", tiny)
        st = StreamingEngine(tf, EngineConfig(rho=2.0, max_retries=0), ExecutionPlan(**DEVICE),
                             device=CPU)
        with pytest.raises(CapacityExceeded, match="refusing to commit"):
            st.update(tbatch(places, lengths))
        assert st._join_stats.num_keys == 0 and int((st._slab_rows != PAD_ID).sum()) == 0

    st = StreamingEngine(tf, EngineConfig(rho=2.0), ExecutionPlan(**DEVICE), device=CPU)
    st.update(tbatch(*first))
    before = (st._slab_keys.clone(), st._slab_rows.clone(), dict(st._join_stats.counts))
    real = st._join_runner

    def overflowing(jplan):
        run = real(jplan)

        def patched(*args):
            out = dict(run(*args))
            out["overflow"] = out["overflow"] + torch.tensor([[0, 1, 0, 0]], dtype=torch.int32)
            return out

        return patched

    monkeypatch.setattr(st, "_join_runner", overflowing)
    with pytest.raises(CapacityExceeded, match="refusing to commit"):
        st.update(tbatch(*second))
    # the slab may have grown (padding at its end) but holds what it held
    n = before[0].shape[0]
    assert torch.equal(st._slab_keys[:n], before[0]) and torch.equal(st._slab_rows[:n], before[1])
    assert bool((st._slab_keys[n:] == PAD_KEY).all() and (st._slab_rows[n:] == PAD_ID).all())
    assert st._join_stats.counts == before[2]
    assert st.join_timing["attempts"] == st.planner.max_retries + 1


def test_join_timing_splits_mirror_and_program():
    places, lengths, _, tf = world(36, n=20)
    st = StreamingEngine(tf, EngineConfig(rho=2.0), ExecutionPlan(**DEVICE), device=CPU)
    res = st.update(tbatch(places, lengths))
    t = st.join_timing
    assert t["attempts"] == 1 and t["mirror_s"] > 0 and t["program_ms"] > 0
    assert t["mirror_s"] + t["program_ms"] / 1e3 <= res.stats["t_delta_join"]
    assert res.stats["driver_mirror_keys"] == st._join_stats.num_keys > 0
    assert res.stats["join_pair_cap"] >= res.stats["score_pair_cap"] > 0
    st.update(tbatch(places[:0, :1], lengths[:0]))
    assert st.join_timing["attempts"] == 0


def test_refusals():
    places, lengths, _, tf = world(0, n=12)
    # shuffle mode and two shards run on the device join, and equal one shard
    for plan in (ExecutionPlan(delta_join="device", score_mode="shuffle"),
                 ExecutionPlan(delta_join="device", n_shards=2, devices=(CPU,) * 2)):
        got = StreamingEngine(tf, plan=plan, device=CPU)
        want = StreamingEngine(tf, plan=ExecutionPlan(**DEVICE), device=CPU)
        for p, ln in pieces(places, lengths, [5]):
            assert_same_result(got.update(tbatch(p, ln)), want.update(tbatch(p, ln)), str(plan))
    with pytest.raises(NotPortedError, match="autotune"):
        StreamingEngine(tf, plan=ExecutionPlan(delta_join="device", n_shards=2, autotune=True),
                        device=CPU)
    # the host join ignores score_mode, as the JAX engine's one-device path
    assert StreamingEngine(tf, plan=ExecutionPlan(score_mode="shuffle"), device=CPU)._index
    assert tstreaming._derate_cap(1024) == 128 and tstreaming._derate_cap(8) == 16


def test_one_shot_engine_ignores_delta_join():
    """``AnotherMeEngine.run`` reads neither ``delta_join`` nor
    ``score_mode``, as the JAX one-shot engine: the same result."""
    from repro_torch.api import AnotherMeEngine

    places, lengths, _, tf = world(37, n=30)
    cfg = EngineConfig(rho=2.0, community_mode="components")
    host = AnotherMeEngine(tf, cfg, device=CPU).run(tbatch(places, lengths))
    dev = AnotherMeEngine(tf, cfg, ExecutionPlan(delta_join="device", score_mode="shuffle"),
                          device=CPU).run(tbatch(places, lengths))
    for field in ("left", "right", "level_lcs", "mss", "count"):
        assert torch.equal(getattr(dev.scored, field), getattr(host.scored, field))
    assert dev.similar_pairs == host.similar_pairs and dev.communities == host.communities
