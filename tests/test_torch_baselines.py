"""The port's baselines (MinHash, BRP, UDF, centralized) against the JAX
package, on the CPU.

The same numpy inputs go through both packages.  Integer outputs
(signatures, band and bucket keys, candidate buffers, ``level_lcs``) must be
equal and float32 ``mss`` bit-equal (tolerance 0: both round MSS as one
forward FMA chain); similar-pair sets and communities must be equal.

* MinHash replays the reference's wrapping int32 hash: the port's plain
  signatures against ``repro.core.minhash``, and the port's op (the kernel
  wrapper, which takes the plain version for a CPU tensor) against the JAX
  Pallas op in interpret mode (``block_b=64``), as the JAX package's own
  golden tests run it.
* The engine, per backend and community mode, and in the subtrajectory mode
  for the three key backends, against the JAX engine (``lcs_impl``
  "wavefront" on both sides).
* ``run_anotherme``, the registry, ``centralized_similar_pairs`` and
  ``udf_pipeline`` against their JAX counterparts, and the paper's accuracy
  facts on the port's own centralized truth.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro.data as jdata
from repro.core import brp as jbrp
from repro.core import minhash as jmh
from repro.core.shingling import windowed_types as j_windowed_types
from repro.kernels.minhash import ops as jmh_ops
from repro_torch.api import (
    AnotherMeEngine, CallableBackend, EngineConfig, available_backends, get_backend,
)
from repro_torch.core import (
    AnotherMeConfig, brp_candidates, centralized_similar_pairs, encode_batch,
    forest_tables, maximal_cliques, minhash_candidates, qa1, qa2, run_anotherme,
    type_codes, udf_pipeline,
)
from repro_torch.core import brp as tbrp
from repro_torch.core import minhash as tmh
from repro_torch.data import synthetic_setup
from repro_torch.kernels.minhash import kernel as tmh_kernel
from repro_torch.kernels.minhash import ops as tmh_ops
from repro_torch.kernels.minhash import ref as tmh_ref

CPU = "cpu"
BACKENDS = ("ssh", "minhash", "brp", "udf")
WORLD = dict(num_types=10, classes_per_type=5, num_places=200, seed=7)
# fig10's world (benchmarks/fig10_accuracy.py), and its subtrajectory rows
FIG10 = dict(num_types=10, classes_per_type=5, num_places=500, seed=0)
SUB_ROWS = dict(min_len=10, max_len=20)


def T(x):
    return torch.as_tensor(np.array(x))  # a copy: JAX arrays are read-only


def N(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_scored_equal(got, want):
    for field in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        g, w = N(getattr(got, field)), N(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def assert_same_run(got, want, stats=("pair_capacity", "num_candidates", "join_overflow",
                                      "num_similar", "num_communities")):
    assert got.similar_pairs == want.similar_pairs
    assert got.communities == want.communities
    assert_scored_equal(got.scored, want.scored)
    for key in stats:
        assert got.stats[key] == want.stats[key], key


@pytest.fixture(scope="module")
def world():
    """(port batch, port forest, JAX batch, JAX forest): 150 trajectories."""
    jb, jf = jdata.synthetic_setup(150, **WORLD)
    tb, tf = synthetic_setup(150, device=CPU, **WORLD)
    return tb, tf, jb, jf


@pytest.fixture(scope="module")
def jax_run(world):
    cache = {}

    def get(**cfg):
        key = tuple(sorted(cfg.items()))
        if key not in cache:
            _, _, jb, jf = world
            cache[key] = japi.AnotherMeEngine(jf, japi.EngineConfig(**cfg)).run(jb)
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# MinHash signatures: the plain version and the op, bit-equal
# ---------------------------------------------------------------------------
def _minhash_case(name):
    """(types [N, L], lengths [N]) of a named edge case."""
    rng = np.random.default_rng(len(name))
    if name.startswith("batch"):                 # TestMinhashGolden's batches
        n, L = int(name[5:]), 10
        return (rng.integers(0, 30, size=(n, L)).astype(np.int32),
                rng.integers(1, L + 1, size=n).astype(np.int32))
    if name == "length_one":
        return rng.integers(0, 30, size=(33, 12)).astype(np.int32), np.ones(33, np.int32)
    if name == "identical":
        return np.full((50, 8), 4, np.int32), np.full((50,), 8, np.int32)
    if name == "empty_and_long_rows":            # lengths 0 and past L
        return (rng.integers(0, 30, size=(40, 6)).astype(np.int32),
                rng.integers(0, 9, size=40).astype(np.int32))
    assert name == "wide_codes"                  # every limb product wraps
    return (rng.integers(0, 1 << 20, size=(129, 10)).astype(np.int32),
            rng.integers(0, 11, size=129).astype(np.int32))


MINHASH_CASES = ("batch1", "batch67", "batch130", "length_one", "identical",
                 "empty_and_long_rows", "wide_codes")


def test_hash_params_match_jax():
    for num_perm, seed in ((16, 0), (1, 3), (8, 11)):
        ja, jb = jmh._hash_params(num_perm, seed)
        ta, tb = tmh._hash_params(num_perm, seed)
        np.testing.assert_array_equal(np.asarray(ja), ta)
        np.testing.assert_array_equal(np.asarray(jb), tb)
        ab = tmh.hash_table(num_perm, seed, CPU)
        assert ab.dtype == torch.int32 and ab.shape == (num_perm, 2)
        np.testing.assert_array_equal(N(ab), np.stack([ta, tb], axis=1))


@pytest.mark.parametrize("num_perm", [1, 8, 16])
@pytest.mark.parametrize("case", MINHASH_CASES)
def test_minhash_signatures_bit_equal(case, num_perm):
    types, lengths = _minhash_case(case)
    want = np.asarray(jmh.minhash_signatures(jnp.asarray(types), jnp.asarray(lengths),
                                             num_perm=num_perm, seed=0))
    got = tmh.minhash_signatures(T(types), T(lengths), num_perm=num_perm, seed=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(N(got), want)
    np.testing.assert_array_equal(N(tmh_ref.minhash_signatures(T(types), T(lengths),
                                                               num_perm=num_perm)), want)
    if case == "wide_codes":
        assert (want < 0).mean() > 0.5, "the wrapped hash should give mostly negative signatures"
    if case == "identical":
        assert (want == want[0]).all()


@pytest.mark.parametrize("num_perm", [8, 16])
@pytest.mark.parametrize("case", ["batch67", "batch130", "wide_codes", "empty_and_long_rows"])
def test_minhash_op_matches_pallas_interpret(case, num_perm):
    types, lengths = _minhash_case(case)
    want = np.asarray(jmh_ops.minhash_signatures(jnp.asarray(types), jnp.asarray(lengths),
                                                 num_perm=num_perm, block_b=64))
    tmh_kernel.minhash_kernel.launches = 0
    got = tmh_ops.minhash_signatures(T(types), T(lengths), num_perm=num_perm)
    np.testing.assert_array_equal(N(got), want)
    assert tmh_kernel.minhash_kernel.launches == 0, "a CPU tensor must not launch the kernel"


def test_minhash_entry_points_go_through_the_op(monkeypatch):
    """core's signatures and candidates key through the kernel's op (which
    launches the kernel on a CUDA tensor); on the CPU that is the plain
    version."""
    types, lengths = _minhash_case("batch130")
    calls = []
    op = tmh_ops.minhash_signatures

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return op(*args, **kwargs)

    monkeypatch.setattr(tmh_ops, "minhash_signatures", spy)
    got = tmh.minhash_signatures(T(types), T(lengths), num_perm=8, seed=3)
    np.testing.assert_array_equal(N(got), N(tmh_ref.minhash_signatures(
        T(types), T(lengths), num_perm=8, seed=3)))
    cand = minhash_candidates(T(types), T(lengths), pair_capacity=1 << 12)
    assert calls == [dict(num_perm=8, seed=3), dict(num_perm=16, seed=0)]
    want = jmh.minhash_candidates(jnp.asarray(types), jnp.asarray(lengths), pair_capacity=1 << 12)
    for field in ("left", "right"):
        np.testing.assert_array_equal(N(getattr(cand, field)), np.asarray(getattr(want, field)))


def test_minhash_wrappers_reject_bad_operands():
    types, lengths = _minhash_case("batch67")
    ab = tmh.hash_table(4, 0, CPU)
    with pytest.raises(TypeError, match="int32"):
        tmh_kernel.minhash_kernel(T(types).long(), T(lengths), ab)
    with pytest.raises(ValueError, match=r"\[P, 2\]"):
        tmh_kernel.minhash_kernel(T(types), T(lengths), ab[:, :1])
    with pytest.raises(ValueError, match="lengths"):
        tmh_kernel.minhash_plain(T(types), T(lengths)[:-1], ab)


# ---------------------------------------------------------------------------
# band and bucket keys on fig10's world and on windowed views
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fig10_types():
    """{view: (types, lengths)} as numpy: fig10's world at N = 2,000 and the
    window view (W = 8) of its subtrajectory rows at N = 300."""
    out = {}
    jb, jf = jdata.synthetic_setup(2000, **FIG10)
    enc = jcore.encode_batch(jb, jcore.forest_tables(jf))
    out["whole"] = (np.asarray(jcore.type_codes(enc)), np.asarray(jb.lengths))
    jb, jf = jdata.synthetic_setup(300, **FIG10, **SUB_ROWS)
    enc = jcore.encode_batch(jb, jcore.forest_tables(jf))
    wt, wl = j_windowed_types(jcore.type_codes(enc), jb.lengths, window=8)
    out["windows"] = (np.asarray(wt), np.asarray(wl))
    return out


@pytest.mark.parametrize("view", ["whole", "windows"])
def test_band_and_bucket_keys_bit_equal(fig10_types, view):
    types, lengths = fig10_types[view]
    sig = jmh.minhash_signatures(jnp.asarray(types), jnp.asarray(lengths))
    for bands in (4, 2):
        want = np.asarray(jmh.minhash_band_keys(sig, bands=bands))
        got = tmh.minhash_band_keys(T(sig), bands=bands)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(N(got), want)
    for bucket_length, num_proj in ((2.0, 4), (0.7, 3)):
        want = np.asarray(jbrp.brp_bucket_keys(
            jnp.asarray(types), jnp.asarray(lengths), num_types=10, num_proj=num_proj,
            bucket_length=bucket_length))
        got = tbrp.brp_bucket_keys(T(types), T(lengths), num_types=10, num_proj=num_proj,
                                   bucket_length=bucket_length)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(N(got), want)


def test_band_key_guards():
    sig = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        tmh.minhash_band_keys(sig, bands=3)
    with pytest.raises(ValueError, match="overflows int32"):
        tmh.minhash_band_keys(sig, bands=4, key_space=2**30)


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_brp_keys_refuse_reduced_precision_matmul(precision):
    types, lengths = _minhash_case("batch67")
    want = tbrp.brp_bucket_keys(T(types), T(lengths), num_types=30)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        with pytest.raises(RuntimeError, match="needs full float32 matmul"):
            tbrp.brp_bucket_keys(T(types), T(lengths), num_types=30)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(tbrp.brp_bucket_keys(T(types), T(lengths), num_types=30), want)


def test_brp_counts_ignore_padding_and_codes_out_of_range():
    types = T([[0, 1, 1, 3, 9], [2, -1, 4, 2, 0]]).int()
    got = tbrp.type_counts(types, T([4, 5]).int(), num_types=4)
    np.testing.assert_array_equal(N(got), [[1, 2, 0, 1], [1, 0, 2, 0]])


# ---------------------------------------------------------------------------
# the engine per backend, both community modes, and the subtrajectory mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("community_mode", ["cliques", "components"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_jax_per_backend(world, jax_run, backend, community_mode):
    tb, tf, _, _ = world
    cfg = dict(backend=backend, community_mode=community_mode)
    want = jax_run(**cfg)
    got = AnotherMeEngine(tf, EngineConfig(**cfg), device=CPU).run(tb)
    assert_same_run(got, want)
    assert len(want.similar_pairs) > 0


@pytest.fixture(scope="module")
def sub_world():
    kw = dict(num_types=10, classes_per_type=5, num_places=200, seed=3, **SUB_ROWS)
    jb, jf = jdata.synthetic_setup(60, **kw)
    tb, tf = synthetic_setup(60, device=CPU, **kw)
    return tb, tf, jb, jf


@pytest.mark.parametrize("backend", ["minhash", "brp", "udf"])
def test_subtraj_engine_matches_jax_per_backend(sub_world, backend):
    tb, tf, jb, jf = sub_world
    cfg = dict(backend=backend, subtraj_window=8, rho=2.0)
    want = japi.AnotherMeEngine(jf, japi.EngineConfig(**cfg)).run(jb)
    got = AnotherMeEngine(tf, EngineConfig(lcs_impl="fused", **cfg), device=CPU).run(tb)
    assert_same_run(got, want, stats=("pair_capacity", "num_window_pairs", "num_traj_pairs",
                                      "subtraj_windows", "num_similar"))
    assert len(want.similar_pairs) > 0


def test_backend_options_forwarded(world, jax_run):
    tb, tf, _, _ = world
    for opts in ({"num_perm": 4, "bands": 2}, {"num_perm": 16, "bands": 8, "seed": 5}):
        want = jax_run(backend="minhash", backend_options=tuple(opts.items()))
        got = AnotherMeEngine(tf, EngineConfig(backend="minhash", backend_options=opts),
                              device=CPU).run(tb)
        assert_same_run(got, want)
    want = jax_run(backend="brp", backend_options=(("bucket_length", 1.0), ("num_proj", 2)))
    got = AnotherMeEngine(tf, EngineConfig(backend="brp", backend_options={
        "bucket_length": 1.0, "num_proj": 2}), device=CPU).run(tb)
    assert_same_run(got, want)
    default = jax_run(backend="minhash")
    assert want.stats["num_candidates"] != default.stats["num_candidates"]


def test_registry_lists_the_four_backends():
    assert set(BACKENDS) == set(available_backends())
    with pytest.raises(ValueError) as ei:
        get_backend("no-such-hash")
    msg = str(ei.value)
    assert "no-such-hash" in msg and all(name in msg for name in BACKENDS)
    assert get_backend("minhash", num_perm=32, bands=8).num_perm == 32
    assert get_backend("brp").supports_sharded and not CallableBackend(None).supports_sharded


def test_udf_backend_guards_q_to_the_k(world):
    tb, tf, _, _ = world
    eng = AnotherMeEngine(tf, EngineConfig(backend="udf", k=10), device=CPU)
    with pytest.raises(ValueError, match="overflows int32"):
        eng.run(tb)


# ---------------------------------------------------------------------------
# the legacy entry point
# ---------------------------------------------------------------------------
def _legacy_fns(num_types, package):
    """candidate_fn of each hash baseline, as tests/test_api_engine.py builds
    them, for the JAX package (``jcore``) or the port's core."""
    mh = package.minhash_candidates
    brp = package.brp_candidates
    tc = package.type_codes
    return {
        "minhash": lambda e, b: mh(tc(e), b.lengths, num_perm=16, bands=4, pair_capacity=1 << 18),
        "brp": lambda e, b: brp(tc(e), b.lengths, num_types=num_types, pair_capacity=1 << 18),
    }


@pytest.mark.parametrize("backend", ["minhash", "brp"])
def test_run_anotherme_candidate_fn_matches_jax(world, jax_run, backend):
    import repro_torch.core as tcore

    tb, tf, jb, jf = world
    want = jcore.run_anotherme(jb, jf, jcore.AnotherMeConfig(),
                               candidate_fn=_legacy_fns(jf.num_types, jcore)[backend])
    got = run_anotherme(tb, tf, AnotherMeConfig(),
                        candidate_fn=_legacy_fns(tf.num_types, tcore)[backend])
    assert_same_run(got, want)
    assert got.stats["pair_capacity"] == 1 << 18
    # the registry backend finds the same similar pairs through its own join
    assert got.similar_pairs == jax_run(backend=backend).similar_pairs
    assert got.stats["t_candidates"] == pytest.approx(got.stats["t_keys"] + got.stats["t_join"])
    assert got.stats["t_shingle"] < got.stats["t_join"]


def test_run_anotherme_config_and_impl_names(world, jax_run):
    tb, tf, jb, jf = world
    got = run_anotherme(tb, tf, AnotherMeConfig(lcs_impl="ref", community_mode="components"))
    want = jcore.run_anotherme(jb, jf, jcore.AnotherMeConfig(lcs_impl="ref",
                                                             community_mode="components"))
    assert_same_run(got, want)
    assert AnotherMeConfig().as_engine_config("brp") == EngineConfig(backend="brp")
    with pytest.raises(ValueError, match="lcs_impl"):
        run_anotherme(tb, tf, AnotherMeConfig(lcs_impl="diagonal"))


def test_callable_backend_refused_in_subtraj_mode(world):
    _, tf, _, _ = world
    backend = CallableBackend(lambda e, b: None)
    with pytest.raises(ValueError, match="subtrajectory mode needs key-based"):
        AnotherMeEngine(tf, EngineConfig(subtraj_window=4), backend=backend, device=CPU)


# ---------------------------------------------------------------------------
# centralized and UDF baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1000, 1 << 16])
def test_centralized_similar_pairs_matches_jax(world, chunk):
    tb, tf, jb, jf = world
    want = jcore.centralized_similar_pairs(
        jcore.encode_batch(jb, jcore.forest_tables(jf)), rho=2.0, chunk=chunk)
    got = centralized_similar_pairs(encode_batch(tb, forest_tables(tf, device=CPU)),
                                    rho=2.0, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(got[0]) > 0


def test_udf_pipeline_matches_jax(world):
    tb, tf, jb, jf = world
    want_set, want_scores = jcore.udf_pipeline(np.asarray(jb.places), np.asarray(jb.lengths), jf)
    got_set, got_scores = udf_pipeline(tb.places, tb.lengths, tf)
    assert got_set == want_set and len(want_set) > 0
    assert got_scores == want_scores


# ---------------------------------------------------------------------------
# the paper's accuracy facts, on the port's own centralized truth
# (tests/test_pipeline_accuracy.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def truth_world():
    batch, forest = synthetic_setup(250, device=CPU, **WORLD)
    cl, cr, _ = centralized_similar_pairs(encode_batch(batch, forest_tables(forest, device=CPU)),
                                          rho=2.0)
    pairs = {(int(a), int(b)) for a, b in zip(cl, cr)}
    return batch, forest, pairs, maximal_cliques(pairs)


def test_accuracy_facts(truth_world):
    batch, forest, cen_pairs, cen_comms = truth_world
    res = {name: AnotherMeEngine(forest, EngineConfig(backend=name), device=CPU).run(batch)
           for name in BACKENDS}
    # AnotherMe == the centralized truth: QA1 = QA2 = 100%
    assert qa2(res["ssh"].similar_pairs, cen_pairs) == 1.0
    assert res["ssh"].similar_pairs == cen_pairs
    assert qa1(res["ssh"].communities, cen_comms) == 1.0
    assert res["ssh"].communities == cen_comms
    # the UDF is the same logic
    assert udf_pipeline(batch.places, batch.lengths, forest)[0] == cen_pairs
    assert res["udf"].similar_pairs == cen_pairs
    # MinHash loses accuracy, BRP loses at least as much
    mh, brp = qa2(res["minhash"].similar_pairs, cen_pairs), qa2(res["brp"].similar_pairs, cen_pairs)
    assert mh < 0.9
    assert brp <= mh
    # and the legacy candidate_fns agree with the registry backends
    legacy = run_anotherme(batch, forest, candidate_fn=lambda e, b: minhash_candidates(
        type_codes(e), b.lengths, pair_capacity=1 << 18))
    assert legacy.similar_pairs == res["minhash"].similar_pairs
    legacy = run_anotherme(batch, forest, candidate_fn=lambda e, b: brp_candidates(
        type_codes(e), b.lengths, num_types=forest.num_types, pair_capacity=1 << 18))
    assert legacy.similar_pairs == res["brp"].similar_pairs
