"""The port's subtrajectory mode against the JAX package, on the CPU.

``EngineConfig(subtraj_window=W, subtraj_stride=s)`` scores sliding windows
as virtual rows and folds them back to trajectory pairs.  For every
``lcs_impl`` name, W < L and W >= L, stride 1 and 2, ``score_prune`` on and
off and both community modes, the port's engine (``device="cpu"``) must
give the JAX engine's scored buffer (``left``/``right``/``level_lcs``
equal, float32 ``mss`` bit-equal: tolerance 0), ``similar_pairs`` and
``communities``.  The JAX engine runs ``lcs_impl="wavefront"``: its own
tests pin its other impls to that one.  The windowed building blocks
(coordinates, the window view, the windowed scorers) are held bit-equal to
their JAX counterparts one by one, the fused scorer's plain version against
the JAX Pallas kernel in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.shingling as jsh
import repro.core.similarity as jsim
import repro.core.subtraj as jsub
import repro.data as jdata
from repro.kernels.lcs import fused as jfused
from repro.kernels.lcs import ops as jops
from repro_torch.api import LCS_IMPLS, AnotherMeEngine, CandidateBackend, EngineConfig
from repro_torch.api.backends import register_backend
from repro_torch.core import shingling as tsh
from repro_torch.core import similarity as tsim
from repro_torch.core import subtraj as tsub
from repro_torch.core.types import PAD_ID
from repro_torch.data import synthetic_setup
from repro_torch.kernels.lcs import fused as tfused
from repro_torch.kernels.lcs import kernel as tkernel
from repro_torch.kernels.lcs import ops as tops

CPU = "cpu"
WORLD = dict(num_types=20, classes_per_type=4, num_places=120, seed=5, min_len=2, max_len=11)
N_TRAJ, K = 100, 2

# (window, stride): W < L with stride 1 and 2, and W >= L (one window a row)
GEOMETRIES = {"w5_s1": (5, 1), "w4_s2": (4, 2), "w16_s1": (16, 1)}
# each impl and geometry runs once unpruned with cliques and once pruned
# with components; rho 2.2 leaves pairs for the prune bound to drop
RUNS = {
    "cliques": dict(score_prune=False, community_mode="cliques", rho=1.5),
    "prune_components": dict(score_prune=True, community_mode="components", rho=2.2),
}


def T(x):
    return torch.as_tensor(np.array(x))  # a copy: JAX arrays are read-only


def N(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want):
    got, want = N(got), N(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def world():
    jb, jf = jdata.synthetic_setup(N_TRAJ, **WORLD)
    tb, tf = synthetic_setup(N_TRAJ, device=CPU, **WORLD)
    return tb, tf, jb, jf


@functools.lru_cache(maxsize=None)
def _jax_result(geometry, run):
    jb, jf = jdata.synthetic_setup(N_TRAJ, **WORLD)
    W, s = GEOMETRIES[geometry]
    cfg = japi.EngineConfig(k=K, subtraj_window=W, subtraj_stride=s, **RUNS[run])
    return japi.AnotherMeEngine(jf, cfg).run(jb)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("impl", LCS_IMPLS)
def test_engine_matches_jax(world, impl, geometry, run):
    tb, tf, _, _ = world
    want = _jax_result(geometry, run)
    W, s = GEOMETRIES[geometry]
    cfg = EngineConfig(k=K, subtraj_window=W, subtraj_stride=s, lcs_impl=impl, **RUNS[run])
    got = AnotherMeEngine(tf, cfg, device=CPU).run(tb)
    for field in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        assert_same(getattr(got.scored, field), getattr(want.scored, field))
    assert got.similar_pairs == want.similar_pairs and len(want.similar_pairs) > 0
    assert got.communities == want.communities
    keys = ["pair_capacity", "num_candidates", "join_overflow", "num_window_pairs",
            "num_traj_pairs", "num_similar", "num_communities", "subtraj_windows"]
    if RUNS[run]["score_prune"]:
        keys += ["num_pruned", "post_prune_capacity"]
        assert want.stats["num_pruned"] > 0
    for key in keys:
        assert got.stats[key] == want.stats[key], key
    assert got.stats["t_aggregate"] >= 0.0


def test_w_ge_l_degenerates_to_whole_trajectory(world):
    tb, tf, _, _ = world
    L = tb.max_len
    whole = AnotherMeEngine(tf, EngineConfig(k=K, rho=1.5), device=CPU).run(tb)
    win = AnotherMeEngine(tf, EngineConfig(k=K, rho=1.5, subtraj_window=L + 7),
                          device=CPU).run(tb)
    assert win.stats["subtraj_windows"] == 1
    assert win.similar_pairs == whole.similar_pairs
    assert win.communities == whole.communities
    valid = N(whole.scored.left) != PAD_ID
    for field in ("left", "right", "level_lcs", "mss"):
        assert_same(getattr(win.scored, field), N(getattr(whole.scored, field))[valid])


def test_cpu_engine_never_launches_kernels(world):
    tb, tf, _, _ = world
    tkernel.lcs_kernel.launches = tfused.fused_windowed_gather_score.launches = 0
    for impl in ("kernel", "pallas", "fused", "fused-pallas"):
        AnotherMeEngine(tf, EngineConfig(k=K, subtraj_window=5, lcs_impl=impl), device=CPU).run(tb)
    assert tkernel.lcs_kernel.launches == 0
    assert tfused.fused_windowed_gather_score.launches == 0


def test_engine_rejects_bad_subtraj_configs(world):
    _, tf, _, _ = world
    with pytest.raises(ValueError, match="subtraj_window must be positive"):
        AnotherMeEngine(tf, EngineConfig(subtraj_window=0), device=CPU)
    with pytest.raises(ValueError, match="subtraj_stride must be positive"):
        AnotherMeEngine(tf, EngineConfig(subtraj_window=4, subtraj_stride=0), device=CPU)

    class Keyless(CandidateBackend):
        name = "keyless"

    register_backend("test-keyless", Keyless)
    try:
        with pytest.raises(ValueError, match="subtrajectory mode needs key-based"):
            AnotherMeEngine(tf, EngineConfig(backend="test-keyless", subtraj_window=4),
                            device=CPU)
    finally:
        from repro_torch.api.backends import _REGISTRY

        _REGISTRY.pop("test-keyless", None)


# ---------------------------------------------------------------------------
# coordinates and the window view
# ---------------------------------------------------------------------------
def test_num_windows_edges():
    cases = [(10, 4, 1), (10, 4, 2), (10, 4, 3), (3, 8, 1), (4, 4, 1), (20, 8, 1), (11, 1, 5)]
    for L, W, s in cases:
        assert tsub.num_windows(L, W, s) == jsub.num_windows(L, W, s)
    assert tsub.num_windows(10, 4, 1) == 7
    assert tsub.num_windows(3, 8, 1) == 1
    with pytest.raises(ValueError):
        tsub.num_windows(10, 0, 1)
    with pytest.raises(ValueError):
        tsub.num_windows(10, 4, 0)


def test_window_lengths_matches_loop():
    lengths = np.array([0, 3, 7, 10], np.int32)
    nw = tsub.num_windows(10, 4, 2)
    want = np.array([max(0, min(int(n) - j * 2, 4)) for n in lengths for j in range(nw)], np.int32)
    got_np = tsub.window_lengths(lengths, max_len=10, window=4, stride=2)
    np.testing.assert_array_equal(got_np, want)
    assert isinstance(got_np, np.ndarray)
    assert_same(tsub.window_lengths(T(lengths), max_len=10, window=4, stride=2), want)
    assert_same(got_np, jsub.window_lengths(lengths, max_len=10, window=4, stride=2))


def test_aggregate_window_pairs_tie_break_and_filtering():
    nw = 3
    # a PAD row, a same-trajectory pair (dropped), and three window pairs of
    # trajectories (1, 2) with a tie at mss 2.0: the SMALLEST
    # (window_lo, window_hi) wins
    left = np.array([PAD_ID, 3, 5, 4, 3], np.int32)
    right = np.array([0, 4, 6, 7, 8], np.int32)
    lvl = np.array([[9], [5], [4], [2], [1]], np.int32)
    mss = np.array([9.0, 1.0, 2.0, 2.0, 1.5], np.float32)
    tl, tr, tlvl, tmss = tsub.aggregate_window_pairs(left, right, lvl, mss, nw=nw)
    np.testing.assert_array_equal(tl, [1])
    np.testing.assert_array_equal(tr, [2])
    np.testing.assert_array_equal(tlvl, [[2]])
    np.testing.assert_array_equal(tmss, np.float32(2.0))
    empty = tsub.aggregate_window_pairs(left[:2], right[:2], lvl[:2], mss[:2], nw=nw)
    assert [a.shape for a in empty] == [(0,), (0,), (0, 1), (0,)]


def test_aggregate_window_pairs_equals_jax_on_random_ties():
    rng = np.random.default_rng(3)
    P, nw = 5000, 4
    left = rng.integers(0, 60, size=P).astype(np.int32)
    right = rng.integers(0, 60, size=P).astype(np.int32)
    left[rng.random(P) < 0.1] = PAD_ID
    lvl = rng.integers(0, 5, size=(P, 3)).astype(np.int32)
    mss = (rng.integers(0, 6, size=P) / 2).astype(np.float32)  # many ties
    got = tsub.aggregate_window_pairs(left, right, lvl, mss, nw=nw)
    want = jsub.aggregate_window_pairs(left, right, lvl, mss, nw=nw)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("case", ["random ties", "tie break and filtering", "empty"])
def test_aggregate_window_pairs_on_tensors_equals_jax(case):
    """The fold on tensors (the engines' path, on the buffers' device) gives
    the JAX package's numpy fold, arrays and dtypes."""
    rng = np.random.default_rng(7)
    if case == "random ties":
        P, nw = 20000, 5
        left = rng.integers(0, 400, size=P).astype(np.int32)
        right = rng.integers(0, 400, size=P).astype(np.int32)
        left[rng.random(P) < 0.1] = PAD_ID
        lvl = rng.integers(0, 5, size=(P, 3)).astype(np.int32)
        mss = (rng.integers(0, 6, size=P) / 2).astype(np.float32)
    else:
        nw = 3
        left = np.array([PAD_ID, 3, 5, 4, 3], np.int32)
        right = np.array([0, 4, 6, 7, 8], np.int32)
        lvl = np.array([[9], [5], [4], [2], [1]], np.int32)
        mss = np.array([9.0, 1.0, 2.0, 2.0, 1.5], np.float32)
        if case == "empty":
            left, right, lvl, mss = left[:2], right[:2], lvl[:2], mss[:2]
    got = tsub.aggregate_window_pairs(*(torch.as_tensor(a) for a in (left, right, lvl, mss)),
                                      nw=nw)
    want = jsub.aggregate_window_pairs(left, right, lvl, mss, nw=nw)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window,stride", [(5, 1), (4, 2), (3, 3), (16, 1)])
def test_windowed_types_and_keys_bit_equal(window, stride):
    rng = np.random.default_rng(window * 10 + stride)
    n, L = 40, 11
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    types = rng.integers(0, 20, size=(n, L)).astype(np.int32)
    types[np.arange(L)[None, :] >= lengths[:, None]] = -1
    jw, jl = jsh.windowed_types(jnp.asarray(types), jnp.asarray(lengths),
                                window=window, stride=stride)
    tw, tl = tsh.windowed_types(T(types), T(lengths), window=window, stride=stride)
    assert_same(tw, jw)
    assert_same(tl, jl)
    want = jsh.shingles_from_types(jw, jl, k=K, num_types=20)
    assert_same(tsh.shingles_from_types(tw, tl, k=K, num_types=20), want)


# ---------------------------------------------------------------------------
# windowed scorers
# ---------------------------------------------------------------------------
def _table(N_rows=10, H=3, L=11, P=64, seed=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(N_rows, H, L)).astype(np.int32)
    lengths = rng.integers(1, L + 1, size=N_rows).astype(np.int32)
    codes = np.where(np.arange(L)[None, None, :] >= lengths[:, None, None], -1, codes)
    left = rng.integers(0, N_rows, size=P).astype(np.int32)
    right = rng.integers(0, N_rows, size=P).astype(np.int32)
    off_a = rng.integers(0, L, size=P).astype(np.int32)
    off_b = rng.integers(0, L, size=P).astype(np.int32)
    off_a[:4] = L - 1  # the last offset of a row
    betas = np.asarray([1.0, 0.5, 0.25], np.float32)[:H]
    return codes, lengths, left, right, off_a, off_b, betas


@pytest.mark.parametrize("window", [4, 11])
def test_fused_windowed_plain_matches_pallas_interpret(window):
    codes, lengths, left, right, off_a, off_b, betas = _table()
    j_args = tuple(map(jnp.asarray, (codes, lengths, codes, lengths, left, right,
                                     off_a, off_b, betas)))
    t_args = tuple(map(T, (codes, lengths, codes, lengths, left, right, off_a, off_b, betas)))
    raw_lvl, _ = jfused.fused_windowed_gather_score(*j_args, window=window, interpret=True)
    want_lvl, want_mss = jfused.fused_windowed_score(*j_args, window=window, mode="interpret")
    assert_same(want_lvl, jfused.fused_windowed_score_ref(*j_args, window=window)[0])
    lvl, mss = tfused.fused_windowed_gather_score_plain(*t_args, window=window)
    assert_same(lvl, raw_lvl)
    assert_same(mss, want_mss)  # the plain epilogue is the FMA chain too
    for mode in ("auto", "pallas", "interpret", "ref"):
        for exact in (True, False):
            lvl, mss = tfused.fused_windowed_score(*t_args, window=window, mode=mode,
                                                   exact_mss=exact)
            assert_same(lvl, want_lvl)
            assert_same(mss, want_mss)
    tfused.fused_windowed_gather_score.launches = 0
    assert_same(tfused.fused_windowed_gather_score(*t_args, window=window)[0], raw_lvl)
    assert tfused.fused_windowed_gather_score.launches == 0  # CPU tensors never launch


def test_fused_windowed_plain_at_larger_batch():
    """Beyond interpret-mode sizes: the plain version against the JAX
    gather-windows reference over a thousand pairs."""
    codes, lengths, left, right, off_a, off_b, betas = _table(N_rows=50, L=12, P=1000, seed=4)
    args = (codes, lengths, codes, lengths, left, right, off_a, off_b, betas)
    for window in (1, 5):
        want = jfused.fused_windowed_score_ref(*map(jnp.asarray, args), window=window)
        got = tfused.fused_windowed_gather_score_plain(*map(T, args), window=window)
        assert_same(got[0], want[0])
        assert_same(got[1], want[1])


def test_fused_windowed_wrappers_reject_bad_operands():
    codes, lengths, left, right, off_a, off_b, betas = map(T, _table(P=8))
    L = codes.shape[-1]
    ok = (codes, lengths, codes, lengths, left, right)
    with pytest.raises(IndexError, match="offsets outside"):
        tfused.fused_windowed_gather_score(*ok, torch.full_like(off_a, L), off_b, betas, window=4)
    with pytest.raises(IndexError, match="offsets outside"):
        tfused.fused_windowed_gather_score(*ok, off_a, off_b - 20, betas, window=4)
    with pytest.raises(TypeError):
        tfused.fused_windowed_gather_score(*ok, off_a.long(), off_b, betas, window=4)
    with pytest.raises(ValueError, match="window must be positive"):
        tfused.fused_windowed_gather_score(*ok, off_a, off_b, betas, window=0)
    with pytest.raises(IndexError, match="clamp PAD_ID"):
        tfused.fused_windowed_gather_score(codes, lengths, codes, lengths,
                                           torch.full_like(left, PAD_ID), right,
                                           off_a, off_b, betas, window=4)
    with pytest.raises(ValueError, match="dispatch mode"):
        tfused.fused_windowed_score(*ok, off_a, off_b, betas, window=4, mode="bogus")


@pytest.mark.parametrize("impl", ["wavefront", "ref", "fused", "fused-pallas", "fused-interpret"])
def test_score_windowed_pairs_bit_equal(impl):
    codes, lengths, _, _, _, _, betas = _table(N_rows=12, L=11)
    rng = np.random.default_rng(7)
    nw, window, stride = tsub.num_windows(11, 4, 2), 4, 2
    left = rng.integers(0, 12 * nw, size=50).astype(np.int32)
    right = rng.integers(0, 12 * nw, size=50).astype(np.int32)
    left[-3:] = right[-3:] = PAD_ID
    want = jsim.score_windowed_pairs(
        *map(jnp.asarray, (codes, lengths, left, right, betas)),
        nw=nw, window=window, stride=stride, impl_name="wavefront",
    )
    got = tsim.score_windowed_pairs(*map(T, (codes, lengths, left, right, betas)),
                                    nw=nw, window=window, stride=stride, impl_name=impl)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.parametrize("mode", ["auto", "pallas", "interpret", "wavefront"])
def test_lcs_windowed_bit_equal(mode):
    rng = np.random.default_rng(0)
    B, L, window = 520, 12, 5  # "auto" takes the kernel wrapper from 512 rows
    a = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    b = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    len_a = rng.integers(0, L + 1, size=B).astype(np.int32)
    len_b = rng.integers(0, L + 1, size=B).astype(np.int32)
    off_a = rng.integers(0, L, size=B).astype(np.int32)
    off_b = rng.integers(0, L, size=B).astype(np.int32)
    args = (a, b, off_a, off_b, len_a, len_b)
    want = jops.lcs_windowed(*map(jnp.asarray, args), window=window, mode="wavefront")
    got = tops.lcs_windowed(*map(T, args), window=window, mode=mode)
    assert_same(got, want)
