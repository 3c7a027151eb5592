"""The PyTorch port's core phases against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` (the
reference) and ``repro_torch`` (``device="cpu"``).  Every integer output —
forest, world, codes, shingle keys, candidate buffers, LCS values, labels —
must be bit-equal, and float32 ``mss`` must be bit-equal too (tolerance 0):
the reference's ``einsum`` rounds as a forward FMA chain in level order,
which the port's ``mss_scores`` reproduces step for step, and the engine's
float32 ``mss > rho`` test depends on every bit.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.communities as jcomm
import repro.core.encoding as jenc
import repro.core.shingling as jsh
import repro.core.similarity as jsim
import repro.core.ssh as jssh
import repro.data as jdata
import repro_torch.core.communities as tcomm
import repro_torch.core.encoding as tenc
import repro_torch.core.shingling as tsh
import repro_torch.core.similarity as tsim
import repro_torch.core.ssh as tssh
import repro_torch.data as tdata
from repro_torch import interop

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parents[1]


def T(x):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.array(x))  # a copy: JAX arrays are read-only


def N(x):
    """JAX array or tensor -> numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want):
    got, want = N(got), N(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------
def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
        text = path.read_text()
        assert "import jax" not in text and "from repro." not in text, path


def test_default_device_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable without a CUDA device")
    from repro_torch.core.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tdata.synthetic_setup(10)
    with pytest.raises(RuntimeError):
        tdata.fig1_world()
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# worlds and encoding
# ---------------------------------------------------------------------------
WORLDS = {
    "paper": dict(num_traj=300, seed=0),
    "scalability": dict(num_traj=200, num_types=300, seed=3),
    "levels2": dict(num_traj=120, num_types=10, classes_per_type=4, num_places=150, n_levels=2, seed=5),
    "levels5": dict(num_traj=120, num_types=10, classes_per_type=4, num_places=400, n_levels=5, seed=6),
    "padded": dict(num_traj=100, num_types=10, classes_per_type=5, num_places=200, seed=7, max_len_pad=14),
}


def _worlds(name):
    kw = dict(WORLDS[name])
    n = kw.pop("num_traj")
    jb, jf = jdata.synthetic_setup(n, **kw)
    tb, tf = tdata.synthetic_setup(n, device=CPU, **kw)
    return (jb, jf), (tb, tf)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_world_and_encoding_bit_equal(name):
    (jb, jf), (tb, tf) = _worlds(name)
    assert tf.sizes == jf.sizes
    for p_t, p_j in zip(tf.parents, jf.parents):
        np.testing.assert_array_equal(p_t, p_j)
    assert_same(tb.places, jb.places)
    assert_same(tb.lengths, jb.lengths)
    assert_same(tb.user_id, jb.user_id)
    assert_same(tb.valid_mask(), jb.valid_mask())
    jt, tt = jenc.forest_tables(jf), tenc.forest_tables(tf, device=CPU)
    assert_same(tt, jt)
    for pad in (tenc.PAD_CODE_A, tenc.PAD_CODE_B):
        assert_same(tenc.encode_codes(tb.places, tt, pad_code=pad),
                    jenc.encode_codes(jb.places, jt, pad_code=pad))
        assert_same(tenc.encode_types(tb.places, tt, pad_code=pad),
                    jenc.encode_types(jb.places, jt, pad_code=pad))
    te, je = tenc.encode_batch(tb, tt), jenc.encode_batch(jb, jt)
    assert_same(te.codes, je.codes)
    assert_same(tenc.type_codes(te), jenc.type_codes(je))
    # padding really is present and encoded as PAD_CODE_A
    assert (N(te.codes) == tenc.PAD_CODE_A).any()


def test_fig1_world_bit_equal():
    jb, jf = jdata.fig1_world()
    tb, tf = tdata.fig1_world(device=CPU)
    assert tf == tenc.SemanticForest(parents=tf.parents, sizes=jf.sizes)
    assert_same(tb.places, jb.places)
    assert_same(tb.lengths, jb.lengths)
    assert_same(tenc.forest_tables(tf, device=CPU), jenc.forest_tables(jf))


def test_interop_round_trip():
    (jb, jf), _ = _worlds("paper")
    tf = interop.forest_from_numpy(jf.parents, jf.sizes)
    assert tf.sizes == jf.sizes and tf.num_types == jf.num_types
    tb = interop.batch_from_numpy(np.asarray(jb.places), np.asarray(jb.lengths), device=CPU)
    assert_same(tb.places, jb.places)
    assert_same(tb.user_id, jb.user_id)
    cand = interop.candidates_from_numpy([1, 2, 2**31 - 1], [3, 4, 2**31 - 1], 2, 0, device=CPU)
    assert cand.count.shape == () and int(cand.count) == 2
    assert N(cand.valid_mask()).tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# shingling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("k,Q,L", [(3, 30, 10), (3, 300, 8), (2, 10, 6), (4, 30, 9)])
def test_shingle_keys_bit_equal(k, Q, L, dedup):
    rng = np.random.default_rng(k * 1000 + Q + L)
    n = 60
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    types = rng.integers(0, Q, size=(n, L)).astype(np.int32)
    types[np.arange(L)[None, :] >= lengths[:, None]] = -1
    want = jsh.shingles_from_types(jnp.asarray(types), jnp.asarray(lengths),
                                   k=k, num_types=Q, dedup=dedup)
    got = tsh.shingles_from_types(T(types), T(lengths), k=k, num_types=Q, dedup=dedup)
    assert_same(got, want)
    codes = np.stack([types, types], axis=1)
    assert_same(tsh.shingles(T(codes), T(lengths), k=k, num_types=Q, level=1),
                jsh.shingles(jnp.asarray(codes), jnp.asarray(lengths), k=k, num_types=Q, level=1))


def test_shingle_indices_pack_and_guards():
    for L, k in [(10, 3), (5, 5), (3, 4), (1, 1)]:
        np.testing.assert_array_equal(tsh.shingle_indices(L, k), jsh.shingle_indices(L, k))
        assert tsh.num_shingles(L, k) == jsh.num_shingles(L, k)
    with pytest.raises(ValueError, match="exceeds"):
        tsh.shingle_indices(200, 5)
    with pytest.raises(ValueError, match="overflows int32"):
        tsh.pack_keys(torch.zeros((1, 4), dtype=torch.int32), 2000)
    codes = np.random.default_rng(0).integers(0, 300, size=(500, 3)).astype(np.int32)
    assert_same(tsh.pack_keys(T(codes), 300), jsh.pack_keys(jnp.asarray(codes), 300))


# ---------------------------------------------------------------------------
# SSH join
# ---------------------------------------------------------------------------
def _keys(name):
    (jb, jf), (tb, tf) = _worlds(name)
    jk = jsh.shingles_from_types(
        jenc.type_codes(jenc.encode_batch(jb, jenc.forest_tables(jf))), jb.lengths,
        k=3, num_types=jf.num_types,
    )
    tk = tsh.shingles_from_types(
        tenc.type_codes(tenc.encode_batch(tb, tenc.forest_tables(tf, device=CPU))),
        tb.lengths, k=3, num_types=tf.num_types,
    )
    assert_same(tk, jk)
    return jk, tk


@pytest.mark.parametrize("capacity", ["planned", "exact", "too_small", "tiny"])
@pytest.mark.parametrize("name", ["paper", "padded"])
def test_ssh_candidates_bit_equal(name, capacity):
    jk, tk = _keys(name)
    total = jssh.exact_pair_count(jk)
    assert tssh.exact_pair_count(tk) == total > 0
    cap = {"planned": 1 << int(np.ceil(np.log2(total * 1.1))), "exact": total,
           "too_small": max(total // 3, 1), "tiny": 16}[capacity]
    want = jssh.ssh_candidates(jk, pair_capacity=cap)
    got = tssh.ssh_candidates(tk, pair_capacity=cap)
    for field in ("left", "right", "count", "overflow"):
        assert_same(getattr(got, field), getattr(want, field))
    assert (int(got.overflow) > 0) == (capacity in ("too_small", "tiny"))
    assert_same(got.valid_mask(), want.valid_mask())


def test_ssh_candidates_id_offset_and_pairs_from_rows():
    jk, tk = _keys("levels2")
    for off in (0, 1000):
        want = jssh.ssh_candidates(jk, pair_capacity=4096, id_offset=off)
        got = tssh.ssh_candidates(tk, pair_capacity=4096, id_offset=off)
        assert_same(got.left, want.left)
        assert_same(got.right, want.right)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 20, size=300).astype(np.int32)
    keys[rng.random(300) < 0.2] = 2**31 - 1
    ids = rng.integers(0, 50, size=300).astype(np.int32)
    for cap in (64, 5000):
        want = jssh.pairs_from_rows(jnp.asarray(keys), jnp.asarray(ids), pair_capacity=cap)
        got = tssh.pairs_from_rows(T(keys), T(ids), pair_capacity=cap)
        for g, w in zip(got, want):
            assert_same(g, w)


def test_dedup_pairs_bit_equal():
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 30, size=500).astype(np.int32)
    hi = rng.integers(0, 30, size=500).astype(np.int32)
    pad = rng.random(500) < 0.3
    lo[pad] = hi[pad] = 2**31 - 1
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    want = jssh.dedup_pairs(jnp.asarray(lo), jnp.asarray(hi), overflow=7)
    got = tssh.dedup_pairs(T(lo), T(hi), overflow=7)
    for field in ("left", "right", "count", "overflow"):
        assert_same(getattr(got, field), getattr(want, field))


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H", [3, 5])
def test_mss_scores_bit_equal_100k_rows(H):
    rng = np.random.default_rng(H)
    lvl = rng.integers(0, 11, size=(100_000, H)).astype(np.int32)
    for betas in (np.asarray(jsim.default_betas(H)), rng.random(H).astype(np.float32)):
        want = jsim.mss_scores(jnp.asarray(lvl), jnp.asarray(betas))
        got = tsim.mss_scores(T(lvl), T(betas))
        assert_same(got, want)  # tolerance 0: see the module docstring
    assert_same(tsim.default_betas(H, device=CPU), jsim.default_betas(H))


def test_mss_scores_is_not_a_plain_reduction():
    """The reason for the FMA chain: PyTorch's own reductions round in
    another order and disagree with the reference on some rows."""
    rng = np.random.default_rng(0)
    lvl = rng.integers(0, 11, size=(100_000, 3)).astype(np.int32)
    betas = np.asarray(jsim.default_betas(3))
    want = np.asarray(jsim.mss_scores(jnp.asarray(lvl), jnp.asarray(betas)))
    naive = torch.einsum("ph,h->p", T(lvl).float(), T(betas)).numpy()
    assert (naive != want).any()
    assert_same(tsim.mss_scores(T(lvl), T(betas)), want)


def _lcs_rows(B, L, alphabet, seed):
    rng = np.random.default_rng(seed)
    la = rng.integers(1, L + 1, size=B)
    lb = rng.integers(1, L + 1, size=B)
    a = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    b = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    a[np.arange(L)[None, :] >= la[:, None]] = -1
    b[np.arange(L)[None, :] >= lb[:, None]] = -2
    return a, b


@pytest.mark.parametrize("B,L", [(1, 1), (37, 10), (200, 12), (16, 126)])
def test_lcs_ref_and_wavefront_bit_equal(B, L):
    a, b = _lcs_rows(B, L, 5, seed=B + L)
    want = jsim.lcs_ref(jnp.asarray(a), jnp.asarray(b))
    assert_same(tsim.lcs_ref(T(a), T(b)), want)
    for dt in (torch.int8, torch.int32):
        assert_same(tsim.lcs_wavefront(T(a), T(b), dtype=dt), want)


def test_lcs_wavefront_rejects_long_rows_and_reads_dtype_probe(monkeypatch):
    a = torch.zeros((2, 127), dtype=torch.int32)
    with pytest.raises(ValueError, match="127"):
        tsim.lcs_wavefront(a, a)
    monkeypatch.delenv("REPRO_LCS_DTYPE", raising=False)
    assert tsim.wavefront_dtype_from_env() == torch.int8
    monkeypatch.setenv("REPRO_LCS_DTYPE", "int32")
    assert tsim.wavefront_dtype_from_env() == torch.int32


@pytest.mark.parametrize("impl", ["wavefront", "ref", "fused"])
@pytest.mark.parametrize("name", ["paper", "levels5"])
def test_score_pairs_bit_equal(name, impl):
    (jb, jf), (tb, tf) = _worlds(name)
    je = jenc.encode_batch(jb, jenc.forest_tables(jf))
    te = tenc.encode_batch(tb, tenc.forest_tables(tf, device=CPU))
    rng = np.random.default_rng(4)
    n = tb.num_trajectories
    left = rng.integers(0, n, size=64).astype(np.int32)
    right = rng.integers(0, n, size=64).astype(np.int32)
    left[-5:] = right[-5:] = 2**31 - 1  # PAD_ID slots clamp to row 0
    H = jf.num_levels
    jbeta, tbeta = jsim.default_betas(H), tsim.default_betas(H, device=CPU)
    want = jsim.score_pairs(je.codes, je.lengths, jnp.asarray(left), jnp.asarray(right),
                            jbeta, impl_name=impl)
    got = tsim.score_pairs(te.codes, te.lengths, T(left), T(right), tbeta, impl_name=impl)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    if impl == "wavefront":
        li, ri = np.where(left == 2**31 - 1, 0, left), np.where(right == 2**31 - 1, 0, right)
        assert_same(
            tsim.multi_level_lcs(te.codes[li], te.lengths[li], te.codes[ri], te.lengths[ri]),
            want[0],
        )


def test_mss_upper_bound_and_repad():
    rng = np.random.default_rng(5)
    la = rng.integers(1, 11, size=200).astype(np.int32)
    lb = rng.integers(1, 11, size=200).astype(np.int32)
    want = jsim.mss_upper_bound(la, lb, 1.0000001)
    np.testing.assert_array_equal(tsim.mss_upper_bound(la, lb, 1.0000001), want)
    assert_same(tsim.mss_upper_bound(T(la), T(lb), 0.75),
                jsim.mss_upper_bound(jnp.asarray(la), jnp.asarray(lb), 0.75))
    assert tsim.PRUNE_EPS == jsim.PRUNE_EPS
    codes = rng.integers(0, 9, size=(200, 3, 10)).astype(np.int32)
    assert_same(tsim.repad(T(codes), T(la), -2), jsim.repad(jnp.asarray(codes), jnp.asarray(la), -2))


# ---------------------------------------------------------------------------
# communities
# ---------------------------------------------------------------------------
def _graph(n, m, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n, size=m).astype(np.int32)
    hi = rng.integers(0, n, size=m).astype(np.int32)
    pad = rng.random(m) < 0.1
    lo[pad] = hi[pad] = 2**31 - 1
    return lo, hi


@pytest.mark.parametrize("n,m,seed", [(50, 30, 0), (300, 280, 1), (40, 0, 2)])
def test_connected_components_bit_equal(n, m, seed):
    lo, hi = _graph(n, m, seed)
    want = jcomm.connected_components(jnp.asarray(lo), jnp.asarray(hi), num_nodes=n)
    got = tcomm.connected_components(T(lo), T(hi), num_nodes=n)
    assert_same(got, want)
    # warm start from a fixpoint of a sub-graph gives the same fixpoint
    half = m // 2
    seed_labels = tcomm.connected_components(T(lo[:half]), T(hi[:half]), num_nodes=n)
    warm = tcomm.connected_components(T(lo), T(hi), num_nodes=n, init_labels=seed_labels)
    assert_same(warm, want)
    assert tcomm.components_as_sets(got) == jcomm.components_as_sets(np.asarray(want))
    uf = tcomm.UnionFind(n)
    for a, b in zip(lo.tolist(), hi.tolist()):
        if a != 2**31 - 1:
            uf.union(a, b)
    np.testing.assert_array_equal(uf.labels(), np.asarray(want))


def test_cliques_pairs_and_qa_metrics_equal():
    lo, hi = _graph(60, 120, 3)
    ok = lo != 2**31 - 1
    edges = {(int(min(a, b)), int(max(a, b))) for a, b in zip(lo[ok], hi[ok]) if a != b}
    assert tcomm.maximal_cliques(edges) == jcomm.maximal_cliques(edges)
    assert tcomm.pairs_to_set(T(lo), T(hi)) == jcomm.pairs_to_set(lo, hi)
    cl = tcomm.maximal_cliques(edges)
    half = set(list(cl)[: len(cl) // 2])
    assert tcomm.qa1(half, cl) == jcomm.qa1(half, cl)
    assert tcomm.qa2(set(list(edges)[:7]), edges) == jcomm.qa2(set(list(edges)[:7]), edges)
    assert tcomm.qa1(set(), set()) == tcomm.qa2(set(), set()) == 1.0


def test_union_find_growth_and_reset():
    uf_t, uf_j = tcomm.UnionFind(), jcomm.UnionFind()
    for uf in (uf_t, uf_j):
        uf.add(5)
        uf.union(0, 3)
        uf.add(20)
        uf.union(24, 3)
        uf.union(7, 8)
    np.testing.assert_array_equal(uf_t.labels(), uf_j.labels())
    uf_t.reset_from_labels(uf_j.labels())
    uf_t.union(8, 24)
    uf_j.union(8, 24)
    np.testing.assert_array_equal(uf_t.labels(), uf_j.labels())
    assert uf_t.components() == uf_j.components()
