"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version; these tests
hold that version, and the dispatch around it, bit-equal to the JAX
kernels run in interpret mode (at a few dozen pairs, as the JAX package's
own golden tests run them) and to the JAX oracles at larger batches.
``level_lcs`` is compared exactly, and float32 ``mss`` with tolerance 0:
the port's kernel epilogue and ``mss_scores`` are the same forward FMA chain
as the reference's ``einsum``.

The LM serving kernels' plain versions (flash attention, the SSD intra-
chunk step) compute in float32 and are held within the JAX kernel tests'
own bars: 3e-5 for float32 attention, 3e-2 for bfloat16 attention
(``tests/test_kernels.py``), 1e-4 for SSD.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lcs import fused as jfused
from repro.kernels.lcs import kernel as jkernel
from repro.kernels.lcs import ops as jops
from repro.kernels.lcs.ref import lcs as jref
from repro.kernels.attention import ops as j_attn_ops
from repro.kernels.attention import ref as j_attn_ref
from repro.kernels.shingle import ops as jshingle
from repro.kernels.ssd import kernel as j_ssd_kernel
from repro.kernels.ssd import ops as j_ssd_ops
from repro.models import layers as jL
from repro.models import mamba as jM
from repro_torch.kernels import _build
from repro_torch.kernels.lcs import fused as tfused
from repro_torch.kernels.lcs import kernel as tkernel
from repro_torch.kernels.attention import kernel as t_attn
from repro_torch.kernels.attention import ops as t_attn_ops
from repro_torch.kernels.attention import ref as t_attn_ref
from repro_torch.kernels.lcs import ops as tops
from repro_torch.kernels.shingle import kernel as tshk
from repro_torch.kernels.shingle import ops as tshingle
from repro_torch.kernels.ssd import kernel as t_ssd
from repro_torch.kernels.ssd import ops as t_ssd_ops
from repro_torch.kernels.ssd import ref as t_ssd_ref
from repro_torch.models import layers as tL


def T(x):
    return torch.as_tensor(np.array(x))  # a copy: JAX arrays are read-only


def assert_same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def counts():
    """Launch counters reset around a test."""
    wrappers = (tkernel.lcs_kernel, tfused.fused_gather_score,
                tfused.fused_windowed_gather_score, tshk.shingle_kernel)
    for w in wrappers:
        w.launches = 0
    yield
    for w in wrappers:
        w.launches = 0


def _sentinel_pad(a, b, la, lb):
    L = a.shape[1]
    a, b = a.copy(), b.copy()
    a[np.arange(L)[None, :] >= la[:, None]] = -1
    b[np.arange(L)[None, :] >= lb[:, None]] = -2
    return a, b


def _rows(B, L, seed, alphabet=6):
    rng = np.random.default_rng(seed)
    la = rng.integers(1, L + 1, size=B)
    lb = rng.integers(1, L + 1, size=B)
    a = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    b = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    return _sentinel_pad(a, b, la, lb)


# ---------------------------------------------------------------------------
# batched LCS (port of lcs_pallas + ops.lcs)
# ---------------------------------------------------------------------------
LCS_CASES = {
    "length_one": lambda: _sentinel_pad(*_rows(3, 8, 1)[:2], np.ones(3, int), np.ones(3, int)),
    "max_len_one": lambda: (np.asarray([[2], [3], [4]], np.int32), np.asarray([[2], [5], [4]], np.int32)),
    "odd_batch": lambda: _rows(37, 12, 2),
    "identical": lambda: (np.full((16, 10), 7, np.int32), np.full((16, 10), 7, np.int32)),
    "identical_prefixes": lambda: _sentinel_pad(
        np.full((20, 10), 7, np.int32), np.full((20, 10), 7, np.int32),
        np.arange(20) % 10 + 1, np.full(20, 10)),
    "long_rows": lambda: _rows(4, 126, 3, alphabet=3),
}


@functools.lru_cache(maxsize=None)
def _lcs_case(case):
    """(a, b, the Pallas kernel's answer in interpret mode), once per case."""
    a, b = LCS_CASES[case]()
    want = jops.lcs(jnp.asarray(a), jnp.asarray(b), block_b=64, mode="interpret")
    assert_same(want, jref(jnp.asarray(a), jnp.asarray(b)))
    return a, b, np.asarray(want)


@pytest.mark.parametrize("mode", ["auto", "pallas", "interpret", "wavefront"])
@pytest.mark.parametrize("case", sorted(LCS_CASES))
def test_lcs_matches_pallas_interpret(case, mode, counts):
    a, b, want = _lcs_case(case)
    assert_same(tops.lcs(T(a), T(b), block_b=64, mode=mode), want)
    assert tkernel.lcs_kernel.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("B,block_b", [(1, 4), (5, 4), (7, 8), (30, 16)])
def test_lcs_kernel_wrapper_any_batch(B, block_b, counts):
    a, b = _rows(B, 10, B)
    want = jkernel.lcs_pallas(jnp.asarray(a), jnp.asarray(b), block_b=block_b, interpret=True)
    assert_same(tkernel.lcs_kernel(T(a), T(b), block_b=block_b), want)
    assert_same(tkernel.lcs_plain(T(a), T(b)), want)
    assert tkernel.lcs_kernel.launches == 0


@pytest.mark.parametrize("B", [257, 513, 1000])
def test_lcs_golden_at_non_pow2_batches(B):
    a, b = _rows(B, 10, B)
    want = jref(jnp.asarray(a), jnp.asarray(b))
    for mode in ("auto", "pallas"):
        assert_same(tops.lcs(T(a), T(b), block_b=512, mode=mode), want)


def test_block_for_matches_reference():
    assert tops._block_for(513, 512) == 128
    assert tops._block_for(512, 512) == 512
    assert tops._block_for(1024, 512) == 512
    assert tops._block_for(640, 512) == 128
    assert tops._block_for(100, 512) == 128
    assert tops._block_for(1000, 64) == 64
    assert tops._block_for(3, 4) == 4
    assert tops._block_for(1, 1) == 1
    for batch in (1, 7, 100, 129, 513, 4097, 30_001):
        for cap in (1, 4, 64, 512, 1024):
            assert tops._block_for(batch, cap) == jops._block_for(batch, cap)


def test_threads_for_respects_shared_memory():
    assert tkernel.threads_for(10, 512) == 512
    assert tkernel.threads_for(10, 4096) == 512  # 2*10*4*1024 > 48 KB
    assert tkernel.threads_for(126, 512) == 32   # 2*126*4*t <= 48 KB
    assert tkernel.threads_for(1, 64) == 64
    for L in range(1, 127):
        t = tkernel.threads_for(L, 1024)
        assert t & (t - 1) == 0 and 2 * L * 4 * t <= 48 * 1024


@pytest.mark.parametrize("L,want", [(1, "registers"), (8, "registers"), (10, "registers"),
                                    (32, "registers"), (33, "shared"), (64, "shared"),
                                    (126, "shared"), (127, None)])
def test_lcs_route_by_width(L, want):
    """Widths up to 32 take the register kernels, 33-126 the shared-memory
    kernel; 127 is refused (LCS values are carried in int8)."""
    if want is None:
        with pytest.raises(ValueError, match="127"):
            tkernel.route(L)
    else:
        assert tkernel.route(L) == want
        assert tfused.route(L) == want  # the fused scorers' rule is the same


@pytest.mark.parametrize("L", [1, 8, 32, 33])
@pytest.mark.parametrize("B", [1, 127, 129])
def test_lcs_matches_pallas_interpret_either_side_of_the_routes(L, B, counts):
    """The plain version (the kernel wrapper's CPU path) against the Pallas
    kernel in interpret mode, at widths either side of the register route
    and batches either side of its 128-row tile."""
    a, b = _rows(B, L, 1000 * L + B)
    want = jkernel.lcs_pallas(jnp.asarray(a), jnp.asarray(b), block_b=B, interpret=True)
    assert_same(tkernel.lcs_kernel(T(a), T(b)), want)
    assert_same(tops.lcs(T(a), T(b), mode="pallas"), want)
    assert tkernel.lcs_kernel.launches == 0


def test_lcs_wrappers_reject_bad_operands():
    a = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(TypeError):
        tkernel.lcs_kernel(a.long(), a.long())
    with pytest.raises(ValueError):
        tkernel.lcs_kernel(a, a[:, :5])
    with pytest.raises(ValueError, match="127"):
        big = torch.zeros((2, 127), dtype=torch.int32)
        tkernel.lcs_kernel(big, big)
    with pytest.raises(ValueError, match="dispatch mode"):
        tops.lcs(a, a, mode="bogus")


# ---------------------------------------------------------------------------
# fused gather-and-score (port of fused_gather_score + fused_score)
# ---------------------------------------------------------------------------
def _world(N, H, L, P, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    codes = rng.integers(0, 6, size=(N, H, L)).astype(np.int32)
    pad = np.arange(L)[None, None, :] >= lengths[:, None, None]
    codes = np.where(pad, -1, codes)
    left = rng.integers(0, N, size=P).astype(np.int32)
    right = rng.integers(0, N, size=P).astype(np.int32)
    betas = rng.random(H).astype(np.float32)
    return codes, lengths, left, right, betas


def _check_fused(codes, lengths, left, right, betas, codes_b=None, lengths_b=None):
    cb = codes if codes_b is None else codes_b
    lb = lengths if lengths_b is None else lengths_b
    j_args = tuple(map(jnp.asarray, (codes, lengths, cb, lb, left, right, betas)))
    t_args = tuple(map(T, (codes, lengths, cb, lb, left, right, betas)))
    want_lvl, want_mss = jfused.fused_score(*j_args, mode="interpret")
    assert_same(want_lvl, jfused.fused_score_ref(*j_args)[0])
    raw_lvl, _ = jfused.fused_gather_score(*j_args, interpret=True)
    for mode in ("auto", "pallas", "interpret", "ref"):
        lvl, mss = tfused.fused_score(*t_args, mode=mode)
        assert_same(lvl, want_lvl)
        assert_same(mss, want_mss)
        lvl, mss = tfused.fused_score(*t_args, mode=mode, exact_mss=False)
        assert_same(lvl, want_lvl)
        assert_same(mss, want_mss)  # the port's epilogue is the FMA chain too
    lvl, mss = tfused.fused_gather_score(*t_args)
    assert_same(lvl, raw_lvl)
    assert_same(mss, want_mss)
    assert_same(tfused.fused_gather_score_plain(*t_args)[0], raw_lvl)
    assert tfused.fused_gather_score.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("P", [1, 3, 37])
def test_fused_odd_pair_counts(P, counts):
    _check_fused(*_world(N=11, H=3, L=9, P=P, seed=P))


@pytest.mark.parametrize("H", [1, 2, 4, 5])
def test_fused_level_counts(H, counts):
    _check_fused(*_world(N=9, H=H, L=8, P=13, seed=H))


def test_fused_length_one_rows(counts):
    codes, lengths, left, right, betas = _world(8, 3, 7, 16, seed=2)
    codes = np.where(np.arange(7)[None, None, :] < 1, codes, -1)
    _check_fused(codes, np.ones_like(lengths), left, right, betas)


def test_fused_all_identical_rows(counts):
    N, H, L, P = 6, 2, 8, 10
    codes = np.full((N, H, L), 4, np.int32)
    lengths = np.full((N,), L, np.int32)
    left = (np.arange(P) % N).astype(np.int32)
    right = ((np.arange(P) + 1) % N).astype(np.int32)
    betas = np.asarray([0.25, 0.75], np.float32)
    _check_fused(codes, lengths, left, right, betas)
    lvl, _ = tfused.fused_gather_score(*map(T, (codes, lengths, codes, lengths, left, right, betas)))
    assert (lvl.numpy() == L).all()


def test_fused_two_distinct_tables_iota_indices(counts):
    codes_a, len_a, _, _, betas = _world(14, 3, 9, 14, seed=5)
    codes_b, len_b, _, _, _ = _world(14, 3, 9, 14, seed=6)
    iota = np.arange(14, dtype=np.int32)
    _check_fused(codes_a, len_a, iota, iota, betas, codes_b=codes_b, lengths_b=len_b)


def test_fused_plain_version_at_larger_batch():
    """Beyond interpret-mode sizes: the plain version against the JAX
    gather-then-score oracle over a thousand pairs."""
    args = _world(N=200, H=3, L=10, P=1000, seed=9)
    want = jfused.fused_score_ref(*map(jnp.asarray, (args[0], args[1], args[0], args[1], *args[2:])))
    got = tfused.fused_gather_score_plain(*map(T, (args[0], args[1], args[0], args[1], *args[2:])))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


def test_fused_wrappers_reject_bad_operands():
    codes, lengths, left, right, betas = map(T, _world(5, 3, 6, 4))
    with pytest.raises(ValueError, match="dispatch mode"):
        tfused.fused_score(codes, lengths, codes, lengths, left, right, betas, mode="bogus")
    with pytest.raises(TypeError):
        tfused.fused_gather_score(codes.long(), lengths, codes, lengths, left, right, betas)
    with pytest.raises(TypeError):
        tfused.fused_gather_score(codes, lengths, codes, lengths, left, right, betas.double())
    with pytest.raises(ValueError):
        tfused.fused_gather_score(codes, lengths, codes[:, :2], lengths, left, right, betas)
    pad = torch.full_like(left, 2**31 - 1)
    with pytest.raises(IndexError, match="clamp PAD_ID"):
        tfused.fused_gather_score(codes, lengths, codes, lengths, pad, right, betas)
    negative = left.clone()
    negative[1] = -1
    with pytest.raises(IndexError, match="left holds indices outside"):
        tfused.fused_gather_score(codes, lengths, codes, lengths, negative, right, betas)
    beyond = right.clone()
    beyond[-1] = codes.shape[0]
    with pytest.raises(IndexError, match="right holds indices outside"):
        tfused.fused_gather_score(codes, lengths, codes, lengths, left, beyond, betas)
    L = codes.shape[2]
    off = torch.zeros_like(left)
    off_L = off.clone()
    off_L[2] = L
    with pytest.raises(IndexError, match=rf"off_b holds offsets outside \[0, {L}\)"):
        tfused.fused_windowed_gather_score(codes, lengths, codes, lengths, left, right,
                                           off, off_L, betas, window=4)
    assert tfused.FUSED_IMPL_MODES == jfused.FUSED_IMPL_MODES


# ---------------------------------------------------------------------------
# shingle keys (port of shingle_pallas + ops.shingle_keys)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("k,Q,L", [(3, 30, 10), (3, 300, 16), (4, 30, 12), (2, 10, 8),
                                   (1, 7, 5), (3, 300, 8)])
def test_shingle_keys_match_pallas_interpret(k, Q, L, dedup, counts):
    rng = np.random.default_rng(k * 1000 + Q + L)
    n = 37
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[:3] = (0, L, k - 1)
    types = rng.integers(0, Q, size=(n, L)).astype(np.int32)
    types[np.arange(L)[None, :] >= lengths[:, None]] = -1
    want = jshingle.shingle_keys(jnp.asarray(types), jnp.asarray(lengths), k=k,
                                 num_types=Q, block_b=32, dedup=dedup)
    got = tshingle.shingle_keys(T(types), T(lengths), k=k, num_types=Q, dedup=dedup)
    assert got.shape[1] % 128 == 0
    assert_same(got, want)
    assert tshk.shingle_kernel.launches == 0  # CPU tensors never launch


def _shingle_types(n, L, Q, seed, k):
    """Codes in [0, Q) and lengths 0..L + 1, rows shorter than k among them."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 2, size=n).astype(np.int32)
    lengths[:3] = (0, L, k - 1)
    types = rng.integers(0, Q, size=(n, L)).astype(np.int32)
    return types, lengths


@pytest.mark.parametrize("k,Q,L", [(2, 300, L) for L in range(33, 41)] + [(3, 2048, 10)])
def test_shingle_keys_match_pallas_interpret_at_edge_shapes(k, Q, L, counts):
    """Rows wider than 32 (the kernel's shared-memory route) and a base whose
    pack wraps int32 (2048**3 = 2**33), through the public op."""
    types, lengths = _shingle_types(19, L, Q, L + Q, k)
    want = jshingle.shingle_keys(jnp.asarray(types), jnp.asarray(lengths), k=k,
                                 num_types=Q, block_b=8, dedup=False)
    got = tshingle.shingle_keys(T(types), T(lengths), k=k, num_types=Q, dedup=False)
    assert_same(got, want)
    assert tshk.shingle_kernel.launches == 0


@pytest.mark.parametrize("L,k,s_pad", [(10, 3, 256), (17, 2, 256)])
def test_shingle_kernel_matches_pallas_interpret_at_s_pad_256(L, k, s_pad, counts):
    """The raw kernel call at s_pad = 256: two 128-column chunks a row."""
    from repro.kernels.shingle import kernel as jshk

    types, lengths = _shingle_types(16, L, 300, L * k, k)
    want = jshk.shingle_pallas(jnp.asarray(types), jnp.asarray(lengths), k=k, num_types=300,
                               s_pad=s_pad, block_b=8, interpret=True)
    assert_same(tshk.shingle_kernel(T(types), T(lengths), k=k, num_types=300, s_pad=s_pad), want)
    assert tshk.shingle_kernel.launches == 0


def test_shingle_keys_agree_with_shingles_from_types():
    """The op's first C(L, k) columns are ``shingles_from_types``' keys."""
    from repro_torch.core.shingling import num_shingles, shingles_from_types

    rng = np.random.default_rng(11)
    types = T(rng.integers(0, 300, size=(200, 10)).astype(np.int32))
    lengths = T(rng.integers(3, 11, size=200).astype(np.int32))
    got = tshingle.shingle_keys(types, lengths, k=3, num_types=300)
    S = num_shingles(10, 3)
    assert torch.equal(got[:, :S], shingles_from_types(types, lengths, k=3, num_types=300))
    assert bool((got[:, S:] == 2**31 - 1).all())


def test_shingle_kernel_rejects_bad_operands():
    types = torch.zeros((4, 6), dtype=torch.int32)
    lengths = torch.full((4,), 6, dtype=torch.int32)
    with pytest.raises(TypeError):
        tshk.shingle_kernel(types.long(), lengths, k=3, num_types=5, s_pad=128)
    with pytest.raises(ValueError, match="lengths"):
        tshk.shingle_kernel(types, lengths[:2], k=3, num_types=5, s_pad=128)
    with pytest.raises(ValueError, match="s_pad"):
        tshk.shingle_kernel(types, lengths, k=3, num_types=5, s_pad=8)
    with pytest.raises(ValueError, match="positive"):
        tshk.shingle_kernel(types, lengths, k=0, num_types=5, s_pad=128)


# ---------------------------------------------------------------------------
# the wrappers' constants against the CUDA sources (no card)
# ---------------------------------------------------------------------------
def _constant(source, name):
    text = (_build.CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not found in {source}"
    return eval(m.group(1), {})  # an integer expression such as 48 * 1024 / 4


def test_lcs_wrapper_matches_its_source():
    """The register route's block and widest width, the route codes and the
    variant codes the wrapper passes are the ones lcs.cu launches."""
    assert _constant("lcs.cu", "kRowsPerBlock") == tkernel.REGISTER_THREADS == 128
    assert _constant("pair_dp.cuh", "kMaxRegisterWidth") == tkernel.MAX_REGISTER_WIDTH == 32
    assert tkernel.ROUTES == ("registers", "shared")
    launcher = (_build.CSRC / "lcs.cu").read_text().split('extern "C" int lcs_variant_launch')[1]
    assert {int(c) for c in re.findall(r"variant != (\d+)", launcher)} == set(
        tkernel.VARIANTS.values())


def test_shingle_wrapper_matches_its_source():
    assert _constant("shingle.cu", "kMaxWidth") == tshk.MAX_WIDTH == 12_288
    launcher = (_build.CSRC / "shingle.cu").read_text().split(
        'extern "C" int shingle_variant_launch')[1]
    assert {int(c) for c in re.findall(r"variant == (\d+)", launcher)} == set(
        tshk.VARIANTS.values())


def test_shingle_device_combos_are_cached_per_shape():
    """The combination table is uploaded once per (L, k, device)."""
    first = tshk.device_combos(10, 3, torch.device("cpu"))
    assert tshk.device_combos(10, 3, torch.device("cpu")) is first
    assert first.dtype == torch.int32 and first.shape == (120, 3)
    assert tshk.device_combos(11, 3, torch.device("cpu")).shape == (165, 3)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def test_build_lists_sources_and_refuses_without_nvcc(monkeypatch, tmp_path):
    assert _build.sources() == ["flash_attention", "flash_attention_bwd_sm90", "flash_attention_sm90",
                                "fused_score", "fused_windowed_score", "lcs", "minhash", "shingle", "ssd_intra",
                                "ssd_intra_sm90"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a system nvcc under /usr/local/cuda is always found")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ---------------------------------------------------------------------------
# flash attention (kernel #6): the plain version
# ---------------------------------------------------------------------------
def F32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, atol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else F32(got)
    np.testing.assert_allclose(got, F32(want), rtol=0, atol=atol, err_msg=what)


def _qkv(B, Sq, H, KH, D, seed, dtype=jnp.float32, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Sq if Skv is None else Skv
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D))]
    return [jnp.asarray(a, dtype) for a in arrs]


def TB(x):
    """JAX array -> CPU tensor, bfloat16 kept bit for bit."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


ATTN_SHAPES = [
    (2, 128, 4, 2, 64, True), (1, 256, 8, 8, 32, True),
    (2, 128, 4, 1, 64, False), (3, 64, 6, 2, 128, True),  # tests/test_kernels.py
    (2, 128, 4, 4, 80, True),   # zamba2's head_dim, MHA (rep = 1)
    (1, 128, 8, 2, 128, True),  # granite's head_dim, GQA rep = 4
]


@pytest.mark.parametrize("B,Sq,H,KH,D,causal", ATTN_SHAPES)
def test_attention_plain_matches_pallas_f32(B, Sq, H, KH, D, causal):
    q, k, v = _qkv(B, Sq, H, KH, D, B * Sq + H)
    got = t_attn.flash_attention_plain(TB(q), TB(k), TB(v), causal=causal)
    pallas = j_attn_ops.flash_attention(q, k, v, causal=causal, blk_q=64, blk_k=64)
    assert_close(got, pallas, 3e-5, "vs the Pallas kernel (interpret)")
    assert_close(got, j_attn_ref.attention(q, k, v, causal=causal), 3e-5, "vs ref.attention")


@pytest.mark.parametrize("B,Sq,H,KH,D", [(2, 128, 4, 2, 64), (2, 128, 4, 4, 80), (1, 128, 8, 2, 128)])
def test_attention_plain_matches_pallas_bf16(B, Sq, H, KH, D):
    q, k, v = _qkv(B, Sq, H, KH, D, 7, jnp.bfloat16)
    got = t_attn.flash_attention_plain(TB(q), TB(k), TB(v))
    assert got.dtype == torch.bfloat16
    assert_close(got, j_attn_ops.flash_attention(q, k, v, blk_q=64, blk_k=64), 3e-2)
    assert_close(got, j_attn_ref.attention(q, k, v), 3e-2)


def test_attention_plain_is_chunked_attention_over_chunks():
    """Two q chunks and two kv chunks of 1,024: the plain version is
    ``layers.chunked_attention``, the function the JAX serving path runs."""
    q, k, v = _qkv(1, 2048, 2, 1, 32, 11)
    got = tL.chunked_attention(TB(q), TB(k), TB(v), causal=True)
    assert_close(got, jL.chunked_attention(q, k, v, causal=True), 3e-5)


@pytest.mark.parametrize("Sq,Skv", [(1, 1), (65, 65), (1000, 1000), (65, 130), (1, 70)])
@pytest.mark.parametrize("D,H,KH", [(64, 4, 4), (80, 4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ragged_lengths(Sq, Skv, D, H, KH, causal):
    """Lengths the Pallas kernel refuses (it needs whole blocks) but the
    CUDA kernel takes: the wrapper on CPU tensors (its plain version, no
    launch) against the reference's full-softmax oracle and the port's."""
    q, k, v = _qkv(1, Sq, H, KH, D, Sq + Skv + D, Skv=Skv)
    t_attn.flash_attention_kernel.launches = 0
    got = t_attn_ops.flash_attention(TB(q), TB(k), TB(v), causal=causal)
    assert t_attn.flash_attention_kernel.launches == 0
    assert_close(got, j_attn_ref.attention(q, k, v, causal=causal), 3e-5)
    assert_close(got, t_attn_ref.attention(TB(q), TB(k), TB(v), causal=causal), 3e-5)


def test_attention_rejects_bad_operands():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 4, 8), (1, 4, 3, 8), (1, 4, 3, 8)))
    with pytest.raises(ValueError, match="multiple of KH"):
        t_attn_ops.flash_attention(q, k, v)
    with pytest.raises(TypeError, match="dtypes"):
        t_attn_ops.flash_attention(q, q, q.double())
    with pytest.raises(ValueError, match="must be"):
        t_attn_ops.flash_attention(q, q[0], q[0])


# ---------------------------------------------------------------------------
# the SSD intra-chunk step (kernel #7): the plain version and the scan op
# ---------------------------------------------------------------------------
def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, S, H, P)).astype(np.float32),
        rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32),
        -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32),
        rng.normal(size=(B, S, 1, N)).astype(np.float32),
        rng.normal(size=(B, S, 1, N)).astype(np.float32),
        rng.normal(size=(H,)).astype(np.float32),
    ]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 4, 32, 16, 16), (1, 128, 8, 64, 32, 32), (2, 96, 2, 16, 8, 48),  # TestSSD
    (1, 96, 2, 64, 64, 32),  # zamba2's P = N = 64, three chunks
])
def test_ssd_plain_matches_pallas(B, S, H, P, N, chunk):
    arrs = _ssd_inputs(B, S, H, P, N, S + H)
    y, st = t_ssd_ops.ssd_chunked(*map(T, arrs), chunk=chunk)
    jy, jst = j_ssd_ops.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    assert_close(y, jy, 1e-4, "y vs the Pallas op (interpret)")
    assert_close(st, jst, 1e-4, "state vs the Pallas op (interpret)")
    ry, rst = jM._ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    assert_close(y, ry, 1e-4, "y vs _ssd_chunked")
    assert_close(st, rst, 1e-4, "state vs _ssd_chunked")
    ry2, rst2 = t_ssd_ref.ssd_chunked(*map(T, arrs), chunk=chunk)
    assert torch.equal(y, ry2) and torch.equal(st, rst2)


@pytest.mark.parametrize("BC,Q,H,P,N", [(3, 16, 4, 32, 16), (2, 32, 3, 64, 64)])
def test_ssd_intra_plain_matches_pallas_kernel(BC, Q, H, P, N):
    """The intra-chunk step alone against ``ssd_intra_pallas`` (interpret):
    y, the chunk states and the chunk decays."""
    rng = np.random.default_rng(Q + N)
    x = rng.normal(size=(BC, Q, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(BC, Q, H)).astype(np.float32)
    cum = np.cumsum(dt * -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32), axis=1)
    B_ = rng.normal(size=(BC, Q, N)).astype(np.float32)
    C_ = rng.normal(size=(BC, Q, N)).astype(np.float32)
    t_ssd.ssd_intra.launches = 0
    got = t_ssd.ssd_intra(*map(T, (x, cum, dt, B_, C_)))
    assert t_ssd.ssd_intra.launches == 0
    want = j_ssd_kernel.ssd_intra_pallas(*map(jnp.asarray, (x, cum, dt, B_, C_)), interpret=True)
    for g, w, name in zip(got, want, ("y", "state", "cdecay")):
        assert tuple(g.shape) == tuple(w.shape), name
        assert g.dtype == torch.float32, name
        assert_close(g, w, 1e-4, name)


def test_ssd_plain_bf16_intra_matches_jax():
    """``ssm_bf16_intra`` (no registered config sets it; the reference's
    perf sweeps in ``repro/launch/perf.py`` do) rounds the intra-chunk
    score and decay matrices to bfloat16 in both packages; the plain
    version carries it, and on the card the tensor-core SSD kernel.  5e-2:
    values one bfloat16 rounding apart where the two packages' exp differ
    by an ulp."""
    arrs = _ssd_inputs(1, 64, 4, 32, 16, 5)
    y, st = t_ssd_ops.ssd_chunked(*map(T, arrs), chunk=32, bf16_intra=True)
    ry, rst = jM._ssd_chunked(*map(jnp.asarray, arrs), chunk=32, bf16_intra=True)
    assert_close(y, ry, 5e-2)
    assert_close(st, rst, 5e-2)


def test_ssd_rejects_bad_operands():
    x, dt, A, B_, C_, D = map(T, _ssd_inputs(1, 32, 2, 8, 4, 0))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ssd_ops.ssd_chunked(x, dt, A, B_, C_, D, chunk=12)
    with pytest.raises(ValueError, match="one B/C group"):
        t_ssd_ops.ssd_chunked(x, dt, A, B_.repeat(1, 1, 2, 1), C_.repeat(1, 1, 2, 1), D, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        t_ssd.ssd_intra(x[:, :, :, :], dt[..., None].double().squeeze(-1).reshape(1, 32, 2),
                        dt.reshape(1, 32, 2), B_[:, :, 0], C_[:, :, 0])
