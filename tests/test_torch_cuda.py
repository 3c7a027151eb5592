"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test here launches a CUDA kernel and is marked ``cuda``: without a
CUDA device it skips.  This file imports neither ``jax`` nor ``repro``, so
it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers (``level_lcs``, LCS values) must be equal and float32 ``mss`` bit-
equal (tolerance 0): the fused kernel's epilogue is the same forward FMA
chain (``__fmaf_rn`` in level order) as the plain ``mss_scores``.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import AnotherMeEngine, EngineConfig
from repro_torch.core import minhash_candidates, run_anotherme, type_codes
from repro_torch.core.brp import brp_bucket_keys
from repro_torch.core.shingling import num_shingles
from repro_torch.data import synthetic_setup
from repro_torch.kernels.lcs import fused as tfused
from repro_torch.kernels.lcs import kernel as tkernel
from repro_torch.kernels.lcs import ops as tops
from repro_torch.kernels.minhash import kernel as tmhk
from repro_torch.kernels.minhash import ops as tminhash
from repro_torch.kernels.shingle import kernel as tshk
from repro_torch.kernels.shingle import ops as tshingle


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("launches a Hopper kernel: needs a CUDA device (run on the H100)")
    for wrapper in (tkernel.lcs_kernel, tfused.fused_gather_score,
                    tfused.fused_windowed_gather_score, tshk.shingle_kernel,
                    tmhk.minhash_kernel):
        wrapper.launches = 0
    return torch.device("cuda", torch.cuda.current_device())


def _rows(B, L, seed, dev, alphabet=6):
    rng = np.random.default_rng(seed)
    la = rng.integers(1, L + 1, size=B)
    lb = rng.integers(1, L + 1, size=B)
    a = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    b = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
    a[np.arange(L)[None, :] >= la[:, None]] = -1
    b[np.arange(L)[None, :] >= lb[:, None]] = -2
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _world(N, H, L, P, seed, dev):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=N).astype(np.int32)
    codes = rng.integers(0, 6, size=(N, H, L)).astype(np.int32)
    codes = np.where(np.arange(L)[None, None, :] >= lengths[:, None, None], -1, codes)
    left = rng.integers(0, N, size=P).astype(np.int32)
    right = rng.integers(0, N, size=P).astype(np.int32)
    betas = rng.random(H).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (codes, lengths, left, right, betas)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,block_b", [(1, 1, 512), (3, 10, 512), (1000, 10, 64),
                                         (777, 126, 512), (70_001, 10, 512)])
def test_lcs_kernel_equals_plain(cuda, B, L, block_b):
    a, b = _rows(B, L, B + L, cuda)
    got = tops.lcs(a, b, mode="pallas", block_b=block_b)
    assert tkernel.lcs_kernel.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got, tkernel.lcs_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 3, 5])
def test_fused_kernel_equals_plain(cuda, H):
    codes, lengths, left, right, betas = _world(1000, H, 10, 20_001, H, cuda)
    lvl, mss = tfused.fused_gather_score(codes, lengths, codes, lengths, left, right, betas)
    assert tfused.fused_gather_score.launches == 1
    torch.cuda.synchronize()
    want_lvl, want_mss = tfused.fused_gather_score_plain(
        codes, lengths, codes, lengths, left, right, betas
    )
    assert torch.equal(lvl, want_lvl)
    assert torch.equal(mss, want_mss)


@pytest.mark.cuda
def test_fused_kernel_two_tables_iota(cuda):
    ca, la, _, _, betas = _world(500, 3, 9, 1, 1, cuda)
    cb, lb, _, _, _ = _world(500, 3, 9, 1, 2, cuda)
    iota = torch.arange(500, dtype=torch.int32, device=cuda)
    got = tfused.fused_gather_score(ca, la, cb, lb, iota, iota, betas)
    want = tfused.fused_gather_score_plain(ca, la, cb, lb, iota, iota, betas)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_engine_kernel_impls_equal_cpu_engine(cuda):
    cpu_batch, forest = synthetic_setup(2000, seed=0, device="cpu")
    want = AnotherMeEngine(forest, EngineConfig(), device="cpu").run(cpu_batch)
    batch, _ = synthetic_setup(2000, seed=0, device=cuda)
    for impl in ("kernel", "pallas", "fused", "fused-pallas"):
        got = AnotherMeEngine(forest, EngineConfig(lcs_impl=impl), device=cuda).run(batch)
        assert got.similar_pairs == want.similar_pairs
        assert got.communities == want.communities
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, field).cpu(), getattr(want.scored, field))
    assert tkernel.lcs_kernel.launches > 0 and tfused.fused_gather_score.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("L,window", [(20, 8), (10, 4), (9, 9), (12, 1)])
def test_fused_windowed_kernel_equals_plain(cuda, L, window):
    codes, lengths, left, right, betas = _world(1000, 3, L, 20_001, L + window, cuda)
    rng = np.random.default_rng(window)
    off_a = torch.as_tensor(rng.integers(0, L, size=20_001).astype(np.int32), device=cuda)
    off_b = torch.as_tensor(rng.integers(0, L, size=20_001).astype(np.int32), device=cuda)
    off_a[:7] = L - 1
    args = (codes, lengths, codes, lengths, left, right, off_a, off_b, betas)
    lvl, mss = tfused.fused_windowed_gather_score(*args, window=window)
    assert tfused.fused_windowed_gather_score.launches == 1
    torch.cuda.synchronize()
    want_lvl, want_mss = tfused.fused_windowed_gather_score_plain(*args, window=window)
    assert torch.equal(lvl, want_lvl)
    assert torch.equal(mss, want_mss)
    ref_lvl, _ = tfused.fused_windowed_score_ref(*args, window=window)
    assert torch.equal(lvl, ref_lvl)


@pytest.mark.cuda
@pytest.mark.parametrize("k,Q,L", [(3, 300, 10), (3, 300, 8), (4, 30, 12), (1, 7, 5)])
def test_shingle_kernel_equals_plain(cuda, k, Q, L):
    rng = np.random.default_rng(k + Q + L)
    n = 30_001
    lengths = torch.as_tensor(rng.integers(0, L + 1, size=n).astype(np.int32), device=cuda)
    types = torch.as_tensor(rng.integers(0, Q, size=(n, L)).astype(np.int32), device=cuda)
    types = torch.where(torch.arange(L, device=cuda) < lengths[:, None], types, -1)
    s_pad = -(-num_shingles(L, k) // 128) * 128
    got = tshk.shingle_kernel(types, lengths, k=k, num_types=Q, s_pad=s_pad)
    assert tshk.shingle_kernel.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got, tshk.shingle_plain(types, lengths, k=k, num_types=Q, s_pad=s_pad))
    keys = tshingle.shingle_keys(types, lengths, k=k, num_types=Q)
    want = tshingle.shingle_keys(types.cpu(), lengths.cpu(), k=k, num_types=Q)
    assert torch.equal(keys.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 64])
def test_subtraj_engine_kernel_impls_equal_cpu_engine(cuda, window):
    kw = dict(num_types=30, min_len=5, max_len=20, seed=0)
    cpu_batch, forest = synthetic_setup(1500, device="cpu", **kw)
    cfg = dict(subtraj_window=window, rho=2.0)
    want = AnotherMeEngine(forest, EngineConfig(**cfg), device="cpu").run(cpu_batch)
    batch, _ = synthetic_setup(1500, device=cuda, **kw)
    for impl in ("kernel", "fused", "fused-pallas"):
        got = AnotherMeEngine(forest, EngineConfig(lcs_impl=impl, **cfg), device=cuda).run(batch)
        assert got.similar_pairs == want.similar_pairs
        assert got.communities == want.communities
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(got.scored, field).cpu(), getattr(want.scored, field))
    assert tkernel.lcs_kernel.launches > 0
    assert tfused.fused_windowed_gather_score.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,Q,num_perm", [(1, 10, 30, 16), (67, 10, 30, 8), (130, 12, 1 << 20, 1),
                                            (50_001, 10, 300, 16), (20_003, 8, 1 << 20, 16)])
def test_minhash_kernel_equals_plain(cuda, n, L, Q, num_perm):
    rng = np.random.default_rng(n + L + num_perm)
    lengths = torch.as_tensor(rng.integers(0, L + 2, size=n).astype(np.int32), device=cuda)
    types = torch.as_tensor(rng.integers(0, Q, size=(n, L)).astype(np.int32), device=cuda)
    got = tminhash.minhash_signatures(types, lengths, num_perm=num_perm)
    assert tmhk.minhash_kernel.launches == 1
    torch.cuda.synchronize()
    want = tminhash.minhash_signatures(types.cpu(), lengths.cpu(), num_perm=num_perm)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,window", [("minhash", None), ("brp", None), ("udf", None),
                                            ("minhash", 8)])
def test_baseline_engines_equal_cpu_engine(cuda, backend, window):
    kw = dict(num_types=30, min_len=5, max_len=20 if window else 10, seed=0)
    cpu_batch, forest = synthetic_setup(1500, device="cpu", **kw)
    cfg = dict(backend=backend, subtraj_window=window, lcs_impl="fused")
    want = AnotherMeEngine(forest, EngineConfig(**cfg), device="cpu").run(cpu_batch)
    batch, _ = synthetic_setup(1500, device=cuda, **kw)
    got = AnotherMeEngine(forest, EngineConfig(**cfg), device=cuda).run(batch)
    assert got.similar_pairs == want.similar_pairs
    assert got.communities == want.communities
    for field in ("left", "right", "level_lcs", "mss"):
        assert torch.equal(getattr(got.scored, field).cpu(), getattr(want.scored, field))
    assert (tmhk.minhash_kernel.launches > 0) == (backend == "minhash")


@pytest.mark.cuda
def test_run_anotherme_minhash_candidates_launches_kernel(cuda):
    kw = dict(num_types=30, min_len=5, max_len=10, seed=0)
    fn = lambda e, b: minhash_candidates(type_codes(e), b.lengths, pair_capacity=1 << 18)  # noqa: E731
    cpu_batch, forest = synthetic_setup(1500, device="cpu", **kw)
    want = run_anotherme(cpu_batch, forest, candidate_fn=fn)
    assert tmhk.minhash_kernel.launches == 0
    batch, _ = synthetic_setup(1500, device=cuda, **kw)
    got = run_anotherme(batch, forest, candidate_fn=fn)
    assert tmhk.minhash_kernel.launches > 0
    assert got.similar_pairs == want.similar_pairs
    assert got.communities == want.communities


@pytest.mark.cuda
def test_brp_keys_refuse_tf32(cuda):
    rng = np.random.default_rng(5)
    types = torch.as_tensor(rng.integers(0, 300, size=(20_000, 10)).astype(np.int32), device=cuda)
    lengths = torch.as_tensor(rng.integers(1, 11, size=20_000).astype(np.int32), device=cuda)
    want = brp_bucket_keys(types.cpu(), lengths.cpu(), num_types=300)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="needs full float32 matmul"):
            brp_bucket_keys(types, lengths, num_types=300)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(brp_bucket_keys(types, lengths, num_types=300).cpu(), want)
