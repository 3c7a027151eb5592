"""The port's Hopper kernels against their plain PyTorch versions, on the card
(and a short stream and a query batch, on one shard and on four, against the
same ones on the CPU).

Every test here launches a CUDA kernel and is marked ``cuda``: without a
CUDA device it skips.  This file imports neither ``jax`` nor ``repro``, so
it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integers (``level_lcs``, LCS values) must be equal and float32 ``mss`` bit-
equal (tolerance 0): the fused kernel's epilogue is the same forward FMA
chain (``__fmaf_rn`` in level order) as the plain ``mss_scores``.  The LM
serving kernels (flash attention, the SSD intra-chunk step) compute in
float32 and sum in another order than their plain versions: within 1e-4 in
float32, and 3e-2 for bfloat16 attention (one bfloat16 rounding of the
output, the JAX kernel tests' bar; the bfloat16 tensor-core route also
rounds p to bfloat16 before p @ v, as the Pallas body does, and stays
within the same bar; the SSD step's tensor-core route feeds the float32 M
and B * w to bf16 wgmma as three bfloat16 parts whose sum is exact, and
stays within 1e-4 too, and 5e-2 under ``bf16_intra``, the bar of the
reference's own bfloat16 mode); a reduced model served on the card
against the same run on the CPU within 5e-2 in its logits (bfloat16
activations, the reference's decode-vs-forward bar).  Training: both
kernels' autograd ops (kernel forward, torch-ops backward) against autograd
through the plain versions in float32 (3e-2 relative L2 for bfloat16
attention; 1e-4 for the SSD step, its bfloat16 operands' gradients, which
the op and the scan each round once as the reference's autodiff does,
within two bfloat16 roundings (2^-7), 5e-2 under ``bf16_intra``; dA, a sum of
cancelling terms at a decay past 88, 1e-2), and a reduced model's
gradients on the card, every leaf finite and nonzero, within 5e-2 of the
CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import AnotherMeEngine, EngineConfig
from repro_torch.core import minhash_candidates, run_anotherme, trace, type_codes
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
from repro_torch.kernels.attention import kernel as tattn
from repro_torch.kernels.ssd import kernel as tssd
from repro_torch.kernels.ssd import ops as tssd_ops
from repro_torch.kernels.ssd import ref as tssd_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("launches a Hopper kernel: needs a CUDA device (run on the H100)")
    for wrapper in (tkernel.lcs_kernel, tfused.fused_gather_score,
                    tfused.fused_windowed_gather_score, tshk.shingle_kernel,
                    tmhk.minhash_kernel, tattn.flash_attention_kernel, tssd.ssd_intra):
        wrapper.launches = 0
    tkernel.lcs_kernel.launches_by_route = {"registers": 0, "shared": 0}
    tattn.flash_attention_kernel.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
    tattn.flash_attention_kernel.copies = 0
    tssd.ssd_intra.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
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


def _hold_lcs(a, b, route):
    """#2 through its wrapper, bit-equal to its plain version, launched once
    on ``route``."""
    got = tkernel.lcs_kernel(a, b)
    assert tkernel.lcs_kernel.launches_by_route == {
        "registers": int(route == "registers"), "shared": int(route == "shared")}
    torch.cuda.synchronize()
    assert torch.equal(got, tkernel.lcs_plain(a, b))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("L", list(range(1, 33)) + [33, 64, 126])
def test_lcs_kernel_every_width(cuda, L):
    """Every register width (a template instantiation each) and the shared
    route's, at a batch that ends in a ragged 128-row tile."""
    _hold_lcs(*_rows(4099, L, L, cuda, alphabet=4), tkernel.route(L))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 127, 129, 100_003])
@pytest.mark.parametrize("L", [8, 10])
def test_lcs_kernel_ragged_batches(cuda, B, L):
    _hold_lcs(*_rows(B, L, B + L, cuda), "registers")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [10, 33])
def test_lcs_kernel_side_sentinels(cuda, L):
    """Plain equality: the pads (-1 in a, -2 in b) never match each other,
    and valid codes equal to the other side's pad match it."""
    a, b = _rows(20_011, L, 7, cuda)
    pads = torch.full_like(a, -1), torch.full_like(b, -2)
    assert not bool(_hold_lcs(*pads, tkernel.route(L)).any())
    tkernel.lcs_kernel.launches_by_route = {"registers": 0, "shared": 0}
    _hold_lcs(torch.where(a == 0, -2, a), torch.where(b == 0, -1, b), tkernel.route(L))


@pytest.mark.cuda
def test_lcs_kernel_unaligned_rows(cuda):
    """Operands 40 bytes into their storage: the register route stages them
    one int a load."""
    a, b = _rows(5_001, 10, 3, cuda)
    assert a[1:].data_ptr() % 16 != 0
    _hold_lcs(a[1:], b[1:], "registers")


@pytest.mark.cuda
def test_lcs_register_route_refuses_rows_wider_than_its_kernels(cuda):
    """The launcher runs the route it is given; at L = 33 it has no register
    kernel and refuses rather than taking another route."""
    a, b = _rows(100, 33, 1, cuda)
    out = torch.empty((100,), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="registers"):
        tkernel.launch("registers", a, b, out)
    tkernel.launch("shared", a, b, out)
    torch.cuda.synchronize()
    assert torch.equal(out, tkernel.lcs_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 10])
def test_lcs_routes_and_variants_launch_at_the_path_widths(cuda, L):
    """Both routes by name equal the plain version; the loads-only variant
    launches at the paths' widths and nowhere else."""
    a, b = _rows(30_001, L, L, cuda)
    want = tkernel.lcs_plain(a, b)
    for name in tkernel.ROUTES:
        out = torch.full((30_001,), -7, dtype=torch.int32, device=cuda)
        tkernel.launch(name, a, b, out)
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
    out = torch.empty_like(want)
    tkernel.launch("loads_only", a, b, out)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        tkernel.launch("loads_only", *_rows(30_001, 9, L, cuda), out)
    assert tkernel.lcs_kernel.launches == 0  # by name: uncounted


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


def _shingle_case(n, L, k, Q, seed, dev):
    """Codes in [0, Q) and lengths 0..L + 1 (rows shorter than k among them)."""
    rng = np.random.default_rng(seed)
    lengths = torch.as_tensor(rng.integers(0, L + 2, size=n).astype(np.int32), device=dev)
    types = torch.as_tensor(rng.integers(0, Q, size=(n, L)).astype(np.int32), device=dev)
    return types, lengths


def _hold_shingle(types, lengths, k, Q, s_pad):
    got = tshk.shingle_kernel(types, lengths, k=k, num_types=Q, s_pad=s_pad)
    torch.cuda.synchronize()
    assert torch.equal(got, tshk.shingle_plain(types, lengths, k=k, num_types=Q, s_pad=s_pad))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("L", list(range(1, 41)))
def test_shingle_kernel_every_width_and_order(cuda, L, k):
    """L 1-32 on the shuffle route, 33-40 on the shared-memory slice, k 1-4
    in registers; 1,001 rows end in a ragged block; s_pad = C(L, k) rounded
    up to 128 as the op pads it."""
    types, lengths = _shingle_case(1001, L, k, 300, 40 * k + L, cuda)
    s_pad = -(-num_shingles(L, k) // 128) * 128
    _hold_shingle(types, lengths, k, 300, s_pad)
    assert tshk.shingle_kernel.launches == int(s_pad > 0)  # L < k: nothing to write


@pytest.mark.cuda
@pytest.mark.parametrize("L,k", [(10, 3), (7, 2), (33, 2)])
@pytest.mark.parametrize("pad", ["S", "S_up_to_4", "not_multiple_of_4", "multiple_of_128"])
def test_shingle_kernel_output_widths(cuda, L, k, pad):
    """16-byte stores where s_pad % 4 == 0, scalar stores otherwise."""
    S = num_shingles(L, k)
    s_pad = {"S": S, "S_up_to_4": -(-S // 4) * 4, "not_multiple_of_4": S + 1 + (S % 4 == 3),
             "multiple_of_128": -(-S // 128) * 128 + 128}[pad]
    assert (s_pad % 4 != 0) == (pad == "not_multiple_of_4") or pad == "S"
    _hold_shingle(*_shingle_case(3001, L, k, 300, S + s_pad, cuda), k, 300, s_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,k,Q,s_pad", [
    (5001, 10, 3, 2048, 128),       # 2048**3 = 2**33: the pack wraps int32
    (5001, 12, 2, 1 << 20, 128),    # 2**40
    (3001, 12, 9, 30, 220),         # k past the register orders: the table through L1
    (3001, 10, 10, 5, 1),
    (3001, 2, 3, 7, 4),             # C(2, 3) = 0: every column PAD_KEY
    (65, 33, 6, 30, 1_107_568),     # more 128-column chunks than the grid has warps
    (1, 10, 3, 300, 128),
])
def test_shingle_kernel_edge_shapes(cuda, n, L, k, Q, s_pad):
    _hold_shingle(*_shingle_case(n, L, k, Q, n + L + k, cuda), k, Q, s_pad)


@pytest.mark.cuda
def test_shingle_kernel_refuses_rows_wider_than_its_slice(cuda):
    types, lengths = _shingle_case(2, tshk.MAX_WIDTH + 1, 1, 5, 0, cuda)
    with pytest.raises(ValueError, match="at most"):
        tshk.shingle_kernel(types, lengths, k=1, num_types=5, s_pad=tshk.MAX_WIDTH + 1)
    assert tshk.shingle_kernel.launches == 0


@pytest.mark.cuda
def test_shingle_variants_launch(cuda):
    """The parent design equals the plain version; the loads-and-stores
    variant launches at k = 3, L <= 32 only; neither is counted."""
    types, lengths = _shingle_case(30_001, 10, 3, 300, 5, cuda)
    out = torch.empty((30_001, 128), dtype=torch.int32, device=cuda)
    tshk.launch("parent", types, lengths, out, k=3, num_types=300)
    torch.cuda.synchronize()
    assert torch.equal(out, tshk.shingle_plain(types, lengths, k=3, num_types=300, s_pad=128))
    tshk.launch("loads_stores", types, lengths, out, k=3, num_types=300)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        tshk.launch("loads_stores", types, lengths, out, k=2, num_types=300)
    assert tshk.shingle_kernel.launches == 0


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


def _close(got, want, atol):
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    assert err <= atol, f"max |kernel - plain| = {err} > {atol}"


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 65, 1000])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("rep", [1, 4])
def test_flash_attention_kernel_equals_plain(cuda, S, D, rep):
    rng = np.random.default_rng(S + D + rep)
    KH = 2
    shapes = ((2, S, KH * rep, D), (2, S, KH, D), (2, S, KH, D))
    qkv = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=cuda) for s in shapes]
    launches = 0
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        q, k, v = (t.to(dtype) for t in qkv)
        for causal in (True, False):
            before = dict(tattn.flash_attention_kernel.launches_by_route)
            got = tattn.flash_attention_kernel(q, k, v, causal=causal)
            launches += 1
            assert tattn.flash_attention_kernel.launches == launches
            path = "cuda_cores" if dtype == torch.float32 else "wgmma"
            assert tattn.flash_attention_kernel.launches_by_route[path] == before[path] + 1
            assert got.dtype == dtype and got.shape == q.shape
            torch.cuda.synchronize()
            _close(got, tattn.flash_attention_plain(q, k, v, causal=causal), atol)


@pytest.mark.cuda
def test_flash_attention_kernel_strided_operands(cuda):
    """q, k, v as views of one fused projection (the fused-qkv layout)."""
    rng = np.random.default_rng(3)
    B, S, H, KH, D = 2, 130, 8, 2, 64
    qkv = torch.as_tensor(rng.normal(size=(B, S, (H + 2 * KH) * D)).astype(np.float32), device=cuda)
    q, k, v = torch.split(qkv.to(torch.bfloat16), [H * D, KH * D, KH * D], dim=-1)
    q, k, v = q.view(B, S, H, D), k.view(B, S, KH, D), v.view(B, S, KH, D)
    assert not q.is_contiguous()
    _close(tattn.flash_attention_kernel(q, k, v), tattn.flash_attention_plain(q, k, v), 3e-2)


def _wgmma_case(dev, B, Sq, Skv, H, KH, D, causal, seed):
    """One bfloat16 call on the tensor-core route: one wgmma launch, no copy,
    within 3e-2 of the plain version."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev).to(torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    fk = tattn.flash_attention_kernel
    before = dict(fk.launches_by_route)
    got = fk(q, k, v, causal=causal)
    assert fk.launches_by_route == {"wgmma": before["wgmma"] + 1, "cuda_cores": before["cuda_cores"]}
    assert fk.copies == 0
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.cuda.synchronize()
    _close(got, tattn.flash_attention_plain(q, k, v, causal=causal), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 1000, 2048])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_flash_attention_wgmma_route_equals_plain(cuda, S, D, rep):
    for causal in (True, False):
        _wgmma_case(cuda, 2, S, S, 2 * rep, 2, D, causal, S * D + rep)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(65, 1000), (1, 2048), (129, 130), (1000, 65), (2048, 129), (130, 1)])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_attention_wgmma_route_ragged_q_and_kv(cuda, Sq, Skv, D):
    for causal in (True, False):
        _wgmma_case(cuda, 2, Sq, Skv, 8, 2, D, causal, Sq + Skv + D)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 96, 112])
def test_flash_attention_wgmma_route_other_head_dims(cuda, D):
    for causal in (True, False):
        _wgmma_case(cuda, 2, 300, 300, 8, 2, D, causal, D)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(65, 1000), (1000, 65), (129, 130), (1, 300), (2048, 2048)])
@pytest.mark.parametrize("D", [144, 192, 256])
@pytest.mark.parametrize("rep", [1, 4])
def test_flash_attention_wgmma_route_past_head_dim_128(cuda, Sq, Skv, D, rep):
    """Head dims over 128 on the tensor cores (64-key tiles): ragged Sq and
    Skv, GQA 1 and 4, causal and not."""
    for causal in (True, False):
        _wgmma_case(cuda, 2, Sq, Skv, 2 * rep, 2, D, causal, Sq + Skv + D + rep)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [144, 192, 256])
def test_flash_attention_wgmma_route_mla_like_views(cuda, D):
    """MLA's operands as views: q a slice of a wider projection, k a
    ``k_full``-like slice of a buffer with rope columns past D, v zero past
    column 128 (``v_pad``); TMA reads them in place (no copy)."""
    rng = np.random.default_rng(D)
    B, S, H = 2, 300, 8
    wide = torch.as_tensor(rng.normal(size=(B, S, H, D + 64)).astype(np.float32), device=cuda)
    q = wide.to(torch.bfloat16)[..., :D]
    k = torch.as_tensor(rng.normal(size=(B, S, H, D + 32)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)[..., 32:]
    v = torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32), device=cuda).to(torch.bfloat16)
    v[..., 128:] = 0
    assert not q.is_contiguous() and not k.is_contiguous()
    got = tattn.flash_attention_kernel(q, k, v)
    assert tattn.flash_attention_kernel.launches_by_route == {"wgmma": 1, "cuda_cores": 0}
    assert tattn.flash_attention_kernel.copies == 0
    torch.cuda.synchronize()
    assert float(got[..., 128:].float().abs().max()) == 0.0
    _close(got, tattn.flash_attention_plain(q, k, v), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 192])
def test_flash_attention_wgmma_route_strided_operands(cuda, D):
    """The fused-qkv views load through TMA in place: no copy."""
    rng = np.random.default_rng(3)
    B, S, H, KH = 2, 130, 8, 2
    qkv = torch.as_tensor(rng.normal(size=(B, S, (H + 2 * KH) * D)).astype(np.float32), device=cuda)
    q, k, v = torch.split(qkv.to(torch.bfloat16), [H * D, KH * D, KH * D], dim=-1)
    q, k, v = q.view(B, S, H, D), k.view(B, S, KH, D), v.view(B, S, KH, D)
    got = tattn.flash_attention_kernel(q, k, v)
    assert tattn.flash_attention_kernel.launches_by_route["wgmma"] == 1
    assert tattn.flash_attention_kernel.copies == 0
    _close(got, tattn.flash_attention_plain(q, k, v), 3e-2)


@pytest.mark.cuda
def test_flash_attention_wgmma_route_copies_misaligned_operands(cuda):
    """A view TMA cannot read (a head stride of 200 bytes) is copied once,
    before the launch, and still takes the wgmma route."""
    rng = np.random.default_rng(4)
    B, S, H, D = 1, 70, 4, 64
    wide = torch.as_tensor(rng.normal(size=(B, S, H, D + 36)).astype(np.float32), device=cuda)
    q = wide.to(torch.bfloat16)[..., :D]
    assert not tattn.tma_ready(q)
    k, v = (torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32), device=cuda).to(torch.bfloat16)
            for _ in range(2))
    got = tattn.flash_attention_kernel(q, k, v)
    assert tattn.flash_attention_kernel.copies == 1
    assert tattn.flash_attention_kernel.launches_by_route == {"wgmma": 1, "cuda_cores": 0}
    _close(got, tattn.flash_attention_plain(q, k, v), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [72, 136, 200])
def test_flash_attention_bf16_outside_wgmma_takes_cuda_cores(cuda, D):
    rng = np.random.default_rng(D)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=cuda).to(torch.bfloat16)
               for s in ((2, 65, 8, D), (2, 65, 2, D), (2, 65, 2, D)))
    got = tattn.flash_attention_kernel(q, k, v)
    assert tattn.flash_attention_kernel.launches_by_route == {"wgmma": 0, "cuda_cores": 1}
    torch.cuda.synchronize()
    _close(got, tattn.flash_attention_plain(q, k, v), 3e-2)


def _ssd_operands(BC, Q, H, P, N, dev, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, size=(BC, Q, H)).astype(np.float32)
    cum = np.cumsum(dt * -rng.uniform(1.0, 16.0, size=(H,)).astype(np.float32), axis=1)
    x, B_, C_ = (rng.normal(size=s).astype(np.float32) for s in ((BC, Q, H, P), (BC, Q, N), (BC, Q, N)))
    to = lambda a, t=torch.float32: torch.as_tensor(a, device=dev).to(t)  # noqa: E731
    return to(x, dtype), to(cum), to(dt), to(B_, dtype), to(C_, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,P,H", [(128, 64, 64, 80), (128, 128, 64, 64), (16, 64, 64, 3),
                                     (10, 16, 32, 9), (128, 128, 128, 2)])
@pytest.mark.parametrize("dtype,path", [(torch.float32, "cuda_cores"), (torch.bfloat16, "cuda_cores"),
                                        (torch.bfloat16, "wgmma")])
def test_ssd_intra_kernel_equals_plain(cuda, Q, N, P, H, dtype, path):
    """Both routes on the same operands: the wrapper where it takes this
    route, else the route's kernel run by name (counted nowhere)."""
    ops = _ssd_operands(6, Q, H, P, N, cuda, dtype, seed=Q + N + P)
    if tssd.route(dtype, Q, P, N) == path:
        got = tssd.ssd_intra(*ops)
        assert tssd.ssd_intra.launches == 1 and tssd.ssd_intra.launches_by_route[path] == 1
    else:
        got = tssd.launch(path, *ops)
        assert tssd.ssd_intra.launches == 0
    torch.cuda.synchronize()
    for g, w in zip(got, tssd.ssd_intra_plain(*ops)):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 16, 65, 128])
@pytest.mark.parametrize("N,P", [(64, 64), (128, 64), (64, 128), (128, 128)])
def test_ssd_intra_wgmma_route_edges(cuda, Q, N, P):
    """Ragged chunks (rows past Q zero-filled by TMA and masked), one and two
    64-column tiles of N and P, and 13 heads (no block size divides them:
    the last block of a chunk has fewer heads)."""
    ops = _ssd_operands(3, Q, 13, P, N, cuda, torch.bfloat16, seed=Q * N + P)
    got = tssd.ssd_intra(*ops)
    assert tssd.ssd_intra.launches_by_route == {"wgmma": 1, "cuda_cores": 0}
    torch.cuda.synchronize()
    for g, w in zip(got, tssd.ssd_intra_plain(*ops)):
        _close(g, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,P,H", [(128, 64, 64, 80), (65, 128, 128, 9), (10, 16, 32, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_bf16_intra_on_the_wgmma_route(cuda, Q, N, P, H, dtype):
    """``bf16_intra`` rounds where the plain version rounds (float32 operands
    are rounded to bfloat16 first): within 5e-2, one bfloat16 rounding."""
    ops = _ssd_operands(4, Q, H, P, N, cuda, dtype, seed=Q + H)
    got = tssd.ssd_intra(*ops, bf16_intra=True)
    assert tssd.ssd_intra.launches_by_route == {"wgmma": 1, "cuda_cores": 0}
    torch.cuda.synchronize()
    for g, w in zip(got, tssd.ssd_intra_plain(*ops, bf16_intra=True)):
        _close(g, w, 5e-2)


@pytest.mark.cuda
def test_ssd_scan_on_the_card_and_refusals(cuda):
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 256, 8, 64, 64
    x, Bm, Cm = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=cuda)
                 for s in ((B, S, H, P), (B, S, 1, N), (B, S, 1, N)))
    dt = torch.as_tensor(rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32), device=cuda)
    A = -torch.as_tensor(rng.uniform(1.0, 16.0, size=H).astype(np.float32), device=cuda)
    D = torch.ones(H, device=cuda)
    y, st = tssd_ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    assert tssd.ssd_intra.launches == 1
    ry, rst = tssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    _close(y, ry, 1e-4)
    _close(st, rst, 1e-4)
    y16, st16 = tssd_ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128, bf16_intra=True)
    assert tssd.ssd_intra.launches_by_route == {"wgmma": 1, "cuda_cores": 1}
    ry16, rst16 = tssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128, bf16_intra=True)
    _close(y16, ry16, 5e-2)
    _close(st16, rst16, 5e-2)
    with pytest.raises(TypeError, match="one dtype"):
        tssd.ssd_intra(*_ssd_operands(2, 16, 2, 8, 8, cuda)[:3], Bm[:2, :16, 0].bfloat16(),
                       Cm[:2, :16, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b", "zamba2-2.7b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b", "minicpm3-4b"])
def test_reduced_lm_served_on_the_card_equals_cpu(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache

    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, "cpu", dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 18)))
    logits = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        lp, cache = prefill_with_cache(p, tokens[:, :16].to(dev), cfg, 32)
        step = make_decode_step(cfg)
        out = [lp]
        for t in (16, 17):
            ld, cache = step(p, cache, tokens[:, t:t + 1].to(dev))
            out.append(ld)
        logits[str(dev)] = torch.cat(out, dim=1).cpu()
    if cfg.family != "ssm":
        assert tattn.flash_attention_kernel.launches > 0
    if cfg.family in ("ssm", "hybrid"):
        assert tssd.ssd_intra.launches > 0
    V = cfg.vocab_size
    _close(logits[str(cuda)][..., :V], logits["cpu"][..., :V], 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b"])
def test_reduced_frontend_forward_on_the_card_equals_cpu(cuda, arch):
    """The audio frames and the vision patches of ``make_inputs``."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.inputs import make_inputs
    from repro_torch.models.model import forward, init_params

    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, "cpu")
    inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device="cpu")
    inputs.pop("labels")
    logits = {str(dev): forward(_to(params, dev), _to(inputs, dev), cfg)[0].cpu() for dev in ("cpu", cuda)}
    assert tattn.flash_attention_kernel.launches == cfg.num_layers
    V = cfg.vocab_size
    _close(logits[str(cuda)][..., :V], logits["cpu"][..., :V], 5e-2)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# training: the two kernels' gradients and a reduced model's on the card
# ---------------------------------------------------------------------------
def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _vjp(fn, args, cots):
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(sum((o.float() * c).sum() for o, c in zip(outs, cots)), args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal,tol", [
    ((2, 512, 8, 8, 80), torch.bfloat16, True, 3e-2),     # zamba2's heads, wgmma
    ((2, 300, 8, 2, 128), torch.bfloat16, True, 3e-2),    # granite's GQA, ragged
    ((1, 256, 4, 4, 192), torch.bfloat16, False, 3e-2),   # MLA's head dim, wgmma (64-key tiles)
    ((2, 200, 4, 2, 64), torch.float32, True, 1e-4),      # float32, CUDA cores
])
def test_flash_attention_backward_on_the_card(cuda, shape, dtype, causal, tol):
    """The autograd op's gradient (the kernel forward, ``flash_attention_bwd``)
    against autograd through the plain version in float32, same inputs."""
    from repro_torch.kernels.attention.ops import flash_attention

    B, S, H, KH, D = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=cuda).to(dtype)
               for sh in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    dout = torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32), device=cuda)
    with trace.counting() as calls:
        got = _vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal), (q, k, v), (dout,))
    assert tattn.flash_attention_kernel.launches == 1
    assert (trace.calls(calls, "flash_attention.bwd"), trace.calls(calls, "ssd_intra.bwd")) == (1, 0)
    want = _vjp(lambda q, k, v: tattn.flash_attention_plain(q, k, v, causal=causal),
                [t.float() for t in (q, k, v)], (dout,))
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= tol, _rel_l2(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bf16_intra,tol", [
    (torch.bfloat16, False, 1e-4),   # wgmma
    (torch.float32, False, 1e-4),    # CUDA cores
    (torch.float32, True, 5e-2),     # wgmma, bf16_intra
])
def test_ssd_backward_on_the_card(cuda, dtype, bf16_intra, tol):
    """``ssd_chunked``'s gradient through the intra-chunk op (the kernel
    forward, ``ssd_intra_bwd``) against autograd through the plain scan in
    float32, at a decay that overflows the unmasked exponential."""
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 256, 16, 64, 64
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda)  # noqa: E731
    x, Bm, Cm = (f(rng.normal(size=sh)).to(dtype) for sh in ((B, S, H, P), (B, S, 1, N), (B, S, 1, N)))
    dt = f(rng.uniform(1e-3, 1e-1, size=(B, S, H)))
    A = -f(rng.uniform(1.0, 16.0, size=H))
    A[0] = -60.0  # a decay span past 88 inside a chunk
    D = f(rng.normal(size=H))
    # y comes out in x's dtype, so its cotangent enters in that dtype: both
    # runs get it rounded so
    cots = (f(rng.normal(size=(B, S, H, P))).to(dtype).float(), f(rng.normal(size=(B, H, P, N))))
    with trace.counting() as calls:
        got = _vjp(lambda *a: tssd_ops.ssd_chunked(*a, chunk=128, bf16_intra=bf16_intra),
                   (x, dt, A, Bm, Cm, D), cots)
    assert tssd.ssd_intra.launches == 1
    assert (trace.calls(calls, "flash_attention.bwd"), trace.calls(calls, "ssd_intra.bwd")) == (0, 1)
    want = _vjp(lambda *a: tssd_ref.ssd_chunked(*a, chunk=128, bf16_intra=bf16_intra),
                [t.float() for t in (x, dt, A, Bm, Cm, D)], cots)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        assert bool(torch.isfinite(g).all()), name
        bar = max(tol, 1e-2) if name == "A" else tol
        if g.dtype == torch.bfloat16:
            # the op hands its cotangent of x, B, C on in their dtype and the
            # scan adds the skip term's, as the reference's autodiff rounds
            # each use's cotangent: two bfloat16 roundings, 2^-7
            bar = max(bar, 2.0 ** -7)
        assert _rel_l2(g, w) <= bar, (name, _rel_l2(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b", "zamba2-2.7b", "deepseek-v2-236b"])
def test_reduced_lm_gradients_on_the_card(cuda, arch):
    """One ``loss_and_grads`` on the card: every leaf finite and nonzero
    (no leaf left without a gradient by a kernel's output), loss within
    5e-2 of the CPU's and each leaf within 5e-2 relative L2 (bfloat16
    activations); the kernels launched forward and recomputed."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.inputs import make_inputs
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import loss_and_grads

    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, "cpu")
    inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        moe.reset_dropped()
        loss, _, grads = loss_and_grads(_to(params, dev), _to(inputs, dev), cfg)
        runs[str(dev)] = (float(loss), [g.cpu() for g in leaves(grads)], moe.dropped_assignments())
    (loss_c, g_c, drop_c), (loss_g, g_g, drop_g) = runs["cpu"], runs[str(cuda)]
    assert abs(loss_g - loss_c) <= 5e-2 and drop_g == drop_c
    for g, w in zip(g_g, g_c):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        assert _rel_l2(g, w) <= 5e-2
    if cfg.family != "ssm":
        assert tattn.flash_attention_kernel.launches == 2 * (cfg.num_layers if cfg.family != "hybrid"
                                                             else cfg.num_layers // cfg.shared_attn_every)
    if cfg.family in ("ssm", "hybrid"):
        assert tssd.ssd_intra.launches == 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# streaming ingestion and top-k serving on the card against the CPU
# ---------------------------------------------------------------------------
STREAM_WORLD = dict(num_types=8, classes_per_type=3, num_places=80, seed=4)


def _streams(cuda, impl, components_impl, backend="ssh", n=600, delta_join="host", shards=1,
             mode="replicate", oc=1):
    """The same short stream (5 micro-batches, window 3, a TTL of 2 on batch
    1, a retire after update 2) on the card with ``impl`` and on the CPU
    with the plain wavefront, both on ``delta_join`` and ``shards`` shards
    of their device.  Returns {device: (engine, [result per update])}."""
    from repro_torch.api import ExecutionPlan, StreamingEngine
    from repro_torch.core.types import TrajectoryBatch

    cfg = dict(rho=1.5, community_mode="components", backend=backend)
    out = {}
    for dev, lcs_impl in ((cuda, impl), ("cpu", "wavefront")):
        batch, forest = synthetic_setup(n, device=dev, **STREAM_WORLD)
        plan = ExecutionPlan(delta_join=delta_join, n_shards=shards, devices=(dev,) * shards,
                             score_mode=mode, overlap_chunks=oc)
        engine = StreamingEngine(forest, EngineConfig(lcs_impl=lcs_impl, **cfg), plan,
                                 components_impl=components_impl, window=3, device=dev)
        step, results = n // 5, []
        for u in range(5):
            s = slice(u * step, (u + 1) * step)
            mb = TrajectoryBatch(places=batch.places[s], lengths=batch.lengths[s],
                                 user_id=batch.user_id[s])
            results.append(engine.update(mb, ttl=2 if u == 1 else None))
            if u == 2:
                engine.retire(range(0, 3 * step, 7))
        out[dev] = (engine, results)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("impl,components_impl,backend,delta_join", [
    ("fused", "unionfind", "ssh", "host"), ("kernel", "jit", "ssh", "host"),
    ("fused", "jit", "minhash", "host"), ("kernel", "unionfind", "brp", "host"),
    ("fused", "unionfind", "ssh", "device"), ("kernel", "jit", "minhash", "device"),
])
def test_stream_on_the_card_equals_cpu(cuda, impl, components_impl, backend, delta_join):
    runs = _streams(cuda, impl, components_impl, backend, delta_join=delta_join)
    (card, got), (_, want) = runs[cuda], runs["cpu"]
    for u, (g, w) in enumerate(zip(got, want)):
        for field in ("left", "right", "level_lcs", "mss"):
            assert getattr(g.scored, field).device.type == "cuda"
            assert torch.equal(getattr(g.scored, field).cpu(), getattr(w.scored, field)), (u, field)
        assert g.similar_pairs == w.similar_pairs, u
        assert g.communities == w.communities, u
        assert g.stats["pairs_examined"] == w.stats["pairs_examined"], u
        assert g.stats["driver_pair_rows"] == 0 or delta_join == "host", u
    assert card.compactions >= 1 and max(len(w.similar_pairs) for w in want) > 0
    if delta_join == "device":
        assert torch.equal(card._slab_keys.cpu(), runs["cpu"][0]._slab_keys)
        assert torch.equal(card._slab_rows.cpu(), runs["cpu"][0]._slab_rows)
    kern = tfused.fused_gather_score if impl == "fused" else tkernel.lcs_kernel
    assert kern.launches > 0
    assert (tmhk.minhash_kernel.launches > 0) == (backend == "minhash")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "kernel"])
@pytest.mark.parametrize("serve_prune", [False, True])
@pytest.mark.parametrize("delta_join", ["host", "device"])
def test_query_batch_on_the_card_equals_cpu(cuda, impl, serve_prune, delta_join):
    from repro_torch.api import QueryEngine

    runs = _streams(cuda, impl, "unionfind", delta_join=delta_join)
    rng = np.random.default_rng(9)
    k = rng.integers(0, 8, size=40).astype(np.int32)
    rho = rng.choice([0.5, 1.5, 2.5], size=40).astype(np.float32)
    res = {}
    for dev in (cuda, "cpu"):
        queries, _ = synthetic_setup(40, device=dev, **{**STREAM_WORLD, "seed": 11})
        qe = QueryEngine(runs[dev][0], k=5, serve_prune=serve_prune)
        res[dev] = (qe.query(queries), qe.query(queries, k=k, rho=rho))
    for got, want in zip(res[cuda], res["cpu"]):
        assert np.array_equal(got.match_ids, want.match_ids)
        assert np.array_equal(got.mss, want.mss)
        assert got.stats["candidates"] == want.stats["candidates"] > 0
    assert (got.match_ids != 2**31 - 1).any()
    kern = tfused.fused_gather_score if impl == "fused" else tkernel.lcs_kernel
    assert kern.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("impl,backend,delta_join,mode,oc", [
    ("fused", "ssh", "host", "replicate", 1), ("kernel", "ssh", "host", "shuffle", 4),
    ("fused", "minhash", "device", "replicate", 1), ("kernel", "ssh", "device", "shuffle", 1),
])
def test_sharded_stream_on_the_card_equals_cpu(cuda, impl, backend, delta_join, mode, oc):
    """Four shards on the card against the plain wavefront on the CPU (one
    shard), update by update, then a query batch over each world."""
    from repro_torch.api import QueryEngine

    card, got = _streams(cuda, impl, "unionfind", backend, delta_join=delta_join, shards=4,
                         mode=mode, oc=oc)[cuda]
    cpu, want = _streams(cuda, impl, "unionfind", backend, delta_join=delta_join)["cpu"]
    for u, (g, w) in enumerate(zip(got, want)):
        for field in ("left", "right", "level_lcs", "mss"):
            assert torch.equal(getattr(g.scored, field).cpu(), getattr(w.scored, field)), (u, field)
        assert g.similar_pairs == w.similar_pairs and g.communities == w.communities, u
        assert g.stats["pairs_examined"] == w.stats["pairs_examined"], u
    assert card.compactions >= 1 and card._base % 4 == 0
    assert {d.type for d in card._eng.mesh().devices} == {"cuda"}
    kern = tfused.fused_gather_score if impl == "fused" else tkernel.lcs_kernel
    assert kern.launches > 0
    assert (tmhk.minhash_kernel.launches > 0) == (backend == "minhash")
    for prune in (False, True):
        res = []
        for stream, dev in ((card, cuda), (cpu, "cpu")):
            queries, _ = synthetic_setup(40, device=dev, **{**STREAM_WORLD, "seed": 11})
            res.append(QueryEngine(stream, k=5, serve_prune=prune).query(queries))
        assert np.array_equal(res[0].match_ids, res[1].match_ids)
        assert np.array_equal(res[0].mss, res[1].mss)
        assert (res[0].match_ids != 2**31 - 1).any()


# ---------------------------------------------------------------------------
# the device join's slab operations on the card against the CPU
# ---------------------------------------------------------------------------
def _big_slab(n, seed, dead=0.1, alphabet=200_000):
    """A sorted slab of ``n`` (key, row) entries (a tenth tombstoned) in
    ``n + n // 8`` slots, and ``n // 16`` incoming occurrences, as numpy."""
    from repro_torch.core.types import PAD_ID, PAD_KEY

    rng = np.random.default_rng(seed)
    cap = n + n // 8
    keys = np.sort(rng.integers(0, alphabet, size=n)).astype(np.int32)
    rows = rng.permutation(n).astype(np.int32)
    rows[rng.random(n) < dead] = PAD_ID
    kk = np.full((cap,), PAD_KEY, np.int32)
    rr = np.full((cap,), PAD_ID, np.int32)
    kk[:n], rr[:n] = keys, rows
    m = n // 16
    in_k = np.full((m + 64,), PAD_KEY, np.int32)
    in_r = np.full((m + 64,), PAD_ID, np.int32)
    in_k[:m] = rng.integers(0, alphabet, size=m)
    in_r[:m] = n + np.arange(m)
    return kk, rr, in_k, in_r


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["probe_pairs", "merge_insert", "probe_rows", "mark_dead_rows",
                                "compact_slab"])
def test_slab_op_on_the_card_equals_cpu(cuda, op):
    """Each slab operation on a random slab of ~1M entries: the card's
    outputs equal the CPU's, buffer for buffer."""
    from repro_torch.core import device_index as di

    kk, rr, in_k, in_r = _big_slab(1 << 20, seed=5)
    dead = np.sort(np.random.default_rng(6).choice(1 << 20, size=4096, replace=False))
    dead = dead.astype(np.int32)
    calls = {
        "probe_pairs": lambda k, r, a, b, d: di.probe_pairs(k, r, a, b, nn_cap=1 << 15,
                                                            no_cap=1 << 20),
        "merge_insert": lambda k, r, a, b, d: di.merge_insert(k, r, a, b),
        "probe_rows": lambda k, r, a, b, d: di.probe_rows(k, r, a, b, cap=1 << 20),
        "mark_dead_rows": lambda k, r, a, b, d: (di.mark_dead_rows(r, d),),
        "compact_slab": lambda k, r, a, b, d: di.compact_slab(k, r, 17, out_cap=1 << 20),
    }
    outs = {}
    for dev in (cuda, "cpu"):
        args = [torch.as_tensor(x, device=dev) for x in (kk, rr, in_k, in_r, dead)]
        outs[dev] = calls[op](*args)
    for got, want in zip(outs[cuda], outs["cpu"]):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want), op


@pytest.mark.cuda
@pytest.mark.parametrize("backend,mode,oc,prune,window,impl,launched", [
    ("ssh", "replicate", 1, False, None, "fused", "fused_gather_score"),
    ("ssh", "shuffle", 4, True, None, "fused", "fused_gather_score"),
    ("ssh", "shuffle", 1, False, None, "kernel", "lcs_kernel"),
    ("ssh", "replicate", 1, True, 8, "fused", "fused_windowed_gather_score"),
    ("ssh", "shuffle", 4, False, 8, "fused", "fused_windowed_gather_score"),
    ("minhash", "replicate", 1, False, None, "fused", "minhash_kernel"),
    ("udf", "shuffle", 1, False, None, "fused", "fused_gather_score"),
])
def test_sharded_engine_on_the_card_equals_cpu(cuda, backend, mode, oc, prune, window, impl,
                                               launched):
    """Four shards on the one card against the same plan on four CPU
    shards (plain versions): every per-shard buffer, the similar pairs and
    the communities; the path's kernel launched once a shard at least."""
    from repro_torch.api import ExecutionPlan
    from repro_torch.api import engine as tengine

    wrappers = {"fused_gather_score": tfused.fused_gather_score, "lcs_kernel": tkernel.lcs_kernel,
                "fused_windowed_gather_score": tfused.fused_windowed_gather_score,
                "minhash_kernel": tmhk.minhash_kernel}
    results = {}
    for dev in ("cpu", cuda):
        batch, forest = synthetic_setup(1_001, num_types=30, seed=5, device=dev,
                                        **({"min_len": 10, "max_len": 20} if window else {}))
        plan = ExecutionPlan(n_shards=4, devices=(dev,) * 4, score_mode=mode, overlap_chunks=oc)
        cfg = EngineConfig(backend=backend, score_prune=prune, subtraj_window=window,
                           lcs_impl=impl, community_mode="components")
        eng = AnotherMeEngine(forest, cfg, plan, device=dev)
        captured = {}
        execute = tengine._ShardedEncodeJoinScoreStage._execute

        def capture(self, *a, **k):
            out = execute(self, *a, **k)
            captured["out"] = out[0]
            return out

        tengine._ShardedEncodeJoinScoreStage._execute = capture
        try:
            wrappers[launched].launches = 0
            res = eng.run(batch)
        finally:
            tengine._ShardedEncodeJoinScoreStage._execute = execute
        results[str(dev)] = (res, {k: v.cpu() for k, v in captured["out"].items()},
                             wrappers[launched].launches)
    (want, want_out, _), (got, got_out, launches) = results["cpu"], results[str(cuda)]
    assert launches >= 4 if launched != "minhash_kernel" else launches >= 5
    for field in want_out:
        assert torch.equal(got_out[field], want_out[field]), field
    assert got.similar_pairs == want.similar_pairs and got.communities == want.communities
    assert got.stats["join_overflow"] == 0 and len(want.similar_pairs) > 0
