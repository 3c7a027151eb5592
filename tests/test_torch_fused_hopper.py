"""The fused LCS scorers' Hopper design: routes, shortcuts and exactness.

``fused_gather_score`` (#1) and ``fused_windowed_gather_score`` (#3) run a
register kernel whose width is a template argument for DP widths up to 32,
and the shared-memory kernel above.  Both skip the DP for a pair whose two
sides are one row (one window) of one table.  A variant timed beside them
stops the row loop at the a side's length unless b holds a valid code
equal to side A's sentinel.  The CPU tests hold the facts these rest on
against the JAX package (its Pallas kernels in interpret mode) and against
numpy DPs; the ``cuda`` tests hold every kernel width, route and variant
bit-equal to the plain versions on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fused_hopper.py

Integers are compared exactly and float32 ``mss`` with tolerance 0 (the
kernels' epilogue is the plain version's FMA chain).  The JAX package is
imported inside the tests that use it, so the ``cuda`` tests also run where
only PyTorch is installed.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lcs import fused as tfused

REGISTER_WIDTHS = list(range(1, 33))
SHARED_WIDTHS = [33, 64, 126]


@pytest.fixture
def jfused():
    pytest.importorskip("jax")
    from repro.kernels.lcs import fused

    return fused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("launches a Hopper kernel: needs a CUDA device (run on the H100)")
    for w in (tfused.fused_gather_score, tfused.fused_windowed_gather_score):
        w.launches = 0
        w.launches_by_route = {"registers": 0, "shared": 0}
    return torch.device("cuda", torch.cuda.current_device())


def T(x, dev="cpu"):
    return torch.as_tensor(np.array(x), device=dev)  # a copy: JAX arrays are read-only


def assert_same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _world(N, H, L, P, seed, alphabet=6, sentinel_codes=False):
    """A code table with rows of 0..L valid positions, -1 past them; with ``sentinel_codes`` a quarter of the valid codes are the
    side sentinels -1 and -2."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 1, size=N).astype(np.int32)
    lengths[0] = L
    codes = rng.integers(0, alphabet, size=(N, H, L)).astype(np.int32)
    if sentinel_codes:
        pick = rng.random((N, H, L)) < 0.25
        codes[pick] = rng.integers(-2, 0, size=int(pick.sum()))
    codes = np.where(np.arange(L)[None, None, :] >= lengths[:, None, None], -1, codes).astype(np.int32)
    left = rng.integers(0, N, size=P).astype(np.int32)
    right = rng.integers(0, N, size=P).astype(np.int32)
    betas = rng.random(H).astype(np.float32)
    return codes, lengths, left, right, betas


def _wl(lengths, L, off=0, W=None):
    W = L if W is None else W
    return np.clip(np.minimum(lengths, L) - off, 0, W)


# ---------------------------------------------------------------------------
# the DP facts the kernels rest on (numpy)
# ---------------------------------------------------------------------------
def _dp_table(a, b, cell):
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int64)
    for i in range(len(a)):
        for j in range(len(b)):
            dp[i + 1, j + 1] = cell(dp[i, j], dp[i, j + 1], dp[i + 1, j], a[i] == b[j])
    return dp


def _three_way_max(diag, up, left, eq):
    return max(up, left, diag + int(eq))


def _select(diag, up, left, eq):
    return diag + 1 if eq else max(up, left)


def _masked(row, n, W, sentinel):
    out = np.full(W, sentinel, np.int64)
    n = max(0, min(n, W))
    out[:n] = row[:n]
    return out


@pytest.mark.parametrize("W", list(range(0, 33)))
def test_three_way_max_cell_equals_select_cell(W):
    """max(up, left, diag + match) is the select recurrence, cell for cell,
    on rows with sentinel-valued codes: diag <= max(up, left) <= diag + 1."""
    rng = np.random.default_rng(W)
    for _ in range(6):
        a = _masked(rng.integers(-2, 3, size=W), int(rng.integers(0, W + 1)), W, -1)
        b = _masked(rng.integers(-2, 3, size=W), int(rng.integers(0, W + 1)), W, -2)
        np.testing.assert_array_equal(_dp_table(a, b, _three_way_max), _dp_table(a, b, _select))


def _register_model(a_row, wla, b_row, wlb, W):
    """The ``stop_at_wla`` variant's DP as written: rows stop at wla unless b
    holds a valid -1; columns run to W with b's sentinels."""
    a = _masked(a_row, wla, W, -1)
    b = _masked(b_row, wlb, W, -2)
    rows = W if (b[: max(0, min(wlb, W))] == -1).any() else max(0, min(wla, W))
    dp = np.zeros(W + 1, np.int64)
    for i in range(rows):
        new = np.zeros(W + 1, np.int64)
        for j in range(W):
            new[j + 1] = _three_way_max(dp[j], dp[j + 1], new[j], a[i] == b[j])
        dp = new
    return int(dp[W])


@pytest.mark.parametrize("W", [1, 2, 3, 5, 8, 10, 16, 32])
def test_stop_at_wla_equals_the_full_dp(W):
    rng = np.random.default_rng(100 + W)
    for _ in range(40):
        a_row, b_row = rng.integers(-2, 3, size=(2, W))
        wla, wlb = rng.integers(-1, W + 2, size=2)
        a, b = _masked(a_row, wla, W, -1), _masked(b_row, wlb, W, -2)
        assert _register_model(a_row, wla, b_row, wlb, W) == _dp_table(a, b, _select)[W, W]


def test_rows_past_wla_count_when_b_holds_a_valid_minus_one():
    """Why the stop has its exception: side A's sentinel -1 matches b's valid
    -1 codes, so the masked rows' LCS exceeds the valid prefixes' LCS."""
    a = _masked(np.array([7, 0, 0]), 1, 3, -1)  # [7, -1, -1]
    b = np.array([-1, -1, 7])                   # three valid codes
    assert _dp_table(a, b, _select)[3, 3] == 2
    assert _dp_table(a[:1], b, _select)[1, 3] == 1  # stopping at wla = 1 would say 1
    assert _register_model(np.array([7, 0, 0]), 1, b, 3, 3) == 2


def test_columns_past_wlb_count_when_a_holds_a_valid_minus_two():
    """Why the columns run to W: a's valid -2 codes match b's sentinels."""
    a = np.array([-2, -2, 7])
    b = _masked(np.array([7, 0, 0]), 1, 3, -2)  # [7, -2, -2]
    assert _dp_table(a, b, _select)[3, 3] == 2
    assert _dp_table(a, b[:1], _select)[3, 1] == 1


@pytest.mark.parametrize("W", [1, 2, 4, 7, 10])
def test_identical_masked_rows_give_their_length_for_any_codes(W):
    """The identity shortcut's fact, on random rows over an alphabet that
    holds both sentinels: LCS(x + [-1]*k, x + [-2]*k) == len(x)."""
    rng = np.random.default_rng(W)
    rows = rng.integers(-4, 2, size=(60, W))
    for row in rows:
        for n in range(W + 1):
            a, b = _masked(row, n, W, -1), _masked(row, n, W, -2)
            assert _dp_table(a, b, _select)[W, W] == n


# ---------------------------------------------------------------------------
# identity pairs in the JAX package and the plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sentinel_codes", [False, True])
@pytest.mark.parametrize("L", [8, 10])
def test_identical_pairs_score_their_length(jfused, L, sentinel_codes):
    """Pairs (i, i) of one table: |M_h| = min(len, L) at every level, in the
    JAX kernel (interpret mode) and the port's plain version, whatever the
    codes (sentinel-valued ones included)."""
    codes, lengths, _, _, betas = _world(12, 3, L, 1, seed=L, sentinel_codes=sentinel_codes)
    idx = np.arange(12, dtype=np.int32)
    args = (codes, lengths, codes, lengths, idx, idx, betas)
    want = np.repeat(_wl(lengths, L)[:, None], 3, axis=1).astype(np.int32)
    j_lvl, j_mss = jfused.fused_gather_score(*args, interpret=True)
    t_lvl, t_mss = tfused.fused_gather_score_plain(*map(T, args))
    assert_same(j_lvl, want)
    assert_same(t_lvl, want)
    assert_same(t_mss, j_mss)
    assert_same(tfused.fused_gather_score(*map(T, args))[0], want)


@pytest.mark.parametrize("sentinel_codes", [False, True])
@pytest.mark.parametrize("L,window", [(20, 8), (10, 4), (9, 9)])
def test_identical_windows_score_their_window_length(jfused, L, window, sentinel_codes):
    codes, lengths, _, _, betas = _world(10, 3, L, 1, seed=L + window, sentinel_codes=sentinel_codes)
    W = min(window, L)
    traj = np.repeat(np.arange(10, dtype=np.int32), 2)
    off = np.tile(np.array([0, L - 1], np.int32), 10)
    off[4:8] = (1, 2, 3, W)
    args = (codes, lengths, codes, lengths, traj, traj, off, off, betas)
    want = np.repeat(_wl(lengths[traj], L, off, W)[:, None], 3, axis=1).astype(np.int32)
    j_lvl, j_mss = jfused.fused_windowed_gather_score(*args, window=window, interpret=True)
    t_lvl, t_mss = tfused.fused_windowed_gather_score_plain(*map(T, args), window=window)
    assert_same(j_lvl, want)
    assert_same(t_lvl, want)
    assert_same(t_mss, j_mss)


# ---------------------------------------------------------------------------
# the route, the launchers and the checks (no card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [1, 8, 10, 20, 32, 33, 64, 126])
def test_route_by_width(W):
    assert tfused.route(W) == ("registers" if W <= 32 else "shared")
    threads = tfused.block_threads(W)
    assert threads >= 32 and threads & (threads - 1) == 0
    if tfused.route(W) == "shared":
        assert 2 * W * threads * 4 <= 48 * 1024  # the 48 KB default


def test_register_width_matches_the_kernel_source():
    text = (_build.CSRC / "pair_dp.cuh").read_text()
    m = re.search(r"constexpr int kMaxRegisterWidth = (\d+);", text)
    assert m and int(m.group(1)) == tfused.MAX_REGISTER_WIDTH == 32


def test_route_codes_match_the_kernel_source():
    """The wrappers pass route(W) to the launchers by its index in ROUTES."""
    text = (_build.CSRC / "pair_dp.cuh").read_text()
    m = re.search(r"enum : int \{ kRouteRegisters = (\d+), kRouteShared = (\d+) \};", text)
    assert m and tuple(map(int, m.groups())) == (0, 1)
    assert tfused.ROUTES == ("registers", "shared")
    assert not set(tfused.ROUTES) & set(tfused.VARIANTS)


_CTYPE_OF = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    types = []
    for param in m.group(1).split(","):
        words = param.split()
        base = " ".join(w.strip("*") for w in words[:-1] if w.strip("*"))
        types.append(_CTYPE_OF[base + ("*" if "*" in param else "")])
    return types


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("fused_score", "fused_score_launch", tfused.LAUNCH_ARGTYPES),
    ("fused_score", "fused_score_variant_launch", tfused.LAUNCH_ARGTYPES),
    ("fused_windowed_score", "fused_windowed_score_launch", tfused.WINDOWED_LAUNCH_ARGTYPES),
    ("fused_windowed_score", "fused_windowed_score_variant_launch",
     tfused.WINDOWED_LAUNCH_ARGTYPES),
])
def test_launcher_prototypes_match_the_sources(source, symbol, argtypes):
    assert argtypes == _c_signature(source, symbol)


@pytest.mark.parametrize("source", ["fused_score", "fused_windowed_score"])
def test_every_variant_has_a_kernel_in_the_source(source):
    text = (_build.CSRC / f"{source}.cu").read_text()
    launcher = text[text.index(f'extern "C" int {source}_variant_launch'):]
    codes = {int(c) for c in re.findall(r"variant == (\d+)", launcher)}
    for lo, hi in re.findall(r"variant >= (\d+) && variant <= (\d+)", launcher):
        codes |= set(range(int(lo), int(hi) + 1))
        flags = re.search(r"kFlags\[\] = \{(.*?)\};", launcher, re.S).group(1)
        assert flags.count(",") + 1 == int(hi) - int(lo) + 1
    assert codes == set(tfused.VARIANTS.values())


def test_range_checks_take_one_host_sync(monkeypatch):
    """The wrappers hold indices and offsets to their ranges in one sync."""
    codes, lengths, left, right, betas = map(T, _world(9, 3, 10, 40, seed=3))
    off = torch.zeros_like(left)
    syncs = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: syncs.append(1) or real(t))
    for bad in ("item", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, bad, lambda t: pytest.fail("an extra host sync"))
    tfused.check_tables(codes, lengths, codes, lengths, left, right, betas)
    tfused.check_windowed(codes, lengths, codes, lengths, left, right, off, off, betas, 8)
    assert len(syncs) == 2


# ---------------------------------------------------------------------------
# the port against the JAX package at the widths either side of the routes
# ---------------------------------------------------------------------------
def _check_fused(jfused, codes, lengths, left, right, betas):
    args = (codes, lengths, codes, lengths, left, right, betas)
    want_lvl, want_mss = jfused.fused_score(*args, mode="interpret")
    assert_same(want_lvl, jfused.fused_score_ref(*args)[0])
    raw_lvl, _ = jfused.fused_gather_score(*args, interpret=True)
    t_args = tuple(map(T, args))
    for mode in ("auto", "pallas", "interpret", "ref"):
        for exact in (True, False):
            lvl, mss = tfused.fused_score(*t_args, mode=mode, exact_mss=exact)
            assert_same(lvl, want_lvl)
            assert_same(mss, want_mss)
    assert_same(tfused.fused_gather_score(*t_args)[0], raw_lvl)
    assert_same(tfused.fused_gather_score_plain(*t_args)[0], raw_lvl)


@pytest.mark.parametrize("L", [8, 10, 20, 32, 33])
def test_fused_matches_jax_either_side_of_the_route(jfused, L):
    codes, lengths, left, right, betas = _world(11, 3, L, 13, seed=L)
    left[:3] = right[:3]  # identical pairs among them
    _check_fused(jfused, codes, lengths, left, right, betas)


@pytest.mark.parametrize("L,window", [(20, 8), (33, 32), (40, 33)])
def test_fused_windowed_matches_jax_either_side_of_the_route(jfused, L, window):
    codes, lengths, left, right, betas = _world(9, 3, L, 11, seed=L + window)
    rng = np.random.default_rng(window)
    off_a, off_b = rng.integers(0, L, size=(2, 11)).astype(np.int32)
    off_a[:2] = L - 1
    left[:3], off_a[:3] = right[:3], off_b[:3]  # identical windows among them
    args = (codes, lengths, codes, lengths, left, right, off_a, off_b, betas)
    want_lvl, want_mss = jfused.fused_windowed_score(*args, window=window, mode="interpret")
    for mode in ("auto", "pallas", "interpret", "ref"):
        lvl, mss = tfused.fused_windowed_score(*map(T, args), window=window, mode=mode)
        assert_same(lvl, want_lvl)
        assert_same(mss, want_mss)


# ---------------------------------------------------------------------------
# on the card: every width, route and variant against the plain versions
# ---------------------------------------------------------------------------
def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _buffer(N, H, L, P, seed, count=None, sentinel_codes=False):
    """An engine-like buffer: pairs sorted by (left, right), identical pairs
    among them, and the tail from ``count`` on clamped to the pair (0, 0)."""
    codes, lengths, left, right, betas = _world(N, H, L, P, seed, sentinel_codes=sentinel_codes)
    left[: P // 20] = right[: P // 20]
    order = np.lexsort((right, left))
    left, right = left[order], right[order]
    if count is not None:
        left[count:] = right[count:] = 0
    return codes, lengths, left, right, betas


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 3, 5])
@pytest.mark.parametrize("L", REGISTER_WIDTHS + SHARED_WIDTHS)
def test_kernel_equals_plain_at_every_width(cuda, L, H):
    ops = _on(cuda, *_buffer(400, H, L, 3001, seed=L * 7 + H, count=2400))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl, mss = tfused.fused_gather_score(*args)
    torch.cuda.synchronize()
    want_lvl, want_mss = tfused.fused_gather_score_plain(*args)
    assert torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss)
    assert tfused.fused_gather_score.launches_by_route == {
        "registers": int(L <= 32), "shared": int(L > 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel_codes", [False, True])
@pytest.mark.parametrize("L", [1, 10, 32, 33, 126])
def test_identity_pairs_on_the_card(cuda, L, sentinel_codes):
    codes, lengths, _, _, betas = _world(2000, 3, L, 1, seed=L, sentinel_codes=sentinel_codes)
    idx = np.arange(2000, dtype=np.int32)
    c, n, i, b = _on(cuda, codes, lengths, idx, betas)
    lvl, mss = tfused.fused_gather_score(c, n, c, n, i, i, b)
    want_lvl, want_mss = tfused.fused_gather_score_plain(c, n, c, n, i, i, b)
    assert torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss)
    assert bool((lvl.cpu() == torch.as_tensor(_wl(lengths, L))[:, None]).all())
    # a copy of the same table is another table: the DP runs, same answer
    lvl2, mss2 = tfused.fused_gather_score(c, n, c.clone(), n.clone(), i, i, b)
    assert torch.equal(lvl2, want_lvl) and torch.equal(mss2, want_mss)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [10, 20, 33])
def test_sentinel_valued_codes_and_a_pad_tail(cuda, L):
    ops = _on(cuda, *_buffer(3000, 3, L, 50_001, seed=L, count=21_234, sentinel_codes=True))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl, mss = tfused.fused_gather_score(*args)
    want_lvl, want_mss = tfused.fused_gather_score_plain(*args)
    assert torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [9, 10, 40])
def test_two_tables_iota(cuda, L):
    ca, la, _, _, betas = _world(500, 3, L, 1, seed=1)
    cb, lb, _, _, _ = _world(500, 3, L, 1, seed=2)
    iota = np.arange(500, dtype=np.int32)
    args = _on(cuda, ca, la, cb, lb, iota, iota, betas)
    got = tfused.fused_gather_score(*args)
    want = tfused.fused_gather_score_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _windowed_buffer(N, H, L, P, seed, count, sentinel_codes=False):
    codes, lengths, left, right, betas = _world(N, H, L, P, seed, sentinel_codes=sentinel_codes)
    rng = np.random.default_rng(seed + 1)
    off_a, off_b = rng.integers(0, L, size=(2, P)).astype(np.int32)
    off_a[:7] = off_b[7:14] = L - 1
    left[20:40], off_a[20:40] = right[20:40], off_b[20:40]  # identical windows
    left[count:] = right[count:] = off_a[count:] = off_b[count:] = 0
    return codes, lengths, left, right, off_a, off_b, betas


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 3, 5])
@pytest.mark.parametrize("W", REGISTER_WIDTHS + SHARED_WIDTHS)
def test_windowed_kernel_equals_plain_at_every_width(cuda, W, H):
    L = min(W + 5, 126)
    ops = _on(cuda, *_windowed_buffer(400, H, L, 3001, seed=W * 7 + H, count=2400))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl, mss = tfused.fused_windowed_gather_score(*args, window=W)
    torch.cuda.synchronize()
    want_lvl, want_mss = tfused.fused_windowed_gather_score_plain(*args, window=W)
    assert torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss)
    assert tfused.fused_windowed_gather_score.launches_by_route == {
        "registers": int(W <= 32), "shared": int(W > 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel_codes", [False, True])
@pytest.mark.parametrize("L,window", [(20, 8), (12, 12), (40, 33)])
def test_windowed_identity_sentinels_and_pad_tail(cuda, L, window, sentinel_codes):
    """With sentinel-valued codes the windowed kernels score the W-wide
    slices, as the gather-windows reference does (and as the parent kernel
    did); the plain version masks whole L-wide rows, whose extra sentinel
    positions such codes can match, so it is the yardstick for codes >= 0
    only."""
    ops = _on(cuda, *_windowed_buffer(3000, 3, L, 50_001, seed=L, count=21_234,
                                      sentinel_codes=sentinel_codes))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl, mss = tfused.fused_windowed_gather_score(*args, window=window)
    want = tfused.fused_windowed_score_ref if sentinel_codes else tfused.fused_windowed_gather_score_plain
    want_lvl, want_mss = want(*args, window=window)
    assert torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss)


@pytest.mark.cuda
def test_windowed_two_tables_iota(cuda):
    ca, la, _, _, betas = _world(500, 3, 20, 1, seed=1)
    cb, lb, _, _, _ = _world(500, 3, 20, 1, seed=2)
    iota = np.arange(500, dtype=np.int32)
    off = np.full(500, 3, np.int32)
    args = _on(cuda, ca, la, cb, lb, iota, iota, off, off, betas)
    got = tfused.fused_windowed_gather_score(*args, window=8)
    want = tfused.fused_windowed_gather_score_plain(*args, window=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(tfused.ROUTES) + sorted(tfused.VARIANTS))
def test_variants_at_the_path_widths(cuda, variant):
    """Both routes and every variant launch at the paths' widths; all but
    ``loads_only`` equal the plain versions, and none is counted."""
    ops = _on(cuda, *_buffer(3000, 3, 10, 20_001, seed=5, count=9_000, sentinel_codes=True))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl = torch.empty((20_001, 3), dtype=torch.int32, device=cuda)
    mss = torch.empty((20_001,), dtype=torch.float32, device=cuda)
    tfused.launch_variant(variant, args, lvl, mss)
    wops = _on(cuda, *_windowed_buffer(3000, 3, 20, 20_001, seed=6, count=9_000))
    wargs = (wops[0], wops[1], wops[0], wops[1], *wops[2:])
    wlvl, wmss = torch.empty_like(lvl), torch.empty_like(mss)
    tfused.launch_variant(variant, wargs, wlvl, wmss, window=8)
    torch.cuda.synchronize()
    if variant != "loads_only":
        want = tfused.fused_gather_score_plain(*args)
        assert torch.equal(lvl, want[0]) and torch.equal(mss, want[1])
        want = tfused.fused_windowed_gather_score_plain(*wargs, window=8)
        assert torch.equal(wlvl, want[0]) and torch.equal(wmss, want[1])
    assert tfused.fused_gather_score.launches == tfused.fused_windowed_gather_score.launches == 0


@pytest.mark.cuda
def test_path_width_variants_refuse_other_widths(cuda):
    ops = _on(cuda, *_buffer(100, 3, 9, 101, seed=5))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl = torch.empty((101, 3), dtype=torch.int32, device=cuda)
    mss = torch.empty((101,), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="stop_at_wla"):
        tfused.launch_variant("stop_at_wla", args, lvl, mss)


@pytest.mark.cuda
def test_register_route_refuses_rows_wider_than_its_kernels(cuda):
    """The launcher runs the route it is given; at L = 33 it has no register
    kernel, and refuses rather than taking another route."""
    ops = _on(cuda, *_buffer(100, 3, 33, 101, seed=5))
    args = (ops[0], ops[1], ops[0], ops[1], *ops[2:])
    lvl = torch.empty((101, 3), dtype=torch.int32, device=cuda)
    mss = torch.empty((101,), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="registers"):
        tfused.launch_variant("registers", args, lvl, mss)
