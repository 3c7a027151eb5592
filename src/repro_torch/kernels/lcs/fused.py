"""Fused gather-and-score: code tables + pair indices -> (level_lcs, MSS).

Port of ``repro/kernels/lcs/fused.py``.  Exact pair scoring is the hot path
of the pipeline: for every candidate pair (l, r), the LCS of the two
trajectories' encodings at every semantic level, beta-combined into the MSS
(paper section IV.3).  The gather path (``score_pairs`` ->
``multi_level_lcs``) first builds two full ``[P, H, L]`` gathered copies;
the fused scorer reads each pair's rows straight out of the resident table
instead, masks positions ``>= length`` to the side sentinels itself, runs
all H levels, and emits ``level_lcs [P, H]`` and ``mss [P]`` in one pass.

* :func:`fused_gather_score` — the raw call: the Hopper kernel
  ``kernels/csrc/fused_score.cu`` on a CUDA tensor (its header notes the
  bound and the design), the plain version on a CPU tensor.  Every launch
  adds one to ``fused_gather_score.launches`` and to its route's count in
  ``launches_by_route``: :func:`route` sends DP widths up to 32 to the
  register kernels (the width a template argument) and wider ones to the
  shared-memory kernel, and the launcher runs the route it is given.  :func:`launch_variant` runs the parts of the
  design one by one, for timing only.
* :func:`fused_gather_score_plain` — the plain PyTorch version: the TPU
  kernel's ``_masked_rows_lcs`` rolling-window wavefront as written,
  batched over pairs, with the kernel's FMA-chain epilogue.
* :func:`fused_score` — the dispatch wrapper of the pipeline.

The subtrajectory mode's windowed twins take per-pair window offsets and
score the ``[H, W]`` slice ``rows[:, off : off + clip(len - off, 0, W)]``
of each side: :func:`fused_windowed_gather_score` (the Hopper kernel
``kernels/csrc/fused_windowed_score.cu`` on a CUDA tensor, counted in
``fused_windowed_gather_score.launches``),
:func:`fused_windowed_gather_score_plain`, :func:`fused_windowed_score_ref`
and the dispatch wrapper :func:`fused_windowed_score`.

Two tables are taken (``table_a``/``table_b``) so the same kernel serves a
shared table with pair indices and two operand stacks with iota indices.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B
from repro_torch.core.similarity import (
    check_lcs_len, mss_scores, multi_level_lcs, windowed_level_lcs,
)
from repro_torch.core.subtraj import slice_lengths
from repro_torch.kernels import _build
from repro_torch.kernels.lcs.kernel import (
    MAX_REGISTER_WIDTH, ROUTES, SENT_SHIFT, SENT_WINDOW, route, threads_for,
)

# the canonical lcs_impl-name -> dispatch-mode mapping for the fused family
FUSED_IMPL_MODES = {
    "fused": "auto",
    "fused-pallas": "pallas",
    "fused-interpret": "interpret",
}

_DISPATCH_MODES = ("auto", "pallas", "interpret", "ref")

# route(W), MAX_REGISTER_WIDTH and ROUTES are the batched LCS kernel's
# (kernels/lcs/kernel.py): the launchers have a register kernel for every
# DP width up to 32 and refuse wider.
# threads per block (on an H100 the register kernels ran alike at 64 and
# 128, slower at 256 and 512); the shared route's block is also capped by
# its [2, W, threads] int32 rows in threads_for
_THREADS = 128

# the variant launchers' codes (csrc/fused_score.cu); only the smoke run and
# tools/fused_score_breakdown.py call them, to time the design's parts
VARIANTS = {
    "shared_no_identity": 0,  # the parent design: shared route, DP on every pair
    # the register kernel with one part changed, at the path's width only
    # (10, and 8 windowed)
    "no_identity": 1,
    "stop_at_wla": 2,
    "loads_only": 3,          # a wrong LCS on purpose
}


def block_threads(W: int) -> int:
    """Threads per block the wrappers launch at DP width ``W``."""
    return _THREADS if route(W) == "registers" else threads_for(W, _THREADS)


def _masked_rows_lcs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-level LCS of sentinel-masked [..., H, L] rows -> [..., H] int8.

    The TPU kernel's rolling-window wavefront: a sentinel-padded reversed
    copy of b is rolled right by one lane per step, so the diagonal gather
    is a static slice; diagonals are carried in int8 (LCS <= L < 127).
    """
    *lead, L = a.shape
    dev = a.device

    def full(n, value, dtype=torch.int32):
        return torch.full((*lead, n), value, dtype=dtype, device=dev)

    a_ext = torch.cat([full(1, SENT_SHIFT), a], dim=-1)
    window = torch.cat([full(L, SENT_WINDOW), b.flip(-1), full(L - 1, SENT_WINDOW)], dim=-1)
    window = torch.roll(window, -(2 * L - 2), dims=-1)
    zero = full(1, 0, torch.int8)

    def shift_right(x):
        return torch.cat([zero, x[..., :-1]], dim=-1)

    d2 = d1 = full(L + 1, 0, torch.int8)
    for _ in range(2 * L - 1):
        match = a_ext == window[..., : L + 1]
        new = torch.where(match, shift_right(d2) + 1, torch.maximum(d1, shift_right(d1)))
        d2, d1 = d1, new
        window = torch.roll(window, 1, dims=-1)
    return d1[..., L]  # dp[L, L] per level


def _check_static(table_a, len_a, table_b, len_b, left, right, betas) -> tuple[int, int, int]:
    """The fused operands' types, devices and shapes; returns (P, H, L)."""
    tensors = dict(table_a=table_a, len_a=len_a, table_b=table_b, len_b=len_b,
                   left=left, right=right)
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if betas.dtype != torch.float32:
        raise TypeError(f"betas must be float32, got {betas.dtype}")
    devices = {t.device for t in (*tensors.values(), betas)}
    if len(devices) != 1:
        raise ValueError(f"fused operands span devices {sorted(map(str, devices))}")
    if table_a.ndim != 3 or table_b.shape[1:] != table_a.shape[1:]:
        raise ValueError(f"tables must be [N, H, L] with equal H, L: "
                         f"{tuple(table_a.shape)} vs {tuple(table_b.shape)}")
    _, H, L = table_a.shape
    P = left.shape[0]
    if left.shape != (P,) or right.shape != (P,) or betas.shape != (H,):
        raise ValueError("left/right must be [P] and betas [H]")
    if len_a.shape != table_a.shape[:1] or len_b.shape != table_b.shape[:1]:
        raise ValueError("len_a/len_b must be [N] of their tables")
    if L < 1:
        raise ValueError("code rows must hold at least one position")
    check_lcs_len(L)
    return P, H, L


def _check_ranges(checks) -> None:
    """Hold each ``(vector, hi, message)`` of ``checks`` to ``[0, hi)``, or
    raise ``IndexError(message)``: one ``aminmax`` a vector and one host sync
    for all of them.  The kernels read rows at these indices and offsets
    unchecked: a value out of range (an unclamped PAD_ID) would read outside
    the tables."""
    checks = [c for c in checks if c[0].numel()]
    if not checks:
        return
    ranges = torch.stack([torch.stack(torch.aminmax(v)) for v, _, _ in checks]).tolist()
    for (lo, top), (_, hi, message) in zip(ranges, checks):
        if lo < 0 or top >= hi:
            raise IndexError(message)


def _index_checks(left, right, table_a, table_b):
    return [(idx, n, f"{name} holds indices outside [0, {n}); clamp PAD_ID slots first")
            for name, idx, n in (("left", left, table_a.shape[0]),
                                 ("right", right, table_b.shape[0]))]


def check_tables(table_a, len_a, table_b, len_b, left, right, betas) -> tuple[int, int, int]:
    """Validate the fused operands; returns (P, H, L)."""
    P, H, L = _check_static(table_a, len_a, table_b, len_b, left, right, betas)
    _check_ranges(_index_checks(left, right, table_a, table_b))
    return P, H, L


def fused_gather_score_plain(
    table_a, len_a, table_b, len_b, left, right, betas
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fused kernel, same contract."""
    L = table_a.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=table_a.device)
    a = torch.where(pos < len_a[left][:, None, None], table_a[left], PAD_CODE_A)
    b = torch.where(pos < len_b[right][:, None, None], table_b[right], PAD_CODE_B)
    lvl = _masked_rows_lcs(a, b).to(torch.int32)
    return lvl, mss_scores(lvl, betas)


# ctypes prototypes of the C launchers (csrc/fused_score.cu,
# csrc/fused_windowed_score.cu): the engine's ends in ``int route``, a
# variant launcher's in ``int variant``
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 9 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
]
WINDOWED_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 11 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int,
]


def _bind(source: str, symbol: str, argtypes):
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# (source, symbol, prototype) of the engine's launchers: plain, windowed
_LAUNCHERS = (("fused_score", "fused_score_launch", LAUNCH_ARGTYPES),
              ("fused_windowed_score", "fused_windowed_score_launch", WINDOWED_LAUNCH_ARGTYPES))


def _launcher():
    return _bind(*_LAUNCHERS[0])


def fused_gather_score(
    table_a: torch.Tensor,
    len_a: torch.Tensor,
    table_b: torch.Tensor,
    len_b: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    betas: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw kernel call: tables + pair indices -> (level_lcs, mss).

    table_a [Na, H, L] int32, len_a [Na] int32 (idem _b), left/right [P]
    int32 indices into the respective tables (pre-clamped: no PAD_ID), betas
    [H] float32 -> (level_lcs [P, H] int32, mss [P] float32), ``mss`` from
    the kernel's own FMA-chain epilogue.  On a CUDA tensor: the kernel of
    ``route(L)`` (raises if the launch fails), counted in ``launches`` and
    ``launches_by_route``.  On a CPU tensor: :func:`fused_gather_score_plain`.
    """
    P, H, L = check_tables(table_a, len_a, table_b, len_b, left, right, betas)
    if not on_cuda(left):
        return fused_gather_score_plain(table_a, len_a, table_b, len_b, left, right, betas)
    ops = [t.contiguous() for t in (table_a, len_a, table_b, len_b, left, right, betas)]
    lvl = torch.empty((P, H), dtype=torch.int32, device=left.device)
    mss = torch.empty((P,), dtype=torch.float32, device=left.device)
    if P == 0:
        return lvl, mss
    path = route(L)
    err = _launcher()(
        *(t.data_ptr() for t in ops), lvl.data_ptr(), mss.data_ptr(),
        P, H, L, block_threads(L), torch.cuda.current_stream(left.device).cuda_stream,
        ROUTES.index(path),
    )
    _build.check(err, "fused_gather_score")
    fused_gather_score.launches += 1
    fused_gather_score.launches_by_route[path] += 1
    return lvl, mss


fused_gather_score.launches = 0
fused_gather_score.launches_by_route = {"registers": 0, "shared": 0}


def fused_score_ref(
    table_a, len_a, table_b, len_b, left, right, betas
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the fused scorer: the gather-then-score path
    (``multi_level_lcs`` + ``mss_scores``), bit-identical by construction to
    ``score_pairs(..., impl_name="wavefront")``."""
    lvl = multi_level_lcs(table_a[left], len_a[left], table_b[right], len_b[right])
    return lvl, mss_scores(lvl, betas)


def fused_score(
    table_a: torch.Tensor,
    len_a: torch.Tensor,
    table_b: torch.Tensor,
    len_b: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    betas: torch.Tensor,
    *,
    mode: str = "auto",
    exact_mss: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch wrapper mirroring ``kernels/lcs/ops.lcs``:

      "auto"       the kernel on a CUDA tensor, the gather-then-score
                   reference on a CPU tensor — the production default.
      "pallas"     always :func:`fused_gather_score` (the kernel on a CUDA
                   tensor, its plain version on a CPU tensor).
      "interpret"  always the plain version of the kernel.
      "ref"        always the gather-then-score reference.

    ``exact_mss=True`` (default) recomputes the returned mss from the
    integer level_lcs through ``mss_scores`` — the path every other
    lcs_impl takes; ``exact_mss=False`` returns the scorer's own epilogue.
    """
    if mode not in _DISPATCH_MODES:
        raise ValueError(
            f"unknown fused dispatch mode {mode!r}; "
            f"valid: {list(_DISPATCH_MODES)}"
        )
    if mode == "ref" or (mode == "auto" and not on_cuda(left)):
        return fused_score_ref(table_a, len_a, table_b, len_b, left, right, betas)
    if mode == "interpret":
        lvl, mss = fused_gather_score_plain(
            table_a, len_a, table_b, len_b, left, right, betas
        )
    else:
        lvl, mss = fused_gather_score(
            table_a, len_a, table_b, len_b, left, right, betas
        )
    if exact_mss:
        mss = mss_scores(lvl, betas)
    return lvl, mss


# ---------------------------------------------------------------------------
# windowed twins (subtrajectory mode)
# ---------------------------------------------------------------------------
def check_windowed(table_a, len_a, table_b, len_b, left, right, off_a, off_b,
                   betas, window) -> tuple[int, int, int]:
    """Validate the windowed operands; returns (P, H, L)."""
    P, H, L = _check_static(table_a, len_a, table_b, len_b, left, right, betas)
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    checks = _index_checks(left, right, table_a, table_b)
    for name, off in (("off_a", off_a), ("off_b", off_b)):
        if off.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {off.dtype}")
        if off.shape != (P,) or off.device != left.device:
            raise ValueError(f"{name} must be [P] on the pairs' device")
        # the kernel reads table[t, h, off + i]: an offset outside [0, L)
        # would read outside the row
        checks.append((off, L, f"{name} holds offsets outside [0, {L})"))
    _check_ranges(checks)
    return P, H, L


def fused_windowed_gather_score_plain(
    table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas, *, window: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the windowed kernel, same contract: the
    TPU kernel's scheme as written — each pair's full ``[H, L]`` rows, every
    position outside ``[off, off + clip(len - off, 0, W))`` masked to the
    side sentinel, the rolling-window wavefront over the masked rows.

    It is the kernel's yardstick for codes that are not the side sentinels
    (-1, -2), which the encoder never emits.  A valid code equal to one can
    match the other side's sentinels, and the whole masked rows hold more of
    them than the W-wide slices that the kernel and the gather-windows
    reference (:func:`fused_windowed_score_ref`) score, so there the two
    differ."""
    L = table_a.shape[-1]
    W = min(window, L)
    pos = torch.arange(L, dtype=torch.int32, device=table_a.device)

    def masked(table, lengths, idx, off, pad):
        wl = slice_lengths(lengths[idx], off, W)
        keep = (pos >= off[:, None]) & (pos < (off + wl)[:, None])
        return torch.where(keep[:, None, :], table[idx], pad)

    a = masked(table_a, len_a, left, off_a, PAD_CODE_A)
    b = masked(table_b, len_b, right, off_b, PAD_CODE_B)
    lvl = _masked_rows_lcs(a, b).to(torch.int32)
    return lvl, mss_scores(lvl, betas)


def _windowed_launcher():
    return _bind(*_LAUNCHERS[1])


def fused_windowed_gather_score(
    table_a: torch.Tensor,
    len_a: torch.Tensor,
    table_b: torch.Tensor,
    len_b: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    off_a: torch.Tensor,
    off_b: torch.Tensor,
    betas: torch.Tensor,
    *,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw windowed kernel call: tables + (traj, offset) coordinates.

    As :func:`fused_gather_score`, except that left/right [P] index
    TRAJECTORIES and off_a/off_b [P] int32 (in ``[0, L)``) are the window
    start offsets: the scored operand is the [H, W] slice
    ``rows[:, off : off + clip(len - off, 0, W)]``, W = min(window, L).
    On a CUDA tensor: ``fused_windowed_score.cu`` on ``route(W)`` (raises if
    the launch fails), counted in ``launches`` and ``launches_by_route``.
    On a CPU tensor: :func:`fused_windowed_gather_score_plain`.
    """
    P, H, L = check_windowed(table_a, len_a, table_b, len_b, left, right,
                             off_a, off_b, betas, window)
    if not on_cuda(left):
        return fused_windowed_gather_score_plain(
            table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas,
            window=window,
        )
    W = min(window, L)
    ops = [t.contiguous() for t in (table_a, len_a, table_b, len_b, left, right,
                                    off_a, off_b, betas)]
    lvl = torch.empty((P, H), dtype=torch.int32, device=left.device)
    mss = torch.empty((P,), dtype=torch.float32, device=left.device)
    if P == 0:
        return lvl, mss
    path = route(W)
    err = _windowed_launcher()(
        *(t.data_ptr() for t in ops), lvl.data_ptr(), mss.data_ptr(),
        P, H, L, W, block_threads(W), torch.cuda.current_stream(left.device).cuda_stream,
        ROUTES.index(path),
    )
    _build.check(err, "fused_windowed_gather_score")
    fused_windowed_gather_score.launches += 1
    fused_windowed_gather_score.launches_by_route[path] += 1
    return lvl, mss


fused_windowed_gather_score.launches = 0
fused_windowed_gather_score.launches_by_route = {"registers": 0, "shared": 0}


def launch_variant(variant: str, operands, lvl, mss, *, window=None, threads=None) -> None:
    """Run one of :data:`ROUTES` (at this width, whatever :func:`route`
    would pick) or :data:`VARIANTS` of the scorer on CUDA operands, unchecked
    and uncounted, into the preallocated ``lvl`` [P, H] and ``mss`` [P].

    ``operands`` are contiguous CUDA tensors in :func:`fused_gather_score`'s
    order, or :func:`fused_windowed_gather_score`'s (with its four [P]
    coordinate vectors) when ``window`` is given.  ``threads`` defaults to
    the wrappers' block size at the variant's route.  Raises if the variant
    has no kernel at this width.  Not on any engine path: for timing.
    """
    L = operands[0].shape[2]
    W = L if window is None else min(window, L)
    if threads is None:
        threads = threads_for(W, _THREADS) if variant.startswith("shared") else _THREADS
    P, H = lvl.shape
    dims = (L,) if window is None else (L, W)
    if variant in ROUTES:
        launcher, code = _bind(*_LAUNCHERS[window is not None]), ROUTES.index(variant)
    else:
        launcher, code = _variant_launcher(window is not None), VARIANTS[variant]
    err = launcher(
        *(t.data_ptr() for t in operands), lvl.data_ptr(), mss.data_ptr(), P, H, *dims,
        threads, torch.cuda.current_stream(lvl.device).cuda_stream, code)
    _build.check(err, f"fused scorer variant {variant}")


@functools.lru_cache(maxsize=None)
def _variant_launcher(windowed: bool):
    if windowed:
        return _bind("fused_windowed_score", "fused_windowed_score_variant_launch",
                     WINDOWED_LAUNCH_ARGTYPES)
    return _bind("fused_score", "fused_score_variant_launch", LAUNCH_ARGTYPES)


def fused_windowed_score_ref(
    table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas, *, window: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the windowed scorer: gather the [P, H, W] window slices
    (``similarity.gather_windows``) and run the gather-then-score path over
    length-W rows — bit-identical by construction to
    ``score_windowed_pairs(..., impl_name="wavefront")``."""
    lvl = windowed_level_lcs(table_a, len_a, table_b, len_b, left, right, off_a, off_b,
                             window=window)
    return lvl, mss_scores(lvl, betas)


def fused_windowed_score(
    table_a: torch.Tensor,
    len_a: torch.Tensor,
    table_b: torch.Tensor,
    len_b: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    off_a: torch.Tensor,
    off_b: torch.Tensor,
    betas: torch.Tensor,
    *,
    window: int,
    mode: str = "auto",
    exact_mss: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed twin of :func:`fused_score`: the same dispatch modes and
    ``exact_mss`` contract; pairs carry (traj, offset) coordinates."""
    if mode not in _DISPATCH_MODES:
        raise ValueError(
            f"unknown fused dispatch mode {mode!r}; "
            f"valid: {list(_DISPATCH_MODES)}"
        )
    args = (table_a, len_a, table_b, len_b, left, right, off_a, off_b, betas)
    if mode == "ref" or (mode == "auto" and not on_cuda(left)):
        return fused_windowed_score_ref(*args, window=window)
    if mode == "interpret":
        lvl, mss = fused_windowed_gather_score_plain(*args, window=window)
    else:
        lvl, mss = fused_windowed_gather_score(*args, window=window)
    if exact_mss:
        mss = mss_scores(lvl, betas)
    return lvl, mss
