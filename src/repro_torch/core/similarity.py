"""Phase (iii): multi-level semantic trajectory similarity (Definitions 2,4,5).

``|M_h|`` is the length of the longest common subsequence (LCS) of the two
trajectories' level-h encodings — repetition-aware, unlike set-based prior
work (paper section IV.3).  ``MSS = sum_h beta_h * |M_h|``.

Two plain implementations of the batched LCS:

* ``lcs_ref``      — textbook row DP (the oracle; O(La*Lb) sequential
                     tensor steps, used in tests only).
* ``lcs_wavefront``— anti-diagonal wavefront: 2L-1 vectorized steps keeping
                     two rolling diagonals.  The plain version the LCS
                     kernels of ``repro_torch.kernels.lcs`` are held against.

Padding convention: pad side A with PAD_CODE_A (-1) and side B with
PAD_CODE_B (-2); padded tails never match so LCS(full padded) == LCS(true
prefixes).  Callers gathering both sides from the same EncodedBatch must
re-pad one side (see ``repad``).

``mss_scores`` is a forward float32 FMA chain in level order, because that
is the order in which the reference's float32 ``einsum`` rounds: every
``lcs_impl`` of both packages then yields bit-identical ``mss``, and the
float32 ``mss > rho`` test picks the same pairs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B
from repro_torch.core.subtraj import slice_lengths, window_coords
from repro_torch.core.types import PAD_ID


def repad(codes: torch.Tensor, lengths: torch.Tensor, pad_code: int) -> torch.Tensor:
    """Set padded positions (>= length) of [..., L] codes to ``pad_code``."""
    L = codes.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=codes.device)
    mask = (pos[None, :] < lengths.reshape(-1, 1)).reshape(lengths.shape + (L,))
    # broadcast mask over any intermediate dims (e.g. levels)
    while mask.ndim < codes.ndim:
        mask = mask[..., None, :]
    return torch.where(mask, codes, pad_code)


def lcs_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle LCS, batched: a [B, La], b [B, Lb] -> int32 [B].

    Classic row-major DP, one tensor op per cell.
    """
    B, La = a.shape
    Lb = b.shape[1]
    prev = torch.zeros((B, Lb + 1), dtype=torch.int32, device=a.device)
    for i in range(La):
        ai = a[:, i]
        left = torch.zeros((B,), dtype=torch.int32, device=a.device)
        row = [left]
        for j in range(Lb):
            match = (ai == b[:, j]) & (ai >= 0)
            left = torch.where(match, prev[:, j] + 1, torch.maximum(prev[:, j + 1], left))
            row.append(left)
        prev = torch.stack(row, dim=1)
    return prev[:, -1]


def wavefront_dtype_from_env() -> torch.dtype:
    """Resolve the REPRO_LCS_DTYPE probe (``int32`` or the int8 default)
    at a call boundary."""
    return torch.int32 if os.environ.get("REPRO_LCS_DTYPE") == "int32" else torch.int8


def check_lcs_len(*lengths: int) -> None:
    """LCS values are carried in int8 (and the kernels' small DP cells):
    every row length must stay below 127."""
    if any(n >= 127 for n in lengths):
        raise ValueError(f"LCS rows must be shorter than 127, got {lengths}")


def lcs_wavefront(
    a: torch.Tensor, b: torch.Tensor, *, dtype: torch.dtype = torch.int8
) -> torch.Tensor:
    """Anti-diagonal wavefront LCS, batched: a [B, La], b [B, Lb] -> int32 [B].

    dp[i, j] laid out along diagonals t = i + j; diagonal t stored as
    d_t[i] = dp[i, t - i] over the full i range [0, La].  Two rolling
    diagonals, La + Lb - 1 steps of vector ops, carried in ``dtype`` (int8
    by default: LCS values <= L < 127).
    """
    B, La = a.shape
    Lb = b.shape[1]
    check_lcs_len(La, Lb)
    dev = a.device
    i = torch.arange(La + 1, dtype=torch.int64, device=dev)  # dp row index
    ai = a[:, (i - 1).clamp(0, La - 1)]                       # a[i-1]
    zero_col = torch.zeros((B, 1), dtype=dtype, device=dev)

    def shift(d):  # x[i-1] with x[-1] := 0
        return torch.cat([zero_col, d[:, :-1]], dim=1)

    d_prev2 = d_prev1 = torch.zeros((B, La + 1), dtype=dtype, device=dev)
    for t in range(2, La + Lb + 1):
        j = t - i
        bj = b[:, (j - 1).clamp(0, Lb - 1)]
        valid = (i >= 1) & (j >= 1) & (j <= Lb)
        match = (ai == bj) & valid[None, :]
        new = torch.where(match, shift(d_prev2) + 1, torch.maximum(d_prev1, shift(d_prev1)))
        new = torch.where(valid[None, :], new, 0)
        d_prev2, d_prev1 = d_prev1, new
    # final diagonal t = La + Lb holds dp[La, Lb] at i = La
    return d_prev1[:, La].to(torch.int32)


def multi_level_lcs(
    codes_a: torch.Tensor,
    len_a: torch.Tensor,
    codes_b: torch.Tensor,
    len_b: torch.Tensor,
    *,
    impl=None,
) -> torch.Tensor:
    """|M_h| for every level: [P, n_levels, L] x2 -> int32 [P, n_levels].

    Levels are folded into the batch dimension — the LCS recurrence is
    level-independent, so one batched call covers all levels.
    """
    if impl is None:
        impl = lcs_wavefront
    P, H, L = codes_a.shape
    a = repad(codes_a, len_a, PAD_CODE_A).reshape(P * H, L)
    b = repad(codes_b, len_b, PAD_CODE_B).reshape(P * H, L)
    return impl(a, b).reshape(P, H)


def gather_windows(codes: torch.Tensor, off: torch.Tensor, window: int) -> torch.Tensor:
    """Slice per-row windows out of gathered code rows.

    codes [P, H, L], off [P] window start offsets -> [P, H, W] with
    W = min(window, L).  Positions past ``L - 1`` clamp to the last column
    (garbage); callers mask by the window's valid length — for any valid
    position ``i < clip(len - off, 0, W)``, ``off + i < len <= L``, so the
    clamp never corrupts a valid entry.
    """
    L = codes.shape[-1]
    W = min(window, L)
    pos = off[:, None, None] + torch.arange(W, dtype=torch.int32, device=codes.device)
    pos = pos.clamp(0, L - 1).long()
    return torch.gather(codes, -1, pos.expand(*codes.shape[:-1], W))


def windowed_level_lcs(table_a, len_a, table_b, len_b, left, right, off_a, off_b,
                       *, window: int, impl=None) -> torch.Tensor:
    """|M_h| of the window slices: rows ``left``/``right`` of the tables
    cut to ``[off, off + clip(len - off, 0, W))`` -> int32 [P, H], by
    gathering the [P, H, W] windows and running the batched LCS ``impl``
    (the wavefront by default) over length-W rows."""
    W = min(window, table_a.shape[-1])
    wla = slice_lengths(len_a[left], off_a, W)
    wlb = slice_lengths(len_b[right], off_b, W)
    return multi_level_lcs(
        gather_windows(table_a[left], off_a, W), wla,
        gather_windows(table_b[right], off_b, W), wlb, impl=impl,
    )


def score_windowed_pairs(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    betas: torch.Tensor,
    *,
    nw: int,
    window: int,
    stride: int = 1,
    impl_name: str = "wavefront",
    wavefront_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed ``score_pairs``: pair ids are WINDOW ids, not row ids.

    codes [N, H, L], lengths [N], left/right [P] global window ids
    (``traj = w // nw``, ``offset = (w % nw) * stride``) -> (level_lcs
    [P, H], mss [P]) of the windowed slices.  Invalid slots (PAD_ID) are
    clamped to window 0 of row 0.  The fused impls route to the
    offset-aware fused scorer (the slices never materialize); "wavefront"
    and "ref" gather the [P, H, W] windows and run the batched LCS over
    length-W rows.
    """
    ta, oa = window_coords(left, nw=nw, stride=stride)
    tb, ob = window_coords(right, nw=nw, stride=stride)
    if impl_name.startswith("fused"):
        from repro_torch.kernels.lcs import fused

        return fused.fused_windowed_score(
            codes, lengths, codes, lengths, ta, tb, oa, ob, betas,
            window=window, mode=fused.FUSED_IMPL_MODES[impl_name],
        )
    if impl_name == "wavefront":
        dt = torch.int8 if wavefront_dtype is None else wavefront_dtype
        impl = lambda a, b: lcs_wavefront(a, b, dtype=dt)  # noqa: E731
    else:
        impl = {"ref": lcs_ref}[impl_name]
    lv = windowed_level_lcs(codes, lengths, codes, lengths, ta, tb, oa, ob,
                            window=window, impl=impl)
    return lv, mss_scores(lv, betas)


def mss_scores(level_lcs: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """MSS = sum_h beta_h * |M_h| (Definition 4). level_lcs [P, H] -> f32 [P].

    The forward float32 FMA chain ``acc = fma(|M_h|, beta_h, acc)`` for
    h = 0..H-1 from acc = 0, the rounding order of the reference.  Each FMA
    is emulated in float64: the product of an integer <= 126 and a float32
    beta is exact there, and so is its sum with the float32 accumulator
    whenever the two lie within 2**22 of each other in magnitude (always,
    for betas of like size), so one rounding to float32 per step gives the
    FMA's result.  ``einsum``, ``@`` or
    ``.sum(-1)`` round in other orders and change the similar-pair set.
    """
    lv = level_lcs.to(torch.float64)
    b = betas.to(torch.float32).to(torch.float64)
    acc = torch.zeros(lv.shape[:-1], dtype=torch.float32, device=lv.device)
    for h in range(lv.shape[-1]):
        acc = (lv[..., h] * b[h] + acc.to(torch.float64)).to(torch.float32)
    return acc


def default_betas(n_levels: int, device=None) -> torch.Tensor:
    """Paper default: equal weights 1/n (section V.1)."""
    return torch.full((n_levels,), 1.0 / n_levels, dtype=torch.float32,
                      device=resolve_device(device))


def mss_upper_bound(len_a, len_b, betas_sum):
    """The free MSS upper bound: ``sum_h beta_h * min(len_a, len_b)``.

    Every level's LCS is at most ``min(len_a, len_b)`` (lengths are shared
    across levels), so ``MSS <= betas_sum * min(len_a, len_b)`` — computable
    from lengths alone.  Exact on np arrays, float32 on tensors, so the
    pruning pass and the capacity planner agree on the bound.
    """
    if isinstance(len_a, np.ndarray):
        return np.minimum(len_a, len_b).astype(np.float32) * np.float32(betas_sum)
    return torch.minimum(len_a, len_b).to(torch.float32) * betas_sum


# Pruning keeps a pair when its upper bound clears ``tau - PRUNE_EPS``: the
# hair of slack only ever keeps extra pairs (which then get scored exactly),
# guarding against the bound and the float32 MSS rounding in opposite
# directions around an exact-threshold tie.
PRUNE_EPS = 1e-5


def score_pairs(
    codes: torch.Tensor,
    lengths: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    betas: torch.Tensor,
    impl_name: str = "wavefront",
    wavefront_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather + score candidate pairs against the encoded table.

    codes [N, H, L], lengths [N], left/right [P] -> (level_lcs [P, H], mss [P]).
    Invalid slots (PAD_ID) are clamped to row 0; callers mask by pair validity.

    ``impl_name="fused"`` (and the forced "fused-pallas"/"fused-interpret"
    variants) routes to the gather-free fused scorer
    (kernels/lcs/fused.py), which never materializes the [P, H, L] operand
    copies this gather path builds.
    """
    li = torch.where(left == PAD_ID, 0, left)
    ri = torch.where(right == PAD_ID, 0, right)
    if impl_name.startswith("fused"):
        from repro_torch.kernels.lcs import fused

        return fused.fused_score(
            codes, lengths, codes, lengths, li, ri, betas,
            mode=fused.FUSED_IMPL_MODES[impl_name],
        )
    if impl_name == "wavefront":
        dt = torch.int8 if wavefront_dtype is None else wavefront_dtype
        impl = lambda a, b: lcs_wavefront(a, b, dtype=dt)  # noqa: E731
    else:
        impl = {"ref": lcs_ref}[impl_name]
    lv = multi_level_lcs(codes[li], lengths[li], codes[ri], lengths[ri], impl=impl)
    return lv, mss_scores(lv, betas)
