"""Phase (ii) part 1: k-sequential shingling (paper Definition 3, Algorithm 1).

A k-sequential shingle is an order-preserving k-subsequence of the *type*
level codes of a trajectory.  The paper's triple nested loop (k=3) becomes a
static gather over the precomputed C(L_max, k) index combinations followed
by a base-Q integer pack.  Set semantics (distinct shingles per trajectory)
are restored with an in-row sort + duplicate masking, as the paper dedups
shingles before the self-join.

The packed shingle key is ``sum_i code_i * Q**(k-1-i)`` — a perfect hash of
the shingle (no collisions).  We require Q**k < 2**31.
"""
from __future__ import annotations

import functools
import itertools
from math import comb

import numpy as np
import torch

from repro_torch.core.subtraj import num_windows, window_lengths
from repro_torch.core.types import PAD_KEY

# Hard budget on C(max_len, k): the combination table materializes eagerly
# into an unbounded lru_cache, so an oversized (max_len, k) would exhaust
# host memory before any shape error surfaced.
MAX_SHINGLE_COMBOS = 2_000_000


@functools.lru_cache(maxsize=None)
def shingle_indices(max_len: int, k: int) -> np.ndarray:
    """All C(max_len, k) strictly-increasing index k-tuples, int32 [S, k]."""
    n_combos = comb(max_len, k) if max_len >= k >= 0 else 0
    if n_combos > MAX_SHINGLE_COMBOS:
        raise ValueError(
            f"C({max_len}, {k}) = {n_combos} shingle combinations exceeds "
            f"the budget of {MAX_SHINGLE_COMBOS}; shingling the full "
            "trajectory at this length would exhaust host memory.  Use the "
            "windowed subtrajectory mode instead — "
            "EngineConfig(subtraj_window=W) shingles C(W, k) combinations "
            "per sliding window."
        )
    combos = np.array(list(itertools.combinations(range(max_len), k)), dtype=np.int32)
    if combos.size == 0:
        combos = combos.reshape(0, k)
    return combos


def num_shingles(max_len: int, k: int) -> int:
    return shingle_indices(max_len, k).shape[0]


def expected_collision_rate(avg_len: float, k: int, num_types: int) -> float:
    """The paper's collision-rate model: C(L, k) / Q**k (section IV.2)."""
    return comb(int(avg_len), k) / float(num_types) ** k


def pack_keys(codes: torch.Tensor, num_types: int) -> torch.Tensor:
    """Base-Q pack of [..., k] type codes into one int32 key."""
    k = codes.shape[-1]
    if num_types**k >= 2**31:
        raise ValueError(
            f"Q**k = {num_types}**{k} overflows int32; use a smaller k or Q "
            "(the paper uses Q<=300, k=3)."
        )
    key = torch.zeros(codes.shape[:-1], dtype=torch.int32, device=codes.device)
    for i in range(k):
        key = key * num_types + codes[..., i]
    return key


def shingles_from_types(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    num_types: int,
    dedup: bool = True,
) -> torch.Tensor:
    """Distinct k-sequential shingle keys per trajectory.

    type_codes: int32 [N, L] (coarsest-level codes, padding may be negative)
    lengths:    int32 [N]
    returns:    int32 [N, S] ascending-sorted keys, PAD_KEY padded,
                S = C(L, k).
    """
    n, L = type_codes.shape
    idx = torch.as_tensor(shingle_indices(L, k), device=type_codes.device)
    gathered = type_codes[:, idx]                          # [N, S, k]
    # a combination is valid iff its last (largest) index < length
    valid = idx[:, -1][None, :] < lengths[:, None]         # [N, S]
    safe = torch.where(valid[..., None], gathered, 0)
    keys = torch.where(valid, pack_keys(safe, num_types), PAD_KEY)
    if dedup:
        keys = torch.sort(keys, dim=-1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = keys[:, 1:] == keys[:, :-1]
        keys = torch.sort(torch.where(dup, PAD_KEY, keys), dim=-1).values
    return keys


def windowed_types(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int,
    stride: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window view for the subtrajectory mode: [N, L] -> [N*nw, W].

    Window j of row i (j < nw, see
    :func:`repro_torch.core.subtraj.num_windows`) starts at offset
    ``j * stride`` and holds ``clip(lengths[i] - j*stride, 0, W)`` valid
    positions; every window of row i becomes its own virtual row
    ``i * nw + j``, so the key machinery (``shingles_from_types``) runs
    unchanged over the view — a window's keys are ``S = C(W, k)``
    combinations instead of ``C(L, k)``.  Positions past a window's valid
    length gather clamped garbage; callers mask by the returned window
    lengths exactly as they mask full rows by ``lengths``.
    """
    n, L = type_codes.shape
    W = min(window, L)
    nw = num_windows(L, window, stride)
    dev = type_codes.device
    offs = torch.arange(nw, dtype=torch.int32, device=dev) * stride      # [nw]
    pos = offs[:, None] + torch.arange(W, dtype=torch.int32, device=dev)  # [nw, W]
    win = type_codes[:, pos.clamp(0, L - 1).long()]                       # [N, nw, W]
    wlen = window_lengths(lengths, max_len=L, window=window, stride=stride)
    return win.reshape(n * nw, W), wlen


def shingles(encoded_codes: torch.Tensor, lengths: torch.Tensor, *, k: int,
             num_types: int, level: int = 0, dedup: bool = True) -> torch.Tensor:
    """Convenience wrapper taking EncodedBatch.codes [N, n_levels, L]."""
    return shingles_from_types(
        encoded_codes[:, level, :], lengths, k=k, num_types=num_types, dedup=dedup
    )
