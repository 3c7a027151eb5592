"""Phase (ii) part 2: the SSH candidate join (paper Algorithm 2, Fig. 5).

Sort-merge join — one stable sort by shingle key, then *exact compact* pair
enumeration over equal-key runs:

  each sorted row r with in-run rank k contributes exactly k pairs (with the
  k earlier members of its run).  An exclusive cumsum of ranks assigns every
  pair a unique output slot; a vectorized ``searchsorted`` inverts slot ->
  (row, partner).  Total work O(R log R + P), no data-dependent shapes.

Pairs appearing under several shingles are deduplicated with a second sort
on the canonical (lo, hi) key, so each pair is scored exactly once (paper
section IV.3).

Capacity discipline: the pair buffer is a fixed ``pair_capacity``; if the
true pair count exceeds it the join reports ``overflow`` and the planner
retries with doubled capacity.  Buffers are bit-equal to the JAX package's
(``left``, ``right``, ``count`` and ``overflow``), overflowing runs included,
up to 2**31 pre-dedup pairs; past that the reference's int32 slot count
wraps and the port's (int64) does not.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import PAD_ID, PAD_KEY, CandidatePairs


def _runs(sorted_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (rank within equal-key run, validity) for ascending keys."""
    r = sorted_keys.shape[0]
    idx = torch.arange(r, dtype=torch.int32, device=sorted_keys.device)
    start = torch.ones(r, dtype=torch.bool, device=sorted_keys.device)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(start, idx, -1), dim=0).values
    return idx - run_start, sorted_keys != PAD_KEY


def pairs_from_rows(
    keys: torch.Tensor, ids: torch.Tensor, *, pair_capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-compact pair enumeration over flat (key, id) rows.

    Returns (lo [P_cap], hi [P_cap], overflow) — canonical but NOT deduped
    (the same pair may appear under several shared shingles).
    """
    # the JAX join sorts (keys, ids) on keys alone with a stable sort
    keys, order = torch.sort(keys, stable=True)
    ids = ids[order]
    rank, valid = _runs(keys)
    contrib = torch.where(valid, rank, 0)
    # int64 slots: the reference's int32 prefix sum wraps past 2**31 pairs
    # (its total then reads as a small or negative count, and the join
    # reports no overflow); below that the buffers are equal
    excl = torch.cumsum(contrib, dim=0, dtype=torch.int64) - contrib
    total = excl[-1] + contrib[-1]

    n_rows = keys.shape[0]
    p = torch.arange(pair_capacity, dtype=torch.int64, device=keys.device)
    # int32 result: at a 2**28-slot buffer an int64 one costs 2 GB for nothing
    row = torch.searchsorted(excl, p, right=True, out_int32=True) - 1
    row = row.clamp_(0, n_rows - 1)
    partner = row - rank[row] + (p - excl[row])
    partner = partner.clamp_(0, n_rows - 1)
    ok = p < total
    a = torch.where(ok, ids[row], PAD_ID)
    b = torch.where(ok, ids[partner], PAD_ID)
    overflow = saturate_int32(torch.clamp(total - pair_capacity, min=0))
    return torch.minimum(a, b), torch.maximum(a, b), overflow


def saturate_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 count as int32, held at 2**31 - 1 instead of wrapping."""
    return x.clamp(max=2**31 - 1).to(torch.int32)


def ssh_candidates(
    shingle_keys: torch.Tensor,
    *,
    pair_capacity: int,
    id_offset: int = 0,
) -> CandidatePairs:
    """Candidate pairs from per-trajectory shingle keys.

    shingle_keys: int32 [N, S], PAD_KEY-padded, distinct per row.
    id_offset:    added to local row indices to form global trajectory ids.
    returns CandidatePairs with canonical (left < right) deduplicated pairs.
    """
    n, s = shingle_keys.shape
    ids = torch.arange(n, dtype=torch.int32, device=shingle_keys.device) + id_offset
    lo, hi, overflow = pairs_from_rows(
        shingle_keys.reshape(-1), ids.repeat_interleave(s),
        pair_capacity=pair_capacity,
    )
    return dedup_pairs(lo, hi, overflow=overflow)


# One int64 key orders (lo, hi) lexicographically, as the reference's
# two-operand sort does: both are in [0, PAD_ID], so ``hi`` fits the low
# 32 bits without a sign bit.
_PAD_PAIR_KEY = (PAD_ID << 32) | PAD_ID


def _pair_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (lo.to(torch.int64) << 32) | hi.to(torch.int64)


def _split_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def dedup_pairs(
    lo: torch.Tensor, hi: torch.Tensor, overflow: torch.Tensor | int = 0
) -> CandidatePairs:
    """Canonicalize + deduplicate pair lists (PAD_ID slots sort to the end)."""
    key = torch.sort(_pair_key(lo, hi)).values
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[1:] = key[1:] == key[:-1]
    lo, hi = _split_key(key)
    bad = dup | (lo == hi) | (lo == PAD_ID)
    # compact valid slots to the front
    lo, hi = _split_key(torch.sort(torch.where(bad, _PAD_PAIR_KEY, key)).values)
    count = (lo != PAD_ID).sum().to(torch.int32)
    overflow = torch.as_tensor(overflow, dtype=torch.int32, device=lo.device)
    return CandidatePairs(left=lo, right=hi, count=count, overflow=overflow)


def exact_pair_count(shingle_keys: torch.Tensor) -> int:
    """Host helper: the true (pre-dedup) join size, for capacity planning."""
    keys = torch.sort(shingle_keys.reshape(-1)).values
    rank, valid = _runs(keys)
    return int(torch.where(valid, rank, 0).sum(dtype=torch.int64))
