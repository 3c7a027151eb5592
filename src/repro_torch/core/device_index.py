"""Device-resident bucket state of the streaming join, and its host mirror.

Port of ``repro/core/device_index.py``.  With
``ExecutionPlan(delta_join="device")`` the key -> [row ids] join state
leaves the host and lives on the device as one sorted slab a shard (every
(key, row) occurrence on shard ``hash(key) % n_shards``), a flat
``[n_shards * cap]`` pair of tensors:

  * ``slab_keys`` int32 ``[cap]`` a shard: its (key, row) occurrences, sorted
    ascending by key with ``PAD_KEY`` (= INT32_MAX) padding at the end, so
    one ``searchsorted`` finds any key's bucket as a contiguous run;
  * ``slab_rows`` int32 ``[cap]``: the row id of each slot (``PAD_ID`` in
    padding and in tombstones).

The slab operations are torch ops on one shard's slab (sorts, searchsorted,
cumsum and index writes; the JAX package writes them in ``jnp``, outside
any Pallas kernel), except :func:`mark_dead_rows`, which takes the flat
slabs of every shard:

  :func:`probe_pairs`     this update's delta pairs: new-vs-old by a range
                          probe of the slab, new-vs-new by equal-key run
                          ranks, with exact pre-dedup ``examined`` counts;
  :func:`merge_insert`    stable sorted merge of the new (key, row) rows
                          into the slab, dropped valid entries counted;
  :func:`probe_rows`      the read-only probe query serving runs;
  :func:`mark_dead_rows`  tombstone the slots of retired rows;
  :func:`compact_slab`    drop the tombstones and rebase the row ids.

Every output equals the JAX function's, buffer for buffer.  Two-key sorts
(``lax.sort(..., num_keys=2)`` there) sort one packed int64 key here: the
first key in the high 32 bits, the second offset by 2**31 in the low ones,
so signed int32 order and ``PAD_KEY``/``PAD_ID`` last are kept.
``probe_pairs_ref``, ``probe_rows_ref``, ``merge_insert_ref`` and
``compact_slab_ref`` are the JAX package's numpy oracles.

The host keeps only counts: :class:`StreamJoinStats` (per-key occurrence
counts that size the join's buffers exactly) and :class:`ShardSummaries`
(the serve-time REPOSE prune bounds).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssh import _runs
from repro_torch.core.types import PAD_ID, PAD_KEY


def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 key whose order is the lexicographic order of two int32
    keys (``a`` first), both signed."""
    return (a.to(torch.int64) << 32) | (b.to(torch.int64) + 2**31)


def _sort2(a: torch.Tensor, b: torch.Tensor):
    """``lax.sort((a, b), num_keys=2)``: both int32 operands sorted by
    (a, b); equal pairs are equal, so stability does not matter."""
    order = torch.sort(_pack2(a, b)).indices
    return a[order], b[order]


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _enumerate_slots(excl: torch.Tensor, counts: torch.Tensor, cap: int):
    """Invert slot -> (entry, offset) for run-length pair enumeration.

    excl: non-decreasing int32 exclusive prefix sum of ``counts``.  Slot
    ``p`` belongs to the last entry ``e`` with ``excl[e] <= p`` (entries with
    zero count share their successor's prefix and are never selected for a
    valid slot); offset ``t = p - excl[e]``.
    """
    n = excl.shape[0]
    p = torch.arange(cap, dtype=torch.int32, device=excl.device)
    e = torch.searchsorted(excl, p, right=True, out_int32=True) - 1
    e = e.clamp(0, n - 1)
    el = e.long()
    t = p - excl[el]
    total = excl[-1] + counts[-1]
    return p, el, t, total


def _excl_cumsum(c: torch.Tensor) -> torch.Tensor:
    """int32 exclusive prefix sum (the reference's ``cumsum(c) - c``)."""
    return torch.cumsum(c, dim=0, dtype=torch.int32) - c


def _range_probe(slab_keys, keys_s, valid):
    """Resident bucket ``[lo, hi)`` of each sorted incoming key."""
    lo = torch.searchsorted(slab_keys, keys_s, right=False, out_int32=True)
    hi = torch.searchsorted(slab_keys, keys_s, right=True, out_int32=True)
    return lo, torch.where(valid, hi - lo, 0)


def probe_pairs(
    slab_keys: torch.Tensor,
    slab_rows: torch.Tensor,
    keys: torch.Tensor,
    rows: torch.Tensor,
    *,
    nn_cap: int,
    no_cap: int,
):
    """Delta pairs of one update's incoming (key, row) rows on one shard.

    slab_keys/slab_rows: the resident sorted slab (PAD at the end).
    keys/rows: int32 [R] incoming occurrences, PAD-padded anywhere; sorted
        here.
    nn_cap/no_cap: capacities of the new-vs-new / new-vs-old pair buffers
        (planned exactly on the host; overflow counted, never silent).

    Returns ``(lo [nn_cap + no_cap], hi, examined, overflow)``: the
    canonical (min, max) pre-dedup delta pairs with PAD_ID in unused slots,
    the exact number of collisions examined (tombstones included), and the
    slots that did not fit.
    """
    keys_s, rows_s = _sort2(keys, rows)
    valid = keys_s != PAD_KEY
    # new-vs-new: the entry at in-run rank r pairs with the r earlier members
    rank, _ = _runs(keys_s)
    contrib = torch.where(valid, rank, 0)
    p, e, t, nn_total = _enumerate_slots(_excl_cumsum(contrib), contrib, nn_cap)
    partner = (e - rank[e].long() + t.long()).clamp(0, keys_s.shape[0] - 1)
    ok = p < nn_total
    nn_a = torch.where(ok, rows_s[e], PAD_ID)
    nn_b = torch.where(ok, rows_s[partner], PAD_ID)
    # new-vs-old: valid slab entries sort before PAD_KEY, so [lo, hi) is
    # exactly the resident bucket of each incoming key
    lo_idx, counts = _range_probe(slab_keys, keys_s, valid)
    q, f, u, no_total = _enumerate_slots(_excl_cumsum(counts), counts, no_cap)
    sidx = (lo_idx[f] + u).clamp(0, slab_keys.shape[0] - 1).long()
    # a tombstone (row PAD_ID under its key) is examined, never emitted
    ok2 = (q < no_total) & (slab_rows[sidx] != PAD_ID)
    no_a = torch.where(ok2, slab_rows[sidx], PAD_ID)
    no_b = torch.where(ok2, rows_s[f], PAD_ID)
    a = torch.cat([nn_a, no_a])
    b = torch.cat([nn_b, no_b])
    examined = _i32(nn_total + no_total)
    overflow = _i32((nn_total - nn_cap).clamp(min=0) + (no_total - no_cap).clamp(min=0))
    return torch.minimum(a, b), torch.maximum(a, b), examined, overflow


def merge_insert(
    slab_keys: torch.Tensor,
    slab_rows: torch.Tensor,
    keys: torch.Tensor,
    rows: torch.Tensor,
):
    """Sorted-merge the incoming (key, row) rows into the resident slab.

    A stable merge by key: old entry ``i`` lands at ``i + |new keys <
    key_i|``, new entry ``j`` (after a sort) at ``j + |old keys <= key_j|``,
    so old entries keep their order and new ones append after equal keys.
    The two position sets are a permutation of the ``cap + r`` merged slots,
    written by index assignment.  PAD_KEY sorts last on both sides, so the
    truncation to ``cap`` drops padding first; dropped VALID entries are
    counted in ``overflow`` (the caller regrows and retries, never commits).

    Returns ``(slab_keys', slab_rows', overflow)`` at the same capacity.
    """
    cap = slab_keys.shape[0]
    keys_s, rows_s = _sort2(keys, rows)
    r = keys_s.shape[0]
    dev = slab_keys.device
    pos_old = torch.arange(cap, device=dev) + torch.searchsorted(keys_s, slab_keys, right=False)
    pos_new = torch.arange(r, device=dev) + torch.searchsorted(slab_keys, keys_s, right=True)
    merged_k = torch.full((cap + r,), PAD_KEY, dtype=torch.int32, device=dev)
    merged_r = torch.full((cap + r,), PAD_ID, dtype=torch.int32, device=dev)
    merged_k[pos_old] = slab_keys
    merged_k[pos_new] = keys_s
    merged_r[pos_old] = slab_rows
    merged_r[pos_new] = rows_s
    entries = (slab_keys != PAD_KEY).sum() + (keys_s != PAD_KEY).sum()
    overflow = _i32((entries - cap).clamp(min=0))
    return merged_k[:cap], merged_r[:cap], overflow


def probe_rows(
    slab_keys: torch.Tensor,
    slab_rows: torch.Tensor,
    keys: torch.Tensor,
    payload: torch.Tensor,
    *,
    cap: int,
):
    """Read-only range probe: resident rows matching each incoming key.

    The query-serving half of :func:`probe_pairs`: no new-vs-new stage, no
    merge, and no min/max (the ``payload`` ids, query indices, live in
    another namespace than the resident row ids).

    Returns ``(rows [cap], out_payload [cap], examined, overflow)``: every
    (resident row, payload) match with PAD_ID in unused slots, the exact
    pre-dedup match count (tombstones examined, never emitted), and the
    slots that did not fit.
    """
    keys_s, pay_s = _sort2(keys, payload)
    valid = keys_s != PAD_KEY
    lo_idx, counts = _range_probe(slab_keys, keys_s, valid)
    q, f, u, total = _enumerate_slots(_excl_cumsum(counts), counts, cap)
    sidx = (lo_idx[f] + u).clamp(0, slab_keys.shape[0] - 1).long()
    ok = (q < total) & (slab_rows[sidx] != PAD_ID)
    rows = torch.where(ok, slab_rows[sidx], PAD_ID)
    out_payload = torch.where(ok, pay_s[f], PAD_ID)
    return rows, out_payload, _i32(total), _i32((total - cap).clamp(min=0))


def mark_dead_rows(slab_rows: torch.Tensor, dead_sorted: torch.Tensor) -> torch.Tensor:
    """Tombstone every slab slot whose row id is in ``dead_sorted``.

    dead_sorted: int32 [R] ascending retired row ids, PAD_ID-padded at the
    end (a PAD_ID slot matching the padding is already dead: idempotent).
    Keys stay, so the sorted-slab invariant and the examined counts survive;
    only the row becomes PAD_ID.
    """
    idx = torch.searchsorted(dead_sorted, slab_rows).clamp(0, dead_sorted.shape[0] - 1)
    hit = dead_sorted[idx] == slab_rows
    return torch.where(hit, PAD_ID, slab_rows)


def compact_slab(
    slab_keys: torch.Tensor,
    slab_rows: torch.Tensor,
    shift,
    *,
    out_cap: int,
):
    """Drop-mode compaction of one shard's slab: reclaim tombstones.

    A stable partition: live slots (row != PAD_ID) keep their order and move
    to the front, tombstones and padding become (PAD_KEY, PAD_ID) at the end
    (the reference's sort on (dead flag, position) is a stable sort on the
    flag).  Surviving row ids are rebased by ``shift`` (an int or a scalar
    int32 tensor).  Live entries beyond ``out_cap`` are counted in
    ``overflow``; the caller re-runs with a bigger ``out_cap``.

    Returns ``(keys' [out_cap], rows' [out_cap], live, overflow)``.
    """
    cap = slab_keys.shape[0]
    dead = (slab_rows == PAD_ID).to(torch.int32)
    order = torch.sort(dead, stable=True).indices
    live = _i32(cap - dead.sum())
    keep = torch.arange(cap, device=slab_keys.device) < live
    shift = torch.as_tensor(shift, dtype=torch.int32, device=slab_keys.device)
    keys_c = torch.where(keep, slab_keys[order], PAD_KEY)
    rows_c = torch.where(keep, slab_rows[order] - shift, PAD_ID)
    if out_cap >= cap:
        pad = out_cap - cap
        keys_o = torch.nn.functional.pad(keys_c, (0, pad), value=PAD_KEY)
        rows_o = torch.nn.functional.pad(rows_c, (0, pad), value=PAD_ID)
    else:
        keys_o, rows_o = keys_c[:out_cap], rows_c[:out_cap]
    return keys_o, rows_o, live, _i32((live - out_cap).clamp(min=0))


def flat_row_keys(keys_np: np.ndarray):
    """Each row's key SET, flattened: ``(keys, row index)`` int32, in row
    order (each row's keys sorted, PAD and repeats dropped), the defensive
    dedup ``BucketIndex.insert`` applies, so examined counts stay exact."""
    ks = np.sort(np.asarray(keys_np), axis=1)
    valid = ks != PAD_KEY
    valid[:, 1:] &= ks[:, 1:] != ks[:, :-1]
    row_idx, col_idx = np.nonzero(valid)
    return ks[row_idx, col_idx].astype(np.int32), row_idx.astype(np.int32)


# ---------------------------------------------------------------------------
# numpy references (the JAX package's oracles)
# ---------------------------------------------------------------------------
def probe_pairs_ref(slab_keys, slab_rows, keys, rows):
    """Bucket-semantics oracle for :func:`probe_pairs`: the pre-dedup
    (lo, hi) multiset and the exact examined count, computed from plain
    per-key dict buckets.  Tombstoned slab slots (row == PAD_ID under a
    live key) are examined like any resident member but never emitted."""
    slab_keys = np.asarray(slab_keys)
    slab_rows = np.asarray(slab_rows)
    buckets: dict[int, list[int]] = {}
    for k, rid in zip(slab_keys.tolist(), slab_rows.tolist()):
        if k != PAD_KEY:
            buckets.setdefault(k, []).append(rid)
    order = np.lexsort((np.asarray(rows), np.asarray(keys)))
    pairs = []
    examined = 0
    seen: dict[int, list[int]] = {}
    for i in order:
        k, rid = int(np.asarray(keys)[i]), int(np.asarray(rows)[i])
        if k == PAD_KEY:
            continue
        for m in buckets.get(k, []) + seen.get(k, []):
            examined += 1
            if m != PAD_ID:
                pairs.append((min(m, rid), max(m, rid)))
        seen.setdefault(k, []).append(rid)
    return pairs, examined


def probe_rows_ref(slab_keys, slab_rows, keys, payload):
    """Bucket-semantics oracle for :func:`probe_rows`: the pre-dedup
    (resident row, payload) match multiset and the exact examined count."""
    slab_keys = np.asarray(slab_keys)
    slab_rows = np.asarray(slab_rows)
    buckets: dict[int, list[int]] = {}
    for k, rid in zip(slab_keys.tolist(), slab_rows.tolist()):
        if k != PAD_KEY:
            buckets.setdefault(k, []).append(rid)
    matches = []
    examined = 0
    for k, p in zip(np.asarray(keys).tolist(), np.asarray(payload).tolist()):
        if k == PAD_KEY:
            continue
        for m in buckets.get(k, []):
            examined += 1
            if m != PAD_ID:
                matches.append((m, p))
    return matches, examined


def merge_insert_ref(slab_keys, slab_rows, keys, rows, cap):
    """Stable-merge oracle for :func:`merge_insert`."""
    entries = [
        (int(k), int(r))
        for k, r in zip(np.asarray(slab_keys), np.asarray(slab_rows))
        if k != PAD_KEY
    ]
    new = sorted(
        (int(k), int(r))
        for k, r in zip(np.asarray(keys), np.asarray(rows))
        if k != PAD_KEY
    )
    merged = sorted(entries + new, key=lambda kr: kr[0])
    overflow = max(len(merged) - cap, 0)
    merged = merged[:cap]
    out_k = np.full((cap,), PAD_KEY, np.int32)
    out_r = np.full((cap,), PAD_ID, np.int32)
    for i, (k, r) in enumerate(merged):
        out_k[i], out_r[i] = k, r
    return out_k, out_r, overflow


def compact_slab_ref(slab_keys, slab_rows, shift, out_cap):
    """Stable-partition oracle for :func:`compact_slab`."""
    live = [
        (int(k), int(r) - int(shift))
        for k, r in zip(np.asarray(slab_keys), np.asarray(slab_rows))
        if r != PAD_ID
    ]
    overflow = max(len(live) - out_cap, 0)
    out_k = np.full((out_cap,), PAD_KEY, np.int32)
    out_r = np.full((out_cap,), PAD_ID, np.int32)
    for i, (k, r) in enumerate(live[:out_cap]):
        out_k[i], out_r[i] = k, r
    return out_k, out_r, len(live), overflow


# ---------------------------------------------------------------------------
# host-side planning statistics (counts only, never ids)
# ---------------------------------------------------------------------------
class StreamJoinStats:
    """Per-key occurrence counts for exact device-join capacity planning.

    The host's only residual join state: ``counts[key]`` — how many rows
    ever produced ``key`` — and the per-owner slab occupancy.  Row ids are
    deliberately NOT kept (the pair set cannot be reconstructed from this
    mirror; the bucket lists that grow unboundedly live on the devices).
    ``plan_update`` computes, per owner shard, the exact pre-dedup
    new-vs-old / new-vs-new emission counts and slab-entry deltas of one
    update; ``commit`` folds the update in once the device run is
    accepted, so overflow retries replan from unchanged statistics.

    Deletion keeps the mirror honest about DEFERRED reclamation: retired
    rows' occurrences stay in ``counts`` (their tombstones still occupy
    slab slots and are still examined by every probe) and are additionally
    tracked in ``dead_counts``/``owner_dead`` until :meth:`compact`
    subtracts them — so capacity plans between compactions cover the
    tombstones, and shrink exactly at the compaction boundary.
    """

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.counts: dict[int, int] = {}
        self.owner_entries = np.zeros((n_shards,), np.int64)
        self.dead_counts: dict[int, int] = {}
        self.owner_dead = np.zeros((n_shards,), np.int64)

    def plan_update(self, keys_flat: np.ndarray, owners_flat: np.ndarray):
        """Exact per-owner loads of inserting ``keys_flat`` (per-row-deduped
        flat key occurrences, in row order) with precomputed owners.

        Returns ``(new_vs_old, new_vs_new, entries_delta)``, each int64
        ``[n_shards]``.
        """
        nvo = np.zeros((self.n_shards,), np.int64)
        nvn = np.zeros((self.n_shards,), np.int64)
        ent = np.zeros((self.n_shards,), np.int64)
        if keys_flat.size == 0:
            return nvo, nvn, ent
        uniq, first = np.unique(keys_flat, return_index=True)
        counts = np.bincount(
            np.searchsorted(uniq, keys_flat), minlength=uniq.shape[0]
        )
        owners = owners_flat[first]
        for k, m, o in zip(uniq.tolist(), counts.tolist(), owners.tolist()):
            old = self.counts.get(k, 0)
            nvo[o] += old * m
            nvn[o] += m * (m - 1) // 2
            ent[o] += m
        return nvo, nvn, ent

    def commit(self, keys_flat: np.ndarray, owners_flat: np.ndarray) -> None:
        if keys_flat.size == 0:
            return
        uniq, first = np.unique(keys_flat, return_index=True)
        counts = np.bincount(
            np.searchsorted(uniq, keys_flat), minlength=uniq.shape[0]
        )
        for k, m in zip(uniq.tolist(), counts.tolist()):
            self.counts[k] = self.counts.get(k, 0) + int(m)
        np.add.at(self.owner_entries, owners_flat, 1)

    def retire(self, keys_flat: np.ndarray, owners_flat: np.ndarray) -> None:
        """Fold one retirement's tombstoned key occurrences into the dead
        ledger.  ``counts``/``owner_entries`` are NOT reduced — the
        tombstones still occupy (and are examined in) their slab slots —
        only :meth:`compact` reclaims them."""
        if keys_flat.size == 0:
            return
        uniq, first = np.unique(keys_flat, return_index=True)
        counts = np.bincount(
            np.searchsorted(uniq, keys_flat), minlength=uniq.shape[0]
        )
        for k, m in zip(uniq.tolist(), counts.tolist()):
            self.dead_counts[k] = self.dead_counts.get(k, 0) + int(m)
        np.add.at(self.owner_dead, owners_flat, 1)

    def compact(self) -> None:
        """Reclaim the dead ledger: subtract tombstoned occurrences from
        the planning counts (dropping emptied keys) and the per-owner
        occupancy — the host mirror of one device slab compaction."""
        for k, m in self.dead_counts.items():
            left = self.counts.get(k, 0) - m
            if left > 0:
                self.counts[k] = left
            else:
                self.counts.pop(k, None)
        self.dead_counts = {}
        self.owner_entries = np.maximum(
            self.owner_entries - self.owner_dead, 0
        )
        self.owner_dead = np.zeros((self.n_shards,), np.int64)

    def dead_fraction(self) -> float:
        """Max per-owner tombstone fraction of the resident slab entries
        (the compaction watermark input)."""
        occ = np.maximum(self.owner_entries, 1)
        return float(np.max(self.owner_dead / occ)) \
            if self.owner_entries.sum() else 0.0

    @property
    def num_keys(self) -> int:
        return len(self.counts)


class ShardSummaries:
    """Per-world-shard length summaries for REPOSE-style serve pruning.

    Maintained on INSERT (O(d) per micro-batch, counts and maxima only —
    never trajectory content): for each round-robin world shard
    (``shard = id % n_shards``) the row count and the maximum trajectory
    length of any resident row.  At query time the free MSS bound
    ``betas_sum * min(len_query, max_len[shard])`` upper-bounds every
    candidate the shard can hold, so a shard whose bound cannot beat the
    query's ``rho`` — or, once k matches exist, its running kth-best —
    is skipped before a single code row is scored (the reference-length
    partition bound of REPOSE, PAPERS.md).
    """

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.rows = np.zeros((n_shards,), np.int64)
        self.max_len = np.zeros((n_shards,), np.int64)

    def insert(self, first_id: int, lengths: np.ndarray) -> None:
        """Fold one micro-batch of rows ``first_id .. first_id + d - 1``."""
        lengths = np.asarray(lengths, np.int64).reshape(-1)
        if lengths.size == 0:
            return
        shard = (first_id + np.arange(lengths.shape[0], dtype=np.int64)) \
            % self.n_shards
        np.add.at(self.rows, shard, 1)
        np.maximum.at(self.max_len, shard, lengths)

    def rebuild(self, first_id: int, lengths: np.ndarray,
                alive: np.ndarray) -> None:
        """Recompute the summaries from the LIVE rows only.

        Maxima cannot be maintained under deletion (removing the longest
        row must LOWER the shard's bound, or ``serve_prune`` keeps
        scanning shards for matches that no longer exist), so eviction
        recomputes from the host length mirror: rows ``first_id ..
        first_id + len - 1`` with ``alive[i]`` true.  O(live) per
        retirement — summaries stay sound and tight."""
        lengths = np.asarray(lengths, np.int64).reshape(-1)
        alive = np.asarray(alive, bool).reshape(-1)
        self.rows = np.zeros((self.n_shards,), np.int64)
        self.max_len = np.zeros((self.n_shards,), np.int64)
        if lengths.size == 0:
            return
        shard = (first_id + np.arange(lengths.shape[0], dtype=np.int64)) \
            % self.n_shards
        np.add.at(self.rows, shard[alive], 1)
        np.maximum.at(self.max_len, shard[alive], lengths[alive])
