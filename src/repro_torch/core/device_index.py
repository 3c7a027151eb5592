"""Host-side statistics of the streaming world (numpy).

Port of the host pieces of ``repro/core/device_index.py`` that a streaming
engine always builds, at one shard:

  :class:`StreamJoinStats`  per-key occurrence counts for exact capacity
                            planning of the device-resident join;
  :class:`ShardSummaries`   per-world-shard row counts and maximum lengths,
                            the serve-time REPOSE prune bounds.

The device-resident sorted slabs and their kernels (``probe_pairs``,
``merge_insert``, ``probe_rows``, ``mark_dead_rows``, ``compact_slab``) are
not ported yet: ``delta_join="device"`` raises ``NotPortedError``.
"""
from __future__ import annotations

import numpy as np


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
