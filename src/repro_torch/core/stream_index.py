"""Incremental bucket tables for streaming candidate generation (host numpy).

Port of ``repro/core/stream_index.py``: the bucket state stays on the host
in numpy and Python, as in the JAX package, and the emitted pairs keep its
order exactly (the ``np.unique`` of the ``(lo << 32) | hi`` packing), so a
streaming engine's accumulated scored buffer matches slot by slot.

The one-shot join (core/ssh.py) re-sorts the whole world's (key, id) rows on
every run; streaming ingestion instead maintains the join state — one bucket
per distinct key holding the ids of every row that produced it — and probes
only the NEW rows' keys per micro-batch.  The delta pair set it emits is
exactly the set of candidate pairs whose later member arrived in this
update, so the union over updates equals the one-shot join over the
concatenated batch (each pair is generated in exactly one update: the one
in which ``max(i, j)`` arrives).

Every registered backend reduces to PAD_KEY-padded int32 keys ``[N, S]``
(shingles for "ssh"/"udf", band signatures for "minhash", bucket
projections for "brp"), and a row's keys are a pure function of that row
alone — so one index implementation serves all backends, and inserting a
row once keeps its buckets valid forever.

Work accounting: ``insert`` reports the number of (existing member, new
row) collisions it examined — the pre-dedup delta join size.  This is the
quantity the streaming acceptance bound pins: for any update after the
first, pairs examined < the full-world pre-dedup join size that a one-shot
re-run would enumerate.
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.types import PAD_KEY

# Bucket lists grow UNBOUNDEDLY for hot keys: a key shared by n rows holds
# an n-entry list and its (n+1)-th arrival examines n collisions, so a
# pathological single-key world costs O(n) host memory and O(n^2) total
# probe work.  The index stays exact regardless (the warning never changes
# results) — crossing this many members per bucket just surfaces a
# RuntimeWarning, once per key, pointing at the quadratic wall and at
# ``delta_join="device"``, where the bucket state lives in device slabs
# (``core/device_index.py``), sharded with the world.
HOT_BUCKET_WARN = 10_000


class BucketIndex:
    """key -> [row ids] bucket table, grown one micro-batch at a time.

    hot_bucket_warn: per-bucket member count past which a RuntimeWarning
    fires (once per key); None disables the check.  Results are exact
    either way — the cap warns, it never truncates.
    """

    def __init__(self, hot_bucket_warn: int | None = HOT_BUCKET_WARN) -> None:
        self._buckets: dict[int, list[int]] = {}
        self.hot_bucket_warn = hot_bucket_warn
        self._warned_keys: set[int] = set()
        self.num_rows = 0
        self.num_keys_inserted = 0
        # LIFETIME pre-dedup collision count (monotone; what `insert`
        # examined, never decremented — the work-accounting series)
        self.pairs_examined_total = 0
        # LIVE sum_buckets C(|bucket|, 2), maintained incrementally by
        # insert/retire — the join size a one-shot run over the CURRENT
        # world would enumerate.  Before `retire` existed these two
        # coincided; under TTL/eviction only this one stays exact.
        self.live_join_size = 0

    @property
    def num_buckets(self) -> int:
        return len(self._buckets)

    def insert(
        self, keys_np: np.ndarray, first_id: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Insert new rows' keys; return their deduped delta pairs.

        keys_np:  int32 [d, S], PAD_KEY-padded — the join keys of the d new
                  rows, exactly as the backend's ``join_keys`` builds them
                  (S may differ between updates; only non-PAD entries
                  matter).
        first_id: global id of the first new row (defaults to the current
                  world size; rows get ids first_id .. first_id + d - 1).

        Returns ``(lo, hi, examined)``: canonical (lo < hi) deduplicated
        int32 delta pairs — every pair of rows sharing at least one key
        whose LATER member is one of the d new rows — plus the number of
        pre-dedup collisions examined.  Rows are inserted in id order, so
        new-vs-new pairs within the batch are found when the second member
        probes its buckets.
        """
        keys_np = np.asarray(keys_np)
        d = keys_np.shape[0]
        if first_id is None:
            first_id = self.num_rows
        if first_id != self.num_rows:
            raise ValueError(
                f"rows must arrive in order: next id is {self.num_rows}, "
                f"got first_id={first_id}"
            )
        buckets = self._buckets
        lo_out: list[int] = []
        hi_out: list[int] = []
        examined = 0
        for r in range(d):
            rid = first_id + r
            row = keys_np[r]
            # per-row key SET: every backend's keys are distinct per row
            # already (ssh dedups shingles, bands are salted, brp emits one
            # key), but dedup defensively so the examined count stays the
            # exact per-bucket C(n, 2) partition
            row = np.unique(row[row != PAD_KEY])
            for key in row.tolist():
                members = buckets.get(key)
                if members is None:
                    buckets[key] = [rid]
                    continue
                for m in members:
                    if m != rid:  # a repeated in-row key would self-pair
                        examined += 1
                        lo_out.append(m)
                        hi_out.append(rid)
                if members[-1] != rid:  # keep each id once per bucket
                    # the bucket grows |m| -> |m|+1: C(|m|+1, 2) - C(|m|, 2)
                    # new live pairs, i.e. one per existing member
                    self.live_join_size += len(members)
                    members.append(rid)
                    if (self.hot_bucket_warn is not None
                            and len(members) == self.hot_bucket_warn
                            and key not in self._warned_keys):
                        self._warned_keys.add(key)
                        warnings.warn(
                            f"BucketIndex bucket for key {key} reached "
                            f"{len(members)} members; its list grows "
                            "unboundedly on the host and each further "
                            "arrival examines O(members) collisions. "
                            "Results stay exact, but consider "
                            'delta_join="device" (the JAX package; not '
                            "ported yet) to shard the bucket state off "
                            "the host.",
                            RuntimeWarning, stacklevel=2,
                        )
            self.num_keys_inserted += row.shape[0]
        self.num_rows = first_id + d
        self.pairs_examined_total += examined
        if not lo_out:
            empty = np.empty(0, np.int32)
            return empty, empty.copy(), examined
        lo = np.asarray(lo_out, np.int64)
        hi = np.asarray(hi_out, np.int64)
        # canonicalize + dedup (a pair sharing several keys appears once),
        # matching dedup_pairs' exactly-once contract
        packed = np.unique(
            (np.minimum(lo, hi) << 32) | np.maximum(lo, hi)
        )
        return (
            (packed >> 32).astype(np.int32),
            (packed & 0xFFFFFFFF).astype(np.int32),
            examined,
        )

    def retire(self, ids, keys_np: np.ndarray) -> None:
        """Evict rows from their buckets — exact removal, host-side.

        ids:     int [d] global row ids being retired (any order; ids
                 absent from their buckets are ignored, so the call is
                 idempotent and safe after a prior eviction).
        keys_np: int32 [d, S] PAD_KEY-padded join keys of those rows,
                 recomputed by the caller from its host mirror (keys are a
                 pure per-row function, so they are always recoverable).

        Unlike the device slab — which defers reclamation behind
        tombstones until a watermark compaction — the host oracle evicts
        EAGERLY: each bucket list shrinks the moment a member retires, so
        a pathological hot bucket under TTL/eviction is bounded by its
        LIVE membership (host lists no longer grow without bound past
        ``hot_bucket_warn``), and every subsequent ``insert`` probes
        exactly the live world.  O(bucket length) per (key, id).
        """
        keys_np = np.asarray(keys_np)
        removed = 0
        for r, rid in enumerate(np.asarray(ids).tolist()):
            row = np.unique(keys_np[r][keys_np[r] != PAD_KEY])
            for key in row.tolist():
                members = self._buckets.get(key)
                if members is None:
                    continue
                try:
                    members.remove(rid)
                    removed += 1
                    # the bucket shrinks |m| -> |m|-1: the evicted member
                    # contributed one live pair per REMAINING member
                    self.live_join_size -= len(members)
                except ValueError:
                    continue
                if not members:
                    del self._buckets[key]
                    self._warned_keys.discard(key)
        self.num_keys_inserted -= removed

    def max_bucket_len(self) -> int:
        """Largest live bucket (the hot-bucket boundedness probe)."""
        return max((len(m) for m in self._buckets.values()), default=0)

    def probe(
        self, keys_np: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Read-only probe: resident rows sharing >= 1 key per query row.

        The serving half of :meth:`insert` — the same bucket lookups, but
        the probing rows are NEVER inserted (queries are not part of the
        world, so the index is left untouched and concurrent queries
        commute with updates).  This is the host implementation of the
        read-only ``probe(keys)`` protocol that
        ``core/device_index.py::probe_rows`` implements for the
        device-resident slab index.

        keys_np: int32 [Q, S] PAD_KEY-padded join keys of the Q query
        rows, exactly as the backend's ``join_keys`` builds them.

        Returns ``(qidx, rows, examined)``: deduplicated int32 (query
        index, resident row id) candidate pairs (a pair sharing several
        keys appears once) plus the exact pre-dedup collision count.
        """
        keys_np = np.asarray(keys_np)
        buckets = self._buckets
        q_out: list[int] = []
        r_out: list[int] = []
        examined = 0
        for q in range(keys_np.shape[0]):
            row = keys_np[q]
            row = np.unique(row[row != PAD_KEY])
            seen: set[int] = set()
            for key in row.tolist():
                for m in buckets.get(key, ()):
                    examined += 1
                    if m not in seen:
                        seen.add(m)
                        q_out.append(q)
                        r_out.append(m)
        return (
            np.asarray(q_out, np.int32),
            np.asarray(r_out, np.int32),
            examined,
        )

    def full_join_size(self) -> int:
        """The pre-dedup pair count a one-shot join over the CURRENT world
        would enumerate: ``sum_buckets C(|bucket|, 2)``.  O(1): insert
        adds each new collision to the live counter when the later member
        arrives, and ``retire`` subtracts each evicted member's remaining
        per-bucket contributions — so the counter tracks the live sum
        exactly under TTL/windowed eviction (the partition property the
        equivalence suite pins against an independent per-key oracle).
        ``pairs_examined_total`` stays the LIFETIME examined count; before
        the first retire the two coincide."""
        return self.live_join_size
