"""Shared capacity planning for fixed-shape candidate buffers.

Every candidate join writes into a fixed ``pair_capacity`` buffer.  The
policy — size from the exact join cardinality with slack, round to a power
of two, retry with doubled capacity on overflow — is one object shared by
every backend.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.api.errors import NotPortedError
from repro_torch.core.types import CandidatePairs


@dataclasses.dataclass(frozen=True)
class CapacityPlanner:
    """Capacity sizing + overflow-retry policy for candidate buffers.

    slack:       multiplicative headroom over the expected pair count.
    floor_pow2:  minimum capacity is ``2**floor_pow2``.
    max_retries: doubling retries after an overflow before giving up.
    autotune:    the JAX package's tuning-table lookup; not ported, so
                 ``True`` raises :class:`NotPortedError`.
    """

    slack: float = 1.10
    floor_pow2: int = 10
    max_retries: int = 3
    autotune: bool = False

    def __post_init__(self):
        if self.autotune:
            raise NotPortedError("autotune=True (the LCS tuning table)")

    def initial_capacity(self, expected_pairs: int) -> int:
        """Power-of-two capacity covering ``expected_pairs`` with slack."""
        want = max(int(expected_pairs * self.slack), 1)
        return 1 << max(self.floor_pow2, int(np.ceil(np.log2(want))))

    def update_capacity(self, count: int, *, floor_pow2: int = 4) -> int:
        """Power-of-two capacity for one streaming micro-batch's buffers:
        like :meth:`initial_capacity` but with a small floor."""
        want = max(int(max(count, 1) * self.slack), 1)
        return 1 << max(floor_pow2, int(np.ceil(np.log2(want))))

    def grow_capacity(self, current: int, needed: int) -> int:
        """Amortized-doubling growth plan for an append-only world buffer:
        ``current`` while it covers ``needed``, else the smallest doubling
        of ``current`` that does."""
        cap = max(current, 1)
        while cap < needed:
            cap *= 2
        return cap

    def run_with_retry(
        self, build: Callable[[int], CandidatePairs], capacity: int
    ) -> tuple[CandidatePairs, int]:
        """Call ``build(capacity)``, doubling capacity while it overflows.

        Returns (candidates, final_capacity).  A persistent overflow after
        ``max_retries`` doublings is returned as-is — the overflow counter
        stays nonzero so the caller can surface it, never silently drop it.
        """
        cand = build(capacity)
        for _ in range(self.max_retries):
            if int(cand.overflow) == 0:
                break
            capacity *= 2
            cand = build(capacity)
        return cand, capacity

    def plan_sharded(
        self,
        keys_np,
        n_shards: int,
        *,
        slack: float | None = None,
        score_mode: str = "replicate",
        lengths_np=None,
        prune_tau: float | None = None,
        betas_sum: float = 1.0,
        overlap_chunks: int = 1,
        windows_per_row: int = 1,
    ):
        """Exact per-bucket capacity plan for the sharded path.

        Delegates to :func:`repro_torch.api.sharded.plan_capacities`, which
        sizes every stage — shuffle 1, the local join, the pair-dedup
        shuffle and (``score_mode="shuffle"``) the per-owner code-gather
        hops — from the actual per-destination loads under the device's own
        hashes.  ``slack`` defaults to this planner's slack.  With
        ``prune_tau``/``lengths_np`` the plan also sizes the post-prune
        buffer; ``windows_per_row > 1`` declares subtrajectory keys (one
        key row per window, ``lengths_np`` per window).
        """
        from repro_torch.api.sharded import plan_capacities

        return plan_capacities(
            keys_np, n_shards,
            slack=self.slack if slack is None else slack,
            score_mode=score_mode,
            lengths_np=lengths_np, prune_tau=prune_tau, betas_sum=betas_sum,
            overlap_chunks=overlap_chunks, windows_per_row=windows_per_row,
        )

    def plan_stream_join(self, keys_flat, n_shards: int, stats, *, floor_pow2: int = 4):
        """Exact per-owner capacity plan for the streaming delta join
        (``delta_join="device"``).

        Delegates to :func:`repro_torch.api.sharded.plan_stream_join`: the
        slab, key-route and probe buffers are sized from the exact loads the
        ``StreamJoinStats`` count mirror derives under the device's key
        hash, the two pair-stage buffers from the pre-dedup emission totals.
        Capacities quantize to powers of two; the streaming engine keeps
        them sticky across updates.
        """
        from repro_torch.api.sharded import plan_stream_join

        return plan_stream_join(keys_flat, n_shards, stats, floor_pow2=floor_pow2)

    def plan_query(
        self,
        num_queries: int,
        k_max: int,
        *,
        n_shards: int,
        cap_local: int,
        world_L: int,
        q_len_max: int,
        cand_total=None,
        keys_flat=None,
        stats=None,
        floor_pow2: int = 2,
    ):
        """Exact capacity plan for one query-serving micro-batch.

        Delegates to :func:`repro_torch.api.serving.plan_query_capacities`:
        the query, top-k and candidate buffers are sized from the exact
        candidate count of the host ``BucketIndex`` probe (``cand_total``),
        or from ``keys_flat``/``stats`` (a ``StreamJoinStats`` mirror), and
        quantize to powers of two; :class:`QueryEngine` keeps them sticky
        across micro-batches.
        """
        from repro_torch.api.serving import plan_query_capacities

        return plan_query_capacities(
            num_queries, k_max, n_shards=n_shards, cap_local=cap_local,
            world_L=world_L, q_len_max=q_len_max, cand_total=cand_total,
            keys_flat=keys_flat, stats=stats, floor_pow2=floor_pow2,
        )

    def plan_tuning(self, pairs: int, levels: int, length: int):
        """Tuned LCS kernel parameters for a score stage of this shape.

        The tuning table is not ported: always ``None`` (callers keep their
        defaults)."""
        return None
