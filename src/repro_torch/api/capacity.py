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

    def plan_tuning(self, pairs: int, levels: int, length: int):
        """Tuned LCS kernel parameters for a score stage of this shape.

        The tuning table is not ported: always ``None`` (callers keep their
        defaults)."""
        return None
