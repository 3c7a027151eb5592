"""Typed errors of the engine API.

:class:`CapacityExceeded` is the typed refusal of an update or query that
cannot fit its capacity budget.
"""
from __future__ import annotations


class CapacityExceeded(RuntimeError):
    """A single update/query exceeded its capacity budget and was refused.

    Attributes:
        needed_bytes:  resident bytes the operation would have required
                       (0 when the refusal is retry-count based).
        budget_bytes:  the configured ``max_resident_bytes`` (0 = retries).
    """

    def __init__(self, message: str, *, needed_bytes: int = 0,
                 budget_bytes: int = 0):
        super().__init__(message)
        self.needed_bytes = int(needed_bytes)
        self.budget_bytes = int(budget_bytes)

