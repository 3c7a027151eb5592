"""Typed errors of the engine API.

:class:`CapacityExceeded` is the typed refusal of an update or query that
cannot fit its capacity budget (kept for the streaming and serving slices).
:class:`NotPortedError` marks a feature of the JAX package that the PyTorch
port does not run yet: asking for it raises instead of quietly falling back
to something else.
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


class NotPortedError(NotImplementedError):
    """The requested feature exists in the JAX package but not yet here."""

    def __init__(self, feature: str):
        super().__init__(
            f"{feature} is not ported to the PyTorch engine yet; the JAX "
            "package (repro.api) runs it"
        )
        self.feature = feature
