"""Candidate-generation backends behind a string-keyed registry.

Phase (ii) of the paper's pipeline — "which trajectory pairs are worth
scoring?" — is the phase the paper varies across its approaches.  Each
variant is a :class:`CandidateBackend` selected by registry name.  The port
registers the paper's own join:

  "ssh"      k-sequential-shingle hashing (the AnotherMe join; lossless)

The JAX package's "minhash", "brp" and "udf" backends are not ported yet,
and asking for them raises like any unknown name, listing what is
registered.

Every backend reduces to PAD_KEY-padded int32 join keys ``[N, S]`` — pairs
sharing any key become candidates via the same sort-merge join.  In the
subtrajectory mode (``BackendContext.window`` set) the key rows are the
trajectories' sliding windows instead (:func:`_windowed_view`), so the join
emits candidate pairs of window ids.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.encoding import type_codes
from repro_torch.core.shingling import shingles_from_types, windowed_types
from repro_torch.core.ssh import exact_pair_count, ssh_candidates
from repro_torch.core.types import CandidatePairs, EncodedBatch, TrajectoryBatch


@dataclasses.dataclass(frozen=True)
class BackendContext:
    """Static pipeline facts a backend may need (from config + forest).

    ``window``/``stride`` carry the subtrajectory mode
    (``EngineConfig(subtraj_window=W, subtraj_stride=s)``): when ``window``
    is set, a backend keys the SLIDING WINDOWS of each trajectory instead of
    the whole row — key row ``t * nw + j`` holds window j of trajectory t
    (see :mod:`repro_torch.core.subtraj`).
    """

    k: int
    num_types: int
    window: int | None = None
    stride: int = 1


def _windowed_view(types, lengths, ctx: BackendContext):
    """The key-input view: windows as virtual rows when the mode is on.

    [N, L] type codes -> [N*nw, W] window rows + [N*nw] window lengths
    (identity when ``ctx.window`` is None), shared by every backend so the
    windowed key layout cannot drift between them.
    """
    if ctx.window is None:
        return types, lengths
    return windowed_types(types, lengths, window=ctx.window, stride=ctx.stride)


class CandidateBackend:
    """Protocol/base for candidate generation.

    Subclasses implement :meth:`join_keys` (the shared join and capacity
    planner then apply) or override :meth:`candidates` directly.
    """

    name: str = "?"

    def join_keys(
        self, encoded: EncodedBatch, batch: TrajectoryBatch, ctx: BackendContext
    ) -> torch.Tensor:
        """PAD_KEY-padded int32 join keys [N, S]."""
        raise NotImplementedError

    def expected_pairs(self, keys: torch.Tensor) -> int:
        """Exact pre-dedup join cardinality, for capacity planning."""
        return exact_pair_count(keys)

    def candidates(
        self,
        encoded: EncodedBatch,
        batch: TrajectoryBatch,
        ctx: BackendContext,
        *,
        pair_capacity: int,
    ) -> CandidatePairs:
        keys = self.join_keys(encoded, batch, ctx)
        return ssh_candidates(keys, pair_capacity=pair_capacity)


@dataclasses.dataclass(frozen=True)
class SSHBackend(CandidateBackend):
    """The paper's Semantic Sequential Hashing join (Algorithm 2)."""

    dedup: bool = True
    name: str = dataclasses.field(default="ssh", init=False)

    def join_keys(self, encoded, batch, ctx):
        types, lengths = _windowed_view(type_codes(encoded), encoded.lengths, ctx)
        return shingles_from_types(
            types, lengths,
            k=ctx.k, num_types=ctx.num_types, dedup=self.dedup,
        )


_REGISTRY: dict[str, Callable[..., CandidateBackend]] = {}


def register_backend(name: str, factory: Callable[..., CandidateBackend]):
    """Register a backend factory under ``name`` (replaces any previous)."""
    _REGISTRY[name] = factory
    return factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **options) -> CandidateBackend:
    """Instantiate a registered backend by name; ``options`` go to its
    factory."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown candidate backend {name!r}; registered backends: "
            f"{list(available_backends())}"
        ) from None
    return factory(**options)


register_backend("ssh", SSHBackend)
