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
sharing any key become candidates via the same sort-merge join.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.encoding import type_codes
from repro_torch.core.shingling import shingles_from_types
from repro_torch.core.ssh import exact_pair_count, ssh_candidates
from repro_torch.core.types import CandidatePairs, EncodedBatch, TrajectoryBatch


@dataclasses.dataclass(frozen=True)
class BackendContext:
    """Static pipeline facts a backend may need (from config + forest)."""

    k: int
    num_types: int


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
        return shingles_from_types(
            type_codes(encoded), encoded.lengths,
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
