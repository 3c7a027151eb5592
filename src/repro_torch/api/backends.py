"""Candidate-generation backends behind a string-keyed registry.

Phase (ii) of the paper's pipeline — "which trajectory pairs are worth
scoring?" — is the phase the paper varies across its approaches.  Each
variant is a :class:`CandidateBackend` selected by registry name:

  "ssh"      k-sequential-shingle hashing (the AnotherMe join; lossless)
  "minhash"  MinHashLSH over the type presence set (Spark's built-in;
             discards order and repetition, so it loses accuracy); the
             signatures come from the Hopper kernel on the card
  "brp"      Bucketed Random Projection of the type count vector
             (discards order entirely: the worst accuracy)
  "udf"      the paper's "user-defined" black box: the same shingle keys
             as "ssh", built row-at-a-time in host Python

Every backend reduces to PAD_KEY-padded int32 join keys ``[N, S]`` — pairs
sharing any key become candidates via the same sort-merge join.  In the
subtrajectory mode (``BackendContext.window`` set) the key rows are the
trajectories' sliding windows instead (:func:`_windowed_view`), so the join
emits candidate pairs of window ids.  A backend that cannot express itself
as keys (a legacy ``candidate_fn``, :class:`CallableBackend`) returns no
keys and produces its candidates itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.brp import brp_bucket_keys
from repro_torch.core.device import to_numpy
from repro_torch.core.encoding import type_codes
from repro_torch.core.minhash import minhash_band_keys
from repro_torch.core.shingling import shingles_from_types, windowed_types
from repro_torch.core.ssh import exact_pair_count, ssh_candidates
from repro_torch.core.types import PAD_KEY, CandidatePairs, EncodedBatch, TrajectoryBatch
from repro_torch.kernels.minhash.ops import minhash_signatures


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

    Subclasses implement :meth:`join_keys` (the shared join, capacity
    planner and sharded execution then apply), or keep the base one, which
    returns None, and override :meth:`candidates` directly.
    :meth:`shard_key_fn` optionally builds the same keys per shard inside
    the sharded program.
    """

    name: str = "?"

    @property
    def supports_sharded(self) -> bool:
        """Whether the backend produces join keys: key-producing backends
        run sharded (their ``shard_key_fn`` per shard, or their host keys
        shuffled in) and in the subtrajectory mode; the engine refuses
        key-less ones in both."""
        return type(self).join_keys is not CandidateBackend.join_keys

    def join_keys(
        self, encoded: EncodedBatch, batch: TrajectoryBatch, ctx: BackendContext
    ) -> torch.Tensor | None:
        """PAD_KEY-padded int32 join keys [N, S], or None for a key-less
        backend."""
        return None

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

    def shard_key_fn(self, ctx: BackendContext) -> Callable | None:
        """``(local_type_codes [n, L], local_lengths [n]) -> keys [n, S]``,
        run per shard inside the sharded program on the shard's own
        encodings; None makes the engine build the keys on the host and
        shuffle them in."""
        return None


@dataclasses.dataclass(frozen=True)
class SSHBackend(CandidateBackend):
    """The paper's Semantic Sequential Hashing join (Algorithm 2)."""

    dedup: bool = True
    name: str = dataclasses.field(default="ssh", init=False)

    def join_keys(self, encoded, batch, ctx):
        return self.shard_key_fn(ctx)(type_codes(encoded), encoded.lengths)

    def shard_key_fn(self, ctx):
        def key_fn(local_types, local_lengths):
            types, lengths = _windowed_view(local_types, local_lengths, ctx)
            return shingles_from_types(
                types, lengths,
                k=ctx.k, num_types=ctx.num_types, dedup=self.dedup,
            )

        return key_fn


@dataclasses.dataclass(frozen=True)
class MinHashBackend(CandidateBackend):
    """MinHashLSH over type presence sets (Spark's built-in; section V.1).

    The signatures go through ``kernels/minhash/ops.minhash_signatures``,
    the port's one signature entry point: the Hopper kernel on the card, its
    plain version on the CPU, both the function the JAX backend keys with.
    """

    num_perm: int = 16
    bands: int = 4
    seed: int = 0
    name: str = dataclasses.field(default="minhash", init=False)

    def join_keys(self, encoded, batch, ctx):
        return self.shard_key_fn(ctx)(type_codes(encoded), encoded.lengths)

    def shard_key_fn(self, ctx):
        def key_fn(local_types, local_lengths):
            types, lengths = _windowed_view(local_types, local_lengths, ctx)
            sig = minhash_signatures(types, lengths, num_perm=self.num_perm, seed=self.seed)
            return minhash_band_keys(sig, bands=self.bands)

        return key_fn


@dataclasses.dataclass(frozen=True)
class BRPBackend(CandidateBackend):
    """Bucketed Random Projection of type count vectors (section V.1)."""

    num_proj: int = 4
    bucket_length: float = 2.0
    seed: int = 0
    name: str = dataclasses.field(default="brp", init=False)

    def join_keys(self, encoded, batch, ctx):
        return self.shard_key_fn(ctx)(type_codes(encoded), encoded.lengths)

    def shard_key_fn(self, ctx):
        def key_fn(local_types, local_lengths):
            types, lengths = _windowed_view(local_types, local_lengths, ctx)
            return brp_bucket_keys(
                types, lengths,
                num_types=ctx.num_types, num_proj=self.num_proj,
                bucket_length=self.bucket_length, seed=self.seed,
            )

        return key_fn


@dataclasses.dataclass(frozen=True)
class UDFBackend(CandidateBackend):
    """The "user-defined" black box: shingle keys built row-at-a-time in
    host Python (the same base-Q pack as "ssh", so the results are
    identical), invisible to every kernel; the keys then go to the engine's
    device for the shared join.  ``shard_key_fn`` is None: a sharded run
    computes these keys on the host and shuffles them in, the Spark-driver
    wall the paper measures in Fig. 7 (encoding still runs per shard)."""

    name: str = dataclasses.field(default="udf", init=False)

    def join_keys(self, encoded, batch, ctx):
        q, k = ctx.num_types, ctx.k
        if q**k >= 2**31:
            raise ValueError(
                f"Q**k = {q}**{k} overflows int32; use a smaller k or Q."
            )
        # the black box stays a row-at-a-time loop over host rows; in the
        # subtrajectory mode only its input view changes
        types, lengths = _windowed_view(type_codes(encoded), encoded.lengths, ctx)
        types, lengths = to_numpy(types), to_numpy(lengths)
        per_row: list[set[int]] = []
        for i in range(types.shape[0]):
            row = types[i, : lengths[i]].tolist()
            keys = set()
            for combo in itertools.combinations(row, k):
                key = 0
                for c in combo:
                    key = key * q + int(c)
                keys.add(key)
            per_row.append(keys)
        s = max(1, max((len(r) for r in per_row), default=1))
        out = np.full((types.shape[0], s), PAD_KEY, np.int32)
        for i, keys in enumerate(per_row):
            out[i, : len(keys)] = sorted(keys)
        return torch.as_tensor(out, device=encoded.codes.device)


class CallableBackend(CandidateBackend):
    """Adapter for legacy ``candidate_fn(encoded, batch) -> CandidatePairs``
    callables (the escape hatch of ``run_anotherme``); key-less, so the
    subtrajectory mode refuses it."""

    name = "callable"

    def __init__(self, fn: Callable):
        self._fn = fn

    def candidates(self, encoded, batch, ctx, *, pair_capacity):
        return self._fn(encoded, batch)


_REGISTRY: dict[str, Callable[..., CandidateBackend]] = {}


def register_backend(name: str, factory: Callable[..., CandidateBackend]):
    """Register a backend factory under ``name`` (replaces any previous)."""
    _REGISTRY[name] = factory
    return factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, **options) -> CandidateBackend:
    """Instantiate a registered backend by name; ``options`` go to its
    factory (e.g. ``get_backend("minhash", num_perm=32, bands=8)``)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown candidate backend {name!r}; registered backends: "
            f"{list(available_backends())}"
        ) from None
    return factory(**options)


register_backend("ssh", SSHBackend)
register_backend("minhash", MinHashBackend)
register_backend("brp", BRPBackend)
register_backend("udf", UDFBackend)
