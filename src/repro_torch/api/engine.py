"""`AnotherMeEngine`: one entry point for the whole pipeline (PyTorch).

    from repro_torch.api import AnotherMeEngine, EngineConfig
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(2_000)          # tensors on the card
    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh", rho=2.0))
    result = engine.run(batch)

The engine composes the typed stages of api/stages.py — Encode, Candidate,
Score, Communities — on one device.  It runs on the card unless the caller
passes ``device="cpu"`` (the CPU tests do); without a card the default
raises.  ``EngineConfig(backend=...)`` picks the candidate join: "ssh" (the
paper's lossless join) or one of the paper's baselines, "minhash" (keys
from the Hopper MinHash kernel on the card), "brp" and "udf"; a legacy
``candidate_fn`` goes in as a :class:`CallableBackend`.
``EngineConfig(subtraj_window=W, subtraj_stride=s)`` runs the subtrajectory
mode: candidates and scores over sliding windows, folded to trajectory
pairs by max-over-windows (see ``core/subtraj.py``), with every key-based
backend.  The JAX engine's sharded execution (``n_shards > 1``,
``overlap_chunks``) and autotuning are not ported yet and raise
:class:`NotPortedError`; ``delta_join`` and ``score_mode`` are read by the
streaming engine only.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.api.backends import BackendContext, CandidateBackend, get_backend
from repro_torch.api.capacity import CapacityPlanner
from repro_torch.api.errors import NotPortedError
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.stages import (
    CandidateStage, CommunitiesStage, EncodeStage, PipelineContext, ScoreStage,
    validate_lcs_impl,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import SemanticForest, forest_tables
from repro_torch.core.pipeline import AnotherMeResult as EngineResult
from repro_torch.core.similarity import default_betas
from repro_torch.core.types import TrajectoryBatch


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Algorithm parameters (paper defaults; section V.1)."""

    k: int = 3                      # shingle order
    rho: float = 2.0                # similarity threshold
    betas: tuple | None = None      # level weights; None -> uniform 1/n
    backend: str = "ssh"            # candidate backend registry name
    backend_options: Mapping | None = None  # kwargs for the backend factory
    lcs_impl: str = "wavefront"     # see api/stages.py for every name
    score_prune: bool = False       # MSS upper-bound pruning before exact
    #                                 scoring (tau = rho); changes the
    #                                 scored buffer but never the similar set
    pair_capacity: int | None = None  # None -> plan from exact join size
    capacity_slack: float = 1.10
    community_mode: str = "cliques"  # "cliques" | "components"
    max_retries: int = 3
    subtraj_window: int | None = None  # subtrajectory mode: score sliding
    #                                    windows of W positions (None: off)
    subtraj_stride: int = 1            # offset between successive windows


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where and how the pipeline executes.

    Only the single-device plan is ported: ``n_shards > 1``,
    ``autotune=True`` and ``overlap_chunks != 1`` raise
    :class:`NotPortedError` in the engine.  ``delta_join`` and
    ``score_mode`` are read by the streaming engine only (the one-shot
    engine ignores them, as the JAX one does); there ``score_mode="shuffle"``
    with ``delta_join="device"`` raises :class:`NotPortedError`.
    """

    n_shards: int = 1
    score_mode: str = "replicate"   # "replicate" | "shuffle" (device join)
    lcs_impl: str | None = None     # override EngineConfig.lcs_impl
    delta_join: str = "host"        # streaming only: "host" (BucketIndex)
    #                                 or "device" (the resident slabs)
    autotune: bool = False
    overlap_chunks: int = 1


class AnotherMeEngine:
    """AnotherMe pipeline over a fixed semantic forest on one device.

    One engine owns the forest tables (on ``device``), the betas, the
    candidate backend and the capacity planner; ``run`` takes batches whose
    tensors lie on the same device.
    """

    def __init__(
        self,
        forest: SemanticForest,
        config: EngineConfig = EngineConfig(),
        plan: ExecutionPlan = ExecutionPlan(),
        *,
        backend: CandidateBackend | None = None,
        device=None,
    ):
        if plan.lcs_impl is not None:
            config = dataclasses.replace(config, lcs_impl=plan.lcs_impl)
        validate_lcs_impl(config.lcs_impl)
        if plan.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {plan.n_shards}")
        if plan.n_shards > 1:
            raise NotPortedError(f"ExecutionPlan(n_shards={plan.n_shards})")
        if plan.autotune:
            raise NotPortedError("ExecutionPlan(autotune=True)")
        if plan.overlap_chunks != 1:
            raise NotPortedError(f"ExecutionPlan(overlap_chunks={plan.overlap_chunks})")
        self.device = resolve_device(device)
        self.forest = forest
        self.config = config
        self.plan = plan
        self.tables = forest_tables(forest, device=self.device)
        self.betas = (
            torch.tensor(config.betas, dtype=torch.float32, device=self.device)
            if config.betas is not None
            else default_betas(forest.num_levels, device=self.device)
        )
        self.backend = backend if backend is not None else get_backend(
            config.backend, **dict(config.backend_options or {})
        )
        if config.subtraj_window is not None:
            if config.subtraj_window < 1:
                raise ValueError(
                    f"subtraj_window must be positive, got {config.subtraj_window}"
                )
            if config.subtraj_stride < 1:
                raise ValueError(
                    f"subtraj_stride must be positive, got {config.subtraj_stride}"
                )
            if not self.backend.supports_sharded:
                raise ValueError(
                    f"candidate backend {self.backend.name!r} produces no "
                    "join keys; the subtrajectory mode needs key-based "
                    "candidates to carry (traj, offset) window coordinates"
                )
        self.backend_ctx = BackendContext(
            k=config.k, num_types=forest.num_types,
            window=config.subtraj_window, stride=config.subtraj_stride,
        )
        self.planner = CapacityPlanner(
            slack=config.capacity_slack, max_retries=config.max_retries,
        )
        self._stages = (
            EncodeStage(), CandidateStage(), ScoreStage(), CommunitiesStage(),
        )

    def run(self, batch: TrajectoryBatch) -> EngineResult:
        """Run the full pipeline on one batch (on the engine's device)."""
        if batch.device != self.device:
            raise ValueError(
                f"batch lies on {batch.device}, the engine on {self.device}; "
                "build the batch with the engine's device"
            )
        ctx = PipelineContext(
            batch=batch, forest=self.forest, tables=self.tables,
            betas=self.betas, config=self.config, backend=self.backend,
            backend_ctx=self.backend_ctx, planner=self.planner,
            instr=Instrumentation(),
        )
        for stage in self._stages:
            stage.run(ctx)
        return EngineResult(
            scored=ctx.scored, similar_pairs=ctx.similar_pairs,
            communities=ctx.communities, stats=ctx.instr.finalize(),
        )
