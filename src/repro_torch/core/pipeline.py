"""Legacy AnotherMe entry point — a shim over ``repro_torch.api``.

Port of ``repro/core/pipeline.py``.  ``run_anotherme`` / ``AnotherMeConfig``
predate the composable engine; they delegate to
:class:`repro_torch.api.AnotherMeEngine`, so there is one implementation of
the pipeline.  New code should use the engine directly:

    from repro_torch.api import AnotherMeEngine, EngineConfig
    result = AnotherMeEngine(forest, EngineConfig()).run(batch)

As in the reference, ``lcs_impl="ref"`` runs the reference DP and an
unknown impl name raises a ValueError listing the valid ones; the
``candidate_fn`` branch books the baseline's hash cost under
``t_join``/``t_candidates``, not under ``t_keys``/``t_shingle``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.encoding import SemanticForest
from repro_torch.core.types import ScoredPairs, TrajectoryBatch


@dataclasses.dataclass
class AnotherMeResult:
    """Pipeline output: scored pairs + the paper's two result sets.

    Shared with the engine (``repro_torch.api.EngineResult`` is this class).
    """

    scored: ScoredPairs
    similar_pairs: set
    communities: set
    stats: dict


@dataclasses.dataclass(frozen=True)
class AnotherMeConfig:
    """Legacy config; maps 1:1 onto :class:`repro_torch.api.EngineConfig`."""

    k: int = 3                      # shingle order (paper default 3)
    rho: float = 2.0                # similarity threshold (paper default 2)
    betas: tuple | None = None      # level weights; None -> uniform 1/n
    lcs_impl: str = "wavefront"     # see repro_torch/api/stages.py
    pair_capacity: int | None = None  # None -> plan from exact join size
    capacity_slack: float = 1.10
    community_mode: str = "cliques"  # "cliques" | "components"
    max_retries: int = 3

    def as_engine_config(self, backend: str = "ssh"):
        from repro_torch.api.engine import EngineConfig

        return EngineConfig(
            k=self.k, rho=self.rho, betas=self.betas, backend=backend,
            lcs_impl=self.lcs_impl, pair_capacity=self.pair_capacity,
            capacity_slack=self.capacity_slack,
            community_mode=self.community_mode, max_retries=self.max_retries,
        )


def run_anotherme(
    batch: TrajectoryBatch,
    forest: SemanticForest,
    config: AnotherMeConfig = AnotherMeConfig(),
    *,
    candidate_fn: Callable | None = None,
) -> AnotherMeResult:
    """Run the full pipeline on the batch's device.

    ``candidate_fn(encoded, batch) -> CandidatePairs`` optionally swaps the
    SSH join for a baseline hash while keeping every other phase identical.
    Prefer the registry instead:
    ``AnotherMeEngine(forest, EngineConfig(backend="minhash"))``.
    """
    from repro_torch.api.backends import CallableBackend
    from repro_torch.api.engine import AnotherMeEngine

    backend = CallableBackend(candidate_fn) if candidate_fn is not None else None
    engine = AnotherMeEngine(
        forest, config.as_engine_config(), backend=backend, device=batch.device
    )
    return engine.run(batch)
