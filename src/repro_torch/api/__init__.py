"""Public API of the PyTorch engine.

    from repro_torch.api import AnotherMeEngine, EngineConfig

    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh"))
    result = engine.run(batch)        # .similar_pairs / .communities / .stats
"""
from repro_torch.api.backends import (
    BackendContext, BRPBackend, CallableBackend, CandidateBackend,
    MinHashBackend, SSHBackend, UDFBackend, available_backends, get_backend,
    register_backend,
)
from repro_torch.api.capacity import CapacityPlanner
from repro_torch.api.engine import AnotherMeEngine, EngineConfig, EngineResult, ExecutionPlan
from repro_torch.api.errors import CapacityExceeded, NotPortedError
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.stages import (
    LCS_IMPLS, CandidateStage, CommunitiesStage, EncodeStage, PipelineContext,
    ScoreStage, Stage, lcs_impl_fn, validate_lcs_impl,
)
