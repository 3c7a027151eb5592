"""Public API of the PyTorch engine.

    from repro_torch.api import AnotherMeEngine, EngineConfig

    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh"))
    result = engine.run(batch)        # .similar_pairs / .communities / .stats

    stream = StreamingEngine(forest, EngineConfig(community_mode="components"))
    result = stream.update(micro_batch)   # the current world's result
    top = QueryEngine(stream, k=10).query(query_batch)  # .match_ids / .mss
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
from repro_torch.api.serving import QueryEngine, QueryPlan, QueryResult
from repro_torch.api.stages import (
    LCS_IMPLS, CandidateStage, CommunitiesStage, EncodeStage, PipelineContext,
    ScoreStage, Stage, lcs_impl_fn, validate_lcs_impl,
)
from repro_torch.api.streaming import StreamingEngine
