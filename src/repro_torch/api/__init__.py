"""Public API of the PyTorch engine.

    from repro_torch.api import AnotherMeEngine, EngineConfig

    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh"))
    result = engine.run(batch)        # .similar_pairs / .communities / .stats

    engine = AnotherMeEngine(forest, EngineConfig(),
                             ExecutionPlan(n_shards=4, devices=("cuda:0",) * 4))
    result = engine.run(batch)        # the sharded pipeline, same result

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
from repro_torch.api.errors import CapacityExceeded
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.serving import QueryEngine, QueryPlan, QueryResult
from repro_torch.api.sharded import (
    DistributedPlan, StreamJoinPlan, StreamShardPlan, gather_similar_pairs,
    make_distributed_anotherme, make_sharded_pipeline,
    make_streaming_join_pipeline, make_streaming_score_pipeline,
    pad_to_shards, plan_capacities, plan_stream_capacities, plan_stream_join,
    sticky_join_plan,
)
from repro_torch.api.stages import (
    LCS_IMPLS, CandidateStage, CommunitiesStage, EncodeStage, PipelineContext,
    ScoreStage, Stage, lcs_impl_fn, validate_lcs_impl,
)
from repro_torch.api.streaming import StreamingEngine
