"""`AnotherMeEngine`: one entry point for the whole pipeline (PyTorch).

    from repro_torch.api import AnotherMeEngine, EngineConfig, ExecutionPlan
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(2_000)          # tensors on the card
    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh", rho=2.0))
    result = engine.run(batch)

    engine = AnotherMeEngine(forest, EngineConfig(backend="minhash"),
                             ExecutionPlan(n_shards=4, devices=("cuda:0",) * 4))
    result = engine.run(batch)                      # four shards on one card

The engine composes the typed stages of api/stages.py — Encode, Candidate,
Score, Communities — and picks the single-device stages or the sharded
program from one :class:`ExecutionPlan`: with ``n_shards > 1`` the Encode,
Candidate and Score stages are replaced by one stage that runs the sharded
pipeline (api/sharded.py) on a mesh of torch devices, one per shard, while
Communities is shared.  It runs on the card unless the caller passes
``device="cpu"`` (the CPU tests do, with ``devices=("cpu",) * n`` for a
sharded plan); without a card the default raises.
``EngineConfig(backend=...)`` picks the candidate join: "ssh" (the paper's
lossless join) or one of the paper's baselines, "minhash" (keys from the
Hopper MinHash kernel on the card), "brp" and "udf"; a legacy
``candidate_fn`` goes in as a :class:`CallableBackend` (one device only).
``EngineConfig(subtraj_window=W, subtraj_stride=s)`` runs the subtrajectory
mode: candidates and scores over sliding windows, folded to trajectory
pairs by max-over-windows (see ``core/subtraj.py``), with every key-based
backend, on one device or sharded.  ``ExecutionPlan(autotune=True)`` looks
the score stage's LCS parameters up in the tuning table of the engine's
device kind (``repro_torch.perf``; filled by ``python -m
repro_torch.perf.tune``); ``delta_join`` is read by the streaming engine
only.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.api.backends import BackendContext, CandidateBackend, get_backend
from repro_torch.api.capacity import CapacityPlanner
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.sharded import gather_similar_pairs, make_sharded_pipeline, pad_to_shards
from repro_torch.api.stages import (
    CandidateStage, CommunitiesStage, EncodeStage, PipelineContext, ScoreStage,
    validate_lcs_impl,
)
from repro_torch.core import compat
from repro_torch.core.device import resolve_device, synchronize, to_numpy
from repro_torch.core.encoding import SemanticForest, encode_types, forest_tables
from repro_torch.core.pipeline import AnotherMeResult as EngineResult
from repro_torch.core.similarity import default_betas
from repro_torch.core.types import PAD_ID, EncodedBatch, ScoredPairs, TrajectoryBatch


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

    n_shards=1 runs the single-device stages; n_shards>1 runs the sharded
    pipeline on a mesh of ``devices`` (default: the first n_shards CUDA
    devices; a device may be listed more than once, so
    ``devices=("cuda:0",) * 4`` runs four shards on one card), padding the
    batch to a multiple of n_shards with empty trajectories.
    ``autotune=True`` consults the tuning table (``repro_torch.perf``) for
    the score stage's LCS parameters; results never change with it.
    ``delta_join`` is read by the streaming engine only.
    """

    n_shards: int = 1
    score_mode: str = "replicate"   # "replicate" | "shuffle"
    axis_name: str = "ex"
    devices: tuple | None = None    # one torch device per shard
    shard_slack: float = 1.3        # slack for the sharded capacity plan
    lcs_impl: str | None = None     # override EngineConfig.lcs_impl
    delta_join: str = "host"        # streaming only: "host" (BucketIndex)
    #                                 or "device" (the resident slabs)
    autotune: bool = False          # consult the repro_torch.perf tuning
    #                                 table for the LCS block cap and dtype
    overlap_chunks: int = 1         # shuffle mode: split the pair buffer
    #                                 into this many chunks (a power of two),
    #                                 chunk i+1's owner hops issued before
    #                                 chunk i scores; ignored in "replicate"

    def __post_init__(self):
        oc = self.overlap_chunks
        if oc < 1 or (oc & (oc - 1)):
            raise ValueError(f"overlap_chunks must be a power of two >= 1, got {oc}")


class AnotherMeEngine:
    """AnotherMe pipeline over a fixed semantic forest.

    One engine owns the forest tables (on ``device``), the betas, the
    candidate backend, the capacity planner and, for sharded plans, the mesh
    and the caches of built runners and capacity plans; ``run`` takes
    batches whose tensors lie on ``device``.  After a sharded run,
    ``last_shard_retries`` holds the number of capacity doublings it took.
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
        if plan.n_shards > 1 and not self.backend.supports_sharded:
            raise ValueError(
                f"candidate backend {self.backend.name!r} produces no join "
                "keys and only supports ExecutionPlan(n_shards=1); use a "
                "registered key-based backend for sharded execution"
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
            autotune=plan.autotune,
        )
        if plan.n_shards == 1:
            self._stages = (
                EncodeStage(), CandidateStage(), ScoreStage(), CommunitiesStage(),
            )
        else:
            # encoding folds into the sharded program: no EncodeStage
            self._stages = (_ShardedEncodeJoinScoreStage(self), CommunitiesStage())
        self._mesh = None
        self.last_shard_retries = 0
        self._runner_cache: dict = {}
        self._plan_cache: dict = {}

    def run(self, batch: TrajectoryBatch) -> EngineResult:
        """Run the full pipeline on one batch (on the engine's device)."""
        if batch.device != self.device:
            raise ValueError(
                f"batch lies on {batch.device}, the engine on {self.device}; "
                "build the batch with the engine's device"
            )
        if self.plan.n_shards > 1:
            batch = self._padded(batch)
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

    # -- sharded-execution plumbing ------------------------------------------

    def _padded(self, batch: TrajectoryBatch) -> TrajectoryBatch:
        if batch.num_trajectories % self.plan.n_shards == 0:
            return batch
        places, lengths = pad_to_shards(
            to_numpy(batch.places), to_numpy(batch.lengths), self.plan.n_shards,
        )
        return TrajectoryBatch(
            places=torch.as_tensor(places, device=self.device),
            lengths=torch.as_tensor(lengths, device=self.device),
            user_id=torch.arange(places.shape[0], dtype=torch.int32, device=self.device),
        )

    def mesh(self) -> compat.ShardMesh:
        """The plan's flat mesh: ``plan.devices``, or the first n_shards
        CUDA devices (fewer cards than shards raise); one shard without
        ``plan.devices`` is the engine's device."""
        if self._mesh is None:
            n = self.plan.n_shards
            devices = self.plan.devices
            if devices is None and n == 1:
                devices = (self.device,)
            if devices is not None and len(devices) < n:
                raise ValueError(
                    f"ExecutionPlan(n_shards={n}) needs {n} devices, have {len(devices)}"
                )
            self._mesh = compat.make_mesh(
                (n,), (self.plan.axis_name,),
                devices=None if devices is None else tuple(devices)[:n],
            )
        return self._mesh

    def _sharded_runner(self, dplan, key_fn, shapes, subtraj=None):
        from repro_torch.core.similarity import wavefront_dtype_from_env

        # tuning resolves here, at runner-build time, into fixed launch
        # arguments; a miss (autotune off, no table, no matching cell) is
        # None = untuned defaults
        tuning = self.planner.plan_tuning(
            dplan.pruned_cap or dplan.scored_cap, self.forest.num_levels, shapes[1][1],
            device=self.device,
        )
        # the runner build resolves REPRO_LCS_DTYPE (lcs_impl_fn), so the
        # cache keys on the resolved dtype and the tuning record, as the JAX
        # engine's does
        cache_key = (
            dplan, self.plan.score_mode, self.config.lcs_impl,
            self.config.score_prune, key_fn is None, shapes,
            wavefront_dtype_from_env(), tuning, subtraj,
        )
        runner = self._runner_cache.get(cache_key)
        if runner is None:
            runner = make_sharded_pipeline(
                self.mesh(), dplan, betas=self.betas, key_fn=key_fn,
                axis_name=self.plan.axis_name, score_mode=self.plan.score_mode,
                lcs_impl=self.config.lcs_impl,
                score_prune=self.config.score_prune,
                prune_tau=self.config.rho,
                tuning=tuning,
                subtraj=subtraj,
            )
            self._runner_cache[cache_key] = runner
        return runner


class _ShardedEncodeJoinScoreStage:
    """Encode + Candidate + Score as one sharded program (Fig. 5).

    Raw places are split among the shards, each shard encodes its own rows,
    and the code table never goes to the host.  Capacity planning works
    from the coarsest-level ("type") view only — one [N, L] gather, the
    Spark driver's statistics pass — from which the backend's join keys are built
    (``plan_sharded``); key-producing backends rebuild their keys per shard,
    key-less ones ("udf") have their host keys shuffled in.  A capacity bust
    retries with every buffer doubled.
    """

    name = "sharded_encode_join_score"

    def __init__(self, engine: AnotherMeEngine):
        self.engine = engine

    def run(self, ctx: PipelineContext) -> None:
        eng = self.engine
        plan, config, instr = eng.plan, eng.config, ctx.instr

        # subtrajectory mode: (window, stride, nw) from the PADDED length
        subtraj = None
        if config.subtraj_window is not None:
            from repro_torch.core.subtraj import num_windows

            L = int(ctx.batch.places.shape[1])
            subtraj = (
                min(config.subtraj_window, L), config.subtraj_stride,
                num_windows(L, config.subtraj_window, config.subtraj_stride),
            )

        with instr.phase("keys"):
            # coarsest-level view for planning only: [N, L], not the
            # [N, n_levels, L] code table
            types = encode_types(ctx.batch.places, ctx.tables)
            plan_encoded = EncodedBatch(codes=types[:, None, :], lengths=ctx.batch.lengths)
            keys = ctx.backend.join_keys(plan_encoded, ctx.batch, ctx.backend_ctx)
            keys_np = to_numpy(keys)
        ctx.keys = keys

        # plan capacities on the host once per distinct key matrix; warm runs
        # (same data) skip the numpy pass and any retry doublings
        with instr.phase("plan"):
            plan_key = (keys_np.shape, hash(keys_np.tobytes()), plan.score_mode, subtraj)
            dplan = eng._plan_cache.get(plan_key)
            if dplan is None:
                prune_kw = {}
                if config.score_prune:
                    # windowed pairs prune on per-WINDOW lengths
                    lengths_np = to_numpy(ctx.batch.lengths)
                    if subtraj is not None:
                        from repro_torch.core.subtraj import window_lengths

                        lengths_np = window_lengths(
                            lengths_np, max_len=int(ctx.batch.places.shape[1]),
                            window=subtraj[0], stride=subtraj[1],
                        )
                    prune_kw = dict(
                        lengths_np=lengths_np, prune_tau=config.rho,
                        betas_sum=float(to_numpy(eng.betas).astype(np.float32).sum()),
                    )
                dplan = eng.planner.plan_sharded(
                    keys_np, plan.n_shards, slack=plan.shard_slack,
                    score_mode=plan.score_mode, overlap_chunks=plan.overlap_chunks,
                    windows_per_row=1 if subtraj is None else subtraj[2],
                    **prune_kw,
                )
        key_fn = ctx.backend.shard_key_fn(ctx.backend_ctx)

        with instr.phase("execute"):
            out, dplan, eng.last_shard_retries = self._execute(ctx, dplan, key_fn, keys, subtraj)
        eng._plan_cache[plan_key] = dplan
        overflow = int(out["overflow"].sum())
        instr.record(shard_plan=dataclasses.asdict(dplan), join_overflow=overflow)
        if config.score_prune:
            instr.record(num_pruned=int(out["pruned"].sum()))

        dev = eng.device
        left = out["left"].reshape(-1).to(dev)
        right = out["right"].reshape(-1).to(dev)
        mss = out["mss"].reshape(-1).to(dev)
        level_lcs = out["level_lcs"].reshape(left.shape[0], -1).to(dev)
        n_valid = int((left != PAD_ID).sum())
        ovf = torch.tensor(overflow, dtype=torch.int32, device=dev)
        if subtraj is not None:
            # fold the scored window pairs to trajectory pairs (max over
            # windows) before anything downstream sees them
            from repro_torch.core.subtraj import aggregate_window_pairs

            with instr.phase("aggregate"):
                tl, tr, tlvl, tmss = aggregate_window_pairs(left, right, level_lcs, mss,
                                                            nw=subtraj[2])
                ctx.similar_pairs = {
                    (int(a), int(b))
                    for a, b, m in zip(tl.tolist(), tr.tolist(), tmss > np.float32(config.rho))
                    if m
                }
            ctx.scored = ScoredPairs(
                left=torch.as_tensor(tl, device=dev), right=torch.as_tensor(tr, device=dev),
                level_lcs=torch.as_tensor(tlvl, device=dev),
                mss=torch.as_tensor(tmss, device=dev),
                count=torch.tensor(tl.shape[0], dtype=torch.int32, device=dev), overflow=ovf,
            )
            instr.record(
                num_candidates=n_valid, num_window_pairs=n_valid,
                num_traj_pairs=int(tl.shape[0]), num_similar=len(ctx.similar_pairs),
                subtraj_windows=subtraj[2],
            )
            return
        ctx.scored = ScoredPairs(
            left=left, right=right, level_lcs=level_lcs, mss=mss,
            count=torch.tensor(n_valid, dtype=torch.int32, device=dev), overflow=ovf,
        )
        ctx.similar_pairs = gather_similar_pairs(out, rho=config.rho)
        instr.record(num_candidates=n_valid, num_similar=len(ctx.similar_pairs))

    def _execute(self, ctx, dplan, key_fn, keys, subtraj=None):
        """Run the sharded program, doubling every capacity while it
        overflows (at most ``max_retries`` times).  Returns (outputs, the
        plan that ran, the number of doublings)."""
        eng = self.engine
        batch = ctx.batch
        first = keys if key_fn is None else batch.places
        shapes = (tuple(first.shape), tuple(batch.places.shape), tuple(ctx.tables.shape))
        for attempt in range(eng.planner.max_retries + 1):
            runner = eng._sharded_runner(dplan, key_fn, shapes, subtraj)
            out = runner(first, batch.places, batch.lengths, ctx.tables)
            synchronize(out["mss"])
            if int(out["overflow"].sum()) == 0:
                break
            if attempt < eng.planner.max_retries:
                dplan = dataclasses.replace(
                    dplan,
                    shingle_route_cap=dplan.shingle_route_cap * 2,
                    local_pair_cap=dplan.local_pair_cap * 2,
                    pair_route_cap=dplan.pair_route_cap * 2,
                    scored_cap=dplan.scored_cap * 2,
                    owner_route_cap=dplan.owner_route_cap * 2,
                    pruned_cap=dplan.pruned_cap * 2,
                    chunk_hop_cap=dplan.chunk_hop_cap * 2,
                    chunk_rest_cap=dplan.chunk_rest_cap * 2,
                )
        return out, dplan, attempt
