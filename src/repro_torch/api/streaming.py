"""`StreamingEngine`: micro-batch ingestion with incremental maintenance.

    from repro_torch.api import StreamingEngine, EngineConfig, ExecutionPlan

    stream = StreamingEngine(forest, EngineConfig(backend="ssh", rho=2.0))
    for micro_batch in feed:
        result = stream.update(micro_batch)   # EngineResult, same type as
                                              # AnotherMeEngine.run

Port of ``repro/api/streaming.py``, on one device or on a mesh of shards
(``ExecutionPlan(n_shards=n, devices=...)``: one process drives the shards,
``devices=("cuda:0",) * 4`` puts four on one card, ``("cpu",) * 4`` on the
CPU).  Per-update cost follows the DELTA, not the world:

* the world lives on the engine's device (the card unless ``device="cpu"``)
  and grows by amortized doubling (:meth:`CapacityPlanner.grow_capacity`;
  on a mesh a multiple of n); an update writes only its new rows, and a
  growth of the world width ``L`` rebuilds it from the host mirror;
* with the host delta join (``ExecutionPlan(delta_join="host")``, the
  default) a host :class:`~repro_torch.core.stream_index.BucketIndex`
  inserts the new rows' keys and emits exactly the pairs whose later member
  arrived in this update.  On one shard the world is the ``[cap, H, L]``
  code table and the pairs are scored through the one-shot engine's
  ``lcs_impl`` dispatch (the fused kernel #1 under ``"fused"``, the batched
  LCS kernel #2 under ``"kernel"``); on n shards the world is the
  round-robin places slab (row g on shard ``g % n``) and the pairs go in
  contiguous per-shard chunks to
  :func:`~repro_torch.api.sharded.make_streaming_score_pipeline`, in either
  ``score_mode`` (``"shuffle"`` with ``overlap_chunks``), at a sticky plan
  whose owner hops double on an overflow;
* with ``ExecutionPlan(delta_join="device")`` the bucket state leaves the
  host: it is key-sharded sorted slabs on the device
  (``core/device_index.py``), the world is the places slab, and each update
  ships only the new rows' key occurrences into the join program
  (:func:`~repro_torch.api.sharded.make_streaming_join_pipeline`), whose
  deduped delta pairs feed the score program on the device, pruned there
  under ``score_prune``: the pair list never reaches the host
  (``driver_pair_rows == 0``).  The host keeps a count mirror
  (``StreamJoinStats``) that sizes every buffer exactly; a run that
  overflowed anyway is never committed (compact-then-retry, doubling, and
  :class:`CapacityExceeded` last);
* the device programs speak LOCAL ids (slot = id - base), and the base
  stays a multiple of n, so a row's owner never moves;
* communities are maintained incrementally: a host union-find, or
  ``connected_components`` on the device warm-started from the previous
  labels through star edges ``(label[v], v)``, or Bron-Kerbosch over the
  accumulated edges in ``"cliques"`` mode;
* rows leave by TTL, ``window`` or :meth:`StreamingEngine.retire`; their
  pairs, edges and communities go at once (on the device join their slab
  slots become tombstones), and a watermark compaction rolls the world to
  the live window and drops the tombstones.

The final update's result equals a one-shot ``AnotherMeEngine.run`` over
the surviving rows, for any split into micro-batches and at any shard
count, and every buffer equals the JAX engine's slot by slot, on both joins
and in both score modes; the two joins give the same result.
``subtraj_window`` raises ``NotImplementedError``, as in the JAX package.
``REPRO_FAULT_INJECT=1`` derates the device join's fresh capacity plans so
its overflow recovery runs; results stay the same.  The host join has no capacity that can
overflow, so, as in the JAX package, it changes nothing there.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.api.engine import AnotherMeEngine, EngineConfig, ExecutionPlan
from repro_torch.api.errors import CapacityExceeded
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.sharded import (
    StreamShardPlan, _positive_hash_np, _pow2, make_streaming_join_pipeline,
    make_streaming_score_pipeline, plan_stream_capacities, shard_chunks, sticky_join_plan,
)
from repro_torch.api.stages import _KERNEL_MODES, _score_with_kernel
from repro_torch.core import communities as comm
from repro_torch.core.device import synchronize, to_numpy
from repro_torch.core.device_index import (
    ShardSummaries, StreamJoinStats, compact_slab, flat_row_keys, mark_dead_rows,
)
from repro_torch.core.encoding import encode_codes, encode_types
from repro_torch.core.pipeline import AnotherMeResult as EngineResult
from repro_torch.core.similarity import (
    PRUNE_EPS, mss_upper_bound, score_pairs, wavefront_dtype_from_env,
)
from repro_torch.core.stream_index import BucketIndex
from repro_torch.core.types import (
    PAD_ID, PAD_KEY, PAD_PLACE, CandidatePairs, EncodedBatch, ScoredPairs,
    TrajectoryBatch,
)

COMPONENTS_IMPLS = ("unionfind", "jit")
DELTA_JOINS = ("host", "device")

# a row with no TTL never expires on its own
NEVER_EXPIRES = np.iinfo(np.int64).max


def _fault_inject() -> bool:
    """REPRO_FAULT_INJECT=1 derates every fresh device-join plan to tiny
    caps, so the overflow -> compact -> retry path runs (results stay the
    same: overflowed runs are never committed).  Read per call."""
    return bool(int(os.environ.get("REPRO_FAULT_INJECT", "0") or "0"))


def _derate_cap(cap: int) -> int:
    """Fault-injection derating: a power of two >= 4, small enough to
    overflow, so the retry doubling converges within the extra retries."""
    return max(4, _pow2(max(cap // 8, 1)))


class StreamingEngine:
    """Incremental AnotherMe over a fixed semantic forest, on one device or
    a mesh of shards (``ExecutionPlan(n_shards=n, devices=...)``).

    One instance owns the growing world; :meth:`update` ingests one
    micro-batch and returns the CURRENT world's :class:`EngineResult` (the
    accumulated scored pairs, the similar set and the communities), so the
    final update's result compares directly with a one-shot
    ``AnotherMeEngine.run`` over the surviving rows.

    components_impl: the community path in ``"components"`` mode:
        ``"unionfind"`` (host) or ``"jit"`` (``connected_components`` on the
        device, resumed from the previous labels; the name is the JAX
        package's).  ``"cliques"`` mode re-runs Bron-Kerbosch over the
        accumulated edges.
    world_capacity: preallocation hint (rows), so the world never regrows
        below it.
    join_slab_capacity: preallocation hint of the device join's slab
        (resident key occurrences), so it never regrows below it.
    window: every row expires after at most ``window`` updates.
    max_resident_bytes: an update whose buffer growth would exceed this is
        refused with :class:`CapacityExceeded` before any mutation.
    compact_watermark: dead fraction at which the world is compacted.
    device: where the world lives (None: the card; raises without one); on
        a mesh, the first shard's device.

    Build counters: the JAX engine counts the XLA traces of its device
    join's programs in ``join_traces`` and ``score_traces`` and the runners
    it builds in ``runner_builds``.  The port builds one function per
    distinct plan where the JAX engine compiles one, and counts the builds
    under the same names (0 on the host join, which builds none).
    ``score_traces`` and ``runner_builds`` equal the JAX engine's at every
    update; ``join_traces`` can be lower, because the JAX engine traces a
    join plan again when its slab input changes sharding (a fresh
    allocation, then the join program's output).

    ``join_timing`` holds the last update's device-join split: the host
    mirror's seconds (planning and commit, ``mirror_s``) and the join
    function's milliseconds (``program_ms``: CUDA events on the card, the
    host clock on the CPU), over ``attempts`` runs.
    """

    def __init__(
        self,
        forest,
        config: EngineConfig = EngineConfig(),
        plan: ExecutionPlan = ExecutionPlan(),
        *,
        components_impl: str = "unionfind",
        world_capacity: int | None = None,
        join_slab_capacity: int | None = None,
        window: int | None = None,
        max_resident_bytes: int | None = None,
        compact_watermark: float = 0.5,
        device=None,
    ):
        if components_impl not in COMPONENTS_IMPLS:
            raise ValueError(
                f"unknown components_impl {components_impl!r}; valid: "
                f"{list(COMPONENTS_IMPLS)}"
            )
        if plan.delta_join not in DELTA_JOINS:
            raise ValueError(
                f"unknown delta_join {plan.delta_join!r}; valid: "
                f"{list(DELTA_JOINS)}"
            )
        if config.subtraj_window is not None:
            # window ids are t * nw + j with nw derived from the world max
            # length L, which GROWS across updates: resident window ids
            # would be renumbered (as the JAX package, reject)
            raise NotImplementedError(
                "subtraj_window is not supported by StreamingEngine: the "
                "streaming world's max length grows across updates, which "
                "would invalidate resident window ids.  Use the batch "
                "AnotherMeEngine for subtrajectory search."
            )
        # the one-shot engine validates config/plan and owns the shared
        # pieces: forest tables, betas, backend, planner, device
        self._eng = AnotherMeEngine(forest, config, plan, device=device)
        self.device = self._eng.device
        self.forest = forest
        self.config = self._eng.config  # plan.lcs_impl already folded in
        self.plan = plan
        self.tables = self._eng.tables
        self.betas = self._eng.betas
        self.backend = self._eng.backend
        self.backend_ctx = self._eng.backend_ctx
        self.planner = self._eng.planner
        self.components_impl = components_impl
        H = int(self.tables.shape[0])
        self._H = H
        # world state: host mirrors (numpy, LOCAL-indexed: slot i holds
        # global id base + i) and the device-resident code table
        self.n = 0               # trajectories arrived (global ids 0..n-1)
        self.L = 1               # world max trajectory length (grows)
        self._cap = 0            # world buffer capacity (amortized doubling)
        self._base = 0           # moves only at compaction (prefix rebase)
        self._alive_np = np.zeros((0,), bool)
        self._expiry_np = np.zeros((0,), np.int64)
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.window = window
        self.max_resident_bytes = max_resident_bytes
        if not (0.0 < compact_watermark <= 1.0):
            raise ValueError(
                f"compact_watermark must be in (0, 1], got {compact_watermark}"
            )
        self.compact_watermark = float(compact_watermark)
        self.retired_total = 0   # rows ever retired (TTL + explicit)
        self.compactions = 0     # watermark compactions run
        self.compact_ms_total = 0.0  # cumulative compaction stall latency
        self._cap_floor = max(16, int(world_capacity or 0))
        self._places_np = np.full((0, 1), PAD_PLACE, np.int32)
        self._lengths_np = np.zeros((0,), np.int32)
        self._codes_dev = None   # host join: [cap, H, L] int32 codes
        self._len_dev = None     # host join: [cap] int32 lengths
        self._places_dev = None  # mesh world: [cap, L] int32 round-robin places
        self.delta_join = plan.delta_join
        # the device join, and any plan of n > 1 shards, keeps the world in
        # the round-robin places slab of a mesh (row g at physical row
        # (g % n) * cap_local + g // n; at one shard, row g)
        self._mesh_world = plan.n_shards > 1 or self.delta_join == "device"
        if self._mesh_world and plan.devices is not None \
                and self._eng.mesh().devices[0] != self.device:
            raise ValueError(
                f"the world lives on the engine's device {self.device}; the mesh's "
                f"first shard is on {self._eng.mesh().devices[0]}"
            )
        self._index = BucketIndex()
        # the device join's resident sorted slab (PAD at the end) and its
        # host count mirror (empty on the host join: driver_mirror_keys)
        self._slab_keys = None
        self._slab_rows = None
        self._slab_cap = 0
        self._join_stats = StreamJoinStats(plan.n_shards)
        self._join_plan = None
        self._score_caps = None  # sticky (pair_cap, rest_cap) of the score
        #   function, from the join's post-dedup count
        self._slab_floor = int(join_slab_capacity or 0)
        # per world shard: the serve-time REPOSE prune bounds
        self.shard_summaries = ShardSummaries(plan.n_shards if self._mesh_world else 1)
        self._examined_total = 0
        self._join_runner_cache: dict = {}
        self._runner_cache: dict = {}
        self._stream_plan: StreamShardPlan | None = None  # sticky (host join)
        self.join_traces = [0]
        self.score_traces = [0]
        self.runner_builds = 0
        self.join_timing = {"mirror_s": 0.0, "program_ms": 0.0, "attempts": 0}
        # per-update host -> device transfer accounting of this port
        self._xfer = {"bytes_in": 0, "pair_rows": 0, "key_rows": 0}
        # accumulated scored pairs (amortized-doubling host buffers)
        self._acc_cap = 0
        self._acc_n = 0
        self._acc_left = np.empty((0,), np.int32)
        self._acc_right = np.empty((0,), np.int32)
        self._acc_lvl = np.empty((0, H), np.int32)
        self._acc_mss = np.empty((0,), np.float32)
        self._overflow = 0
        # incremental communities
        self.similar_pairs: set = set()
        self._uf = comm.UnionFind()
        self._labels = np.empty((0,), np.int32)  # jit path fixpoint
        self.updates = 0

    # -- public entry points -------------------------------------------------

    def update(self, batch: TrajectoryBatch,
               *, ttl: int | None = None) -> EngineResult:
        """Ingest one micro-batch; return the current world's result.

        ttl: updates this batch's rows stay resident for (they are retired
        at the start of the ``ttl``-th subsequent update); ``window`` is a
        ceiling: rows expire after ``min(ttl, window)`` updates.
        """
        instr = Instrumentation()
        self._xfer = {"bytes_in": 0, "pair_rows": 0, "key_rows": 0}
        places = to_numpy(batch.places).astype(np.int32, copy=False)
        if places.ndim != 2:
            places = places.reshape((places.shape[0], -1) if places.size
                                    else (0, 1))
        lengths = to_numpy(batch.lengths).astype(np.int32, copy=False).reshape(-1)
        d = places.shape[0]
        # the TTL/window sweep runs FIRST, so an expiring row never pairs
        # with an arriving one
        with instr.phase("expire"):
            num_expired = self._expire_due()
        with instr.phase("keys"):
            keys_np = self._new_row_keys(places, lengths) if d else None
        # admission BEFORE any mutation: a refused update leaves the world
        # untouched
        self._admission_check(d, places.shape[1] if d else 0, keys_np)
        n_old = self.n
        with instr.phase("ingest"):
            if d:
                self._ingest(places, lengths, ttl=ttl)
                synchronize(self._places_dev if self._mesh_world else self._codes_dev)
        num_pruned = 0
        empty = (np.empty((0,), np.int32), np.empty((0,), np.int32),
                 np.empty((0, self._H), np.int32), np.empty((0,), np.float32))
        if self.delta_join == "device":
            self.join_timing = {"mirror_s": 0.0, "program_ms": 0.0, "attempts": 0}
            with instr.phase("delta_join"):
                left_dev, right_dev, num_delta, max_delta, examined = (
                    self._device_delta_join(keys_np, n_old)
                    if d else (None, None, 0, 0, 0)
                )
            with instr.phase("score"):
                if num_delta:
                    *scored, num_pruned = self._score_device_pairs(
                        left_dev, right_dev, max_delta, num_delta)
                else:
                    scored = empty
                s_left, s_right, s_lvl, s_mss = scored
                self._accumulate_scored(s_left, s_right, s_lvl, s_mss)
        else:
            with instr.phase("delta_join"):
                if d:
                    lo, hi, examined = self._index.insert(keys_np, first_id=n_old)
                else:
                    lo = hi = np.empty((0,), np.int32)
                    examined = 0
            num_delta = int(lo.shape[0])
            if self.config.score_prune and num_delta:
                with instr.phase("prune"):
                    lo, hi, num_pruned = self._prune_delta(lo, hi)
            with instr.phase("score"):
                s_left, s_right, s_lvl, s_mss = (
                    self._score_delta(lo, hi) if lo.shape[0] else empty)
                self._accumulate_scored(s_left, s_right, s_lvl, s_mss)
        with instr.phase("communities"):
            edge_mask = s_mss > np.float32(self.config.rho)
            new_edges = list(zip(s_left[edge_mask].tolist(),
                                 s_right[edge_mask].tolist()))
            communities = self._fold_edges(new_edges)
        self.updates += 1
        self._examined_total += int(examined)
        instr.record(
            num_new=d, world_size=self.n, world_capacity=self._cap,
            world_live=self.live_size, world_base=self._base,
            num_expired=num_expired, retired_total=self.retired_total,
            resident_bytes=self.resident_bytes(),
            dead_fraction=self.dead_fraction(),
            compactions=self.compactions,
            compact_ms_total=self.compact_ms_total,
            pairs_examined=examined, full_world_pairs=self._examined_total,
            num_delta_pairs=num_delta, num_candidates=self._acc_n,
            num_similar=len(self.similar_pairs),
            num_similar_new=len(new_edges),
            num_communities=len(communities),
            score_traces=self.score_traces[0],
            runner_builds=self.runner_builds,
            join_overflow=self._overflow,
            delta_join=self.delta_join,
            driver_bytes_in=self._xfer["bytes_in"],
            driver_pair_rows=self._xfer["pair_rows"],
            driver_key_rows=self._xfer["key_rows"],
            host_index_entries=self._index.num_keys_inserted,
            driver_mirror_keys=self._join_stats.num_keys,
            join_traces=self.join_traces[0],
        )
        if self.delta_join == "device":
            # the score buffers are sized from the join's post-dedup count,
            # never from its pre-dedup emission bound
            instr.record(
                join_pair_cap=self._join_plan.pair_cap if self._join_plan else 0,
                score_pair_cap=self._score_caps[0] if self._score_caps else 0,
            )
        if self.config.score_prune:
            instr.record(num_pruned=num_pruned)
        return EngineResult(
            scored=self._scored(), similar_pairs=set(self.similar_pairs),
            communities=communities, stats=instr.finalize(),
        )

    def update_many(self, batches) -> EngineResult:
        """Ingest a sequence of micro-batches; return the final result."""
        result = None
        for batch in batches:
            result = self.update(batch)
        if result is None:
            raise ValueError("update_many needs at least one micro-batch")
        return result

    @property
    def world_size(self) -> int:
        return self.n

    @property
    def live_size(self) -> int:
        """Trajectories currently resident and alive."""
        return int(self._alive_np[: self.n - self._base].sum())

    # -- bounded memory: retirement, compaction, admission -------------------

    def retire(self, ids) -> int:
        """Retire trajectories by global id; returns how many were live.

        Retired rows leave the logical world at once: they stop emitting
        candidate pairs (host bucket eviction), their scored pairs and
        similarity edges are purged and their communities un-merge, so the
        result equals a one-shot run over the surviving rows.  The world
        table is repacked when the dead fraction trips
        ``compact_watermark``.  Already-retired (or compacted-away) ids are
        ignored, so the call is idempotent; ids outside ``0..n-1`` raise.
        """
        req = sorted({int(i) for i in np.asarray(
            list(ids), dtype=np.int64).reshape(-1).tolist()})
        for i in req:
            if i < 0 or i >= self.n:
                raise ValueError(
                    f"cannot retire id {i}: world holds ids 0..{self.n - 1}"
                )
        base = self._base
        dead = [i for i in req
                if i >= base and self._alive_np[i - base]]
        if not dead:
            return 0
        self._retire(np.asarray(dead, np.int64))
        self._maybe_compact()
        return len(dead)

    def resident_bytes(self) -> int:
        """Bytes of device-resident world state (the code table and the
        lengths, or the places slab and the join slab): what
        ``max_resident_bytes`` bounds."""
        total = 0
        if self._codes_dev is not None:
            total += self._codes_dev.numel() * 4 + self._len_dev.numel() * 4
        if self._places_dev is not None:
            total += self._places_dev.numel() * 4
        if self._slab_keys is not None:
            total += self._slab_keys.numel() * 4 + self._slab_rows.numel() * 4
        return int(total)

    def dead_fraction(self) -> float:
        """Tombstone fraction awaiting compaction (the watermark input): of
        the resident rows, and on the device join also of the slab."""
        span = self.n - self._base
        frac = (span - self.live_size) / span if span else 0.0
        if self.delta_join == "device":
            frac = max(frac, self._join_stats.dead_fraction())
        return float(frac)

    def _resident_bytes_at(self, world_cap: int, slab_cap: int,
                           world_L: int | None = None) -> int:
        """Projected resident bytes at the given capacities (admission)."""
        L = self.L if world_L is None else world_L
        if self._mesh_world:
            world = world_cap * L * 4
        else:
            world = world_cap * self._H * L * 4 + world_cap * 4
        slab = 2 * self.plan.n_shards * slab_cap * 4 if self.delta_join == "device" else 0
        return world + slab

    def _admission_check_bytes(self, projected: int, what: str) -> None:
        if self.max_resident_bytes is None:
            return
        if projected > self.max_resident_bytes:
            raise CapacityExceeded(
                f"{what} needs {projected} resident bytes, over the "
                f"max_resident_bytes budget of {self.max_resident_bytes}; "
                "the update was refused and the world is unchanged — "
                "retire rows, raise the budget, or shrink the batch",
                needed_bytes=projected,
                budget_bytes=self.max_resident_bytes,
            )

    def _admission_check(self, d: int, Lb: int, keys_np) -> None:
        """Would this update's buffer growth exceed ``max_resident_bytes``?
        Mirrors ``_ingest``'s growth arithmetic and the join planner's slab
        sizing, and runs before any mutation, so a refusal leaves the world
        unchanged."""
        if self.max_resident_bytes is None or not d:
            return
        new_cap = self._grown_capacity(self.n - self._base + d)
        slab_cap = self._slab_cap
        if self.delta_join == "device" and keys_np is not None:
            k_flat, _ = flat_row_keys(keys_np)
            if k_flat.size:
                jplan = self.planner.plan_stream_join(
                    k_flat, self.plan.n_shards, self._join_stats)
                slab_cap = max(slab_cap, jplan.slab_cap)
        self._admission_check_bytes(
            self._resident_bytes_at(new_cap, slab_cap, max(self.L, Lb)),
            f"ingesting {d} rows",
        )

    def _expire_due(self) -> int:
        """Retire every live row whose TTL/window closed (expiry update <=
        the current update index)."""
        span = self.n - self._base
        if not span:
            return 0
        due = np.nonzero(
            self._alive_np[:span]
            & (self._expiry_np[:span] <= self.updates)
        )[0]
        if due.size == 0:
            return 0
        self._retire(due.astype(np.int64) + self._base)
        self._maybe_compact()
        return int(due.size)

    def _retire(self, dead: np.ndarray) -> None:
        """Logically delete ``dead`` (sorted global ids, all live) from
        every layer that caches world state."""
        base = self._base
        dl = (dead - base).astype(np.int64)
        self._alive_np[dl] = False
        self.retired_total += int(dead.size)
        # keys are a pure per-row function: recompute them from the mirror
        keys_np = self._new_row_keys(self._places_np[dl], self._lengths_np[dl])
        if self.delta_join == "device":
            k_flat, _ = flat_row_keys(keys_np)
            if k_flat.size:
                self._join_stats.retire(
                    k_flat, _positive_hash_np(k_flat) % self.plan.n_shards)
            if self._slab_keys is not None:
                # tombstone the slab in place: rows become PAD_ID, keys stay.
                # The dead list ships PAD-padded at a power-of-two size
                m_cap = self.planner.update_capacity(int(dead.size))
                buf = np.full((m_cap,), PAD_ID, np.int32)
                buf[: dead.size] = dl
                self._xfer["bytes_in"] += buf.nbytes
                self._slab_rows = mark_dead_rows(
                    self._slab_rows, torch.tensor(buf, device=self.device))
        else:
            self._index.retire(dead.tolist(), keys_np)
        # purge scored pairs touching a dead row into FRESH buffers: results
        # already returned may hold views of the old ones
        if self._acc_n:
            left = self._acc_left[: self._acc_n]
            right = self._acc_right[: self._acc_n]
            keep = self._alive_np[left - base] & self._alive_np[right - base]
            k = int(keep.sum())
            for name in ("_acc_left", "_acc_right", "_acc_lvl", "_acc_mss"):
                old = getattr(self, name)
                fresh = old.copy()
                fresh[:k] = old[: self._acc_n][keep]
                setattr(self, name, fresh)
            self._acc_n = k
        dead_set = set(int(i) for i in dead.tolist())
        self.similar_pairs = {
            (a, b) for (a, b) in self.similar_pairs
            if a not in dead_set and b not in dead_set
        }
        self._unmerge_communities(dl)
        # a maximum cannot be maintained under deletion: recompute the
        # prune summaries from the live mirror
        span = self.n - base
        self.shard_summaries.rebuild(
            base, self._lengths_np[:span], self._alive_np[:span]
        )

    def _unmerge_communities(self, dead_local: np.ndarray) -> None:
        """Deletion can SPLIT a component: re-solve only the components
        that contained a dead node, warm-starting from the survivors."""
        if self.config.community_mode == "cliques":
            return  # cliques re-derive from similar_pairs on every fold
        base = self._base
        span = self.n - base
        labels = np.arange(span, dtype=np.int32)
        m = min(self._labels.shape[0], span)
        labels[:m] = self._labels[:m]
        edges_local = [(a - base, b - base) for (a, b) in self.similar_pairs]
        if self.components_impl == "unionfind":
            self._labels = comm.components_after_deletion(
                labels, dead_local.tolist(), edges_local
            )
        else:
            # untouched components enter as stars of their labels, touched
            # ones dissolve to singletons and re-form from the surviving
            # edges on the device
            lab = labels.astype(np.int64)
            touched = np.unique(lab[dead_local])
            idx = np.nonzero(np.isin(lab, touched))[0]
            lab[idx] = idx
            tset = set(idx.tolist())
            delta = [e for e in edges_local if e[0] in tset or e[1] in tset]
            self._labels = self._propagate(lab, delta, max(self._cap, span))[:span]
        self._uf.reset_from_labels(self._labels)

    def _maybe_compact(self) -> None:
        if self.dead_fraction() >= self.compact_watermark:
            self._compact()

    def _compact(self) -> None:
        """Watermark compaction: the base advances past the dead prefix (a
        PREFIX rebase: global ids stay, the device sees local ids), the
        world rolls by ``(arange + shift) % cap``, and on the device join
        the slab drops its tombstones and may shrink: the one point where
        the capacity plans may contract."""
        t0 = time.perf_counter()
        base = self._base
        span = self.n - base
        n_sh = self.plan.n_shards if self._mesh_world else 1
        live_idx = np.nonzero(self._alive_np[:span])[0]
        # the base stays a multiple of n_shards, so the round-robin owner
        # g % n of every row is the same before and after the shift
        first = int(live_idx[0]) if live_idx.size else span
        shift = (first // n_sh) * n_sh
        if shift:
            keep = span - shift
            self._places_np[:keep] = self._places_np[shift:span]
            self._lengths_np[:keep] = self._lengths_np[shift:span]
            self._alive_np[:keep] = self._alive_np[shift:span]
            self._expiry_np[:keep] = self._expiry_np[shift:span]
            self._alive_np[keep:span] = False
            self._expiry_np[keep:span] = NEVER_EXPIRES
            if self._codes_dev is not None:
                idx = (torch.arange(self._cap, device=self.device) + shift) % self._cap
                self._codes_dev = self._codes_dev.index_select(0, idx)
                self._len_dev = self._len_dev.index_select(0, idx)
            if self._places_dev is not None:
                # each shard's block rolls by shift // n
                cl = self._cap // n_sh
                idx = (torch.arange(cl, device=self.device) + shift // n_sh) % cl
                self._places_dev = self._places_dev.reshape(n_sh, cl, -1).index_select(
                    1, idx).reshape(self._cap, -1)
            if self._labels.shape[0] > shift:
                self._labels = self._labels[shift:] - shift
            else:
                self._labels = np.empty((0,), np.int32)
            self._uf.reset_from_labels(self._labels)
        if self.delta_join == "device":
            if self._slab_keys is not None:
                self._compact_slab(shift)
            self._join_stats.compact()
        # the next update replans from the post-compaction mirror
        self._join_plan = None
        self._score_caps = None
        self._stream_plan = None
        self._base = base + shift
        self.compactions += 1
        self.compact_ms_total += (time.perf_counter() - t0) * 1e3

    def _compact_slab(self, shift: int) -> None:
        """Drop each shard's slab tombstones, rebase its rows by ``shift``,
        and shrink its segment to the post-compaction plan (doubling, never
        lossy, if the plan proves short)."""
        n_sh = self.plan.n_shards
        live = self._join_stats.owner_entries - self._join_stats.owner_dead
        want = int(max(np.max(live), 1) * self.planner.slack) if live.size else 1
        out_cap = max(4, _pow2(want))
        if self._slab_floor:
            out_cap = max(out_cap, _pow2(-(-self._slab_floor // n_sh)))
        keys = self._slab_keys.reshape(n_sh, self._slab_cap)
        rows = self._slab_rows.reshape(n_sh, self._slab_cap)
        for _ in range(self.planner.max_retries + 1):
            out = [compact_slab(k, r, shift, out_cap=out_cap) for k, r in zip(keys, rows)]
            if sum(int(o[3]) for o in out) == 0:
                break
            out_cap *= 2
        self._slab_keys = torch.cat([o[0] for o in out])
        self._slab_rows = torch.cat([o[1] for o in out])
        self._slab_cap = out_cap

    # -- ingestion: world growth + device-resident appends -------------------

    def _ingest(self, places: np.ndarray, lengths: np.ndarray,
                *, ttl: int | None = None) -> None:
        d, Lb = places.shape
        new_L = max(self.L, Lb)
        span = self.n - self._base  # resident rows (live + tombstoned)
        new_cap = self._grown_capacity(span + d)
        rebuild = (new_L != self.L) or (new_cap != self._cap)
        if rebuild:
            grown = np.full((new_cap, new_L), PAD_PLACE, np.int32)
            grown[:span, : self.L] = self._places_np[:span]
            self._places_np = grown
            glen = np.zeros((new_cap,), np.int32)
            glen[:span] = self._lengths_np[:span]
            self._lengths_np = glen
            galive = np.zeros((new_cap,), bool)
            galive[:span] = self._alive_np[:span]
            self._alive_np = galive
            gexp = np.full((new_cap,), NEVER_EXPIRES, np.int64)
            gexp[:span] = self._expiry_np[:span]
            self._expiry_np = gexp
            self.L, self._cap = new_L, new_cap
        n0 = self.n
        n0l = n0 - self._base
        rows = slice(n0l, n0l + d)
        self._places_np[rows, :Lb] = places
        self._places_np[rows, Lb:] = PAD_PLACE
        self._lengths_np[rows] = lengths
        self._alive_np[rows] = True
        eff_ttl = ttl if self.window is None \
            else (self.window if ttl is None else min(ttl, self.window))
        self._expiry_np[rows] = (
            NEVER_EXPIRES if eff_ttl is None else self.updates + eff_ttl
        )
        self.n = n0 + d
        self.shard_summaries.insert(n0, lengths)
        # only the new rows go to the device, unless the world was rebuilt;
        # torch.tensor copies, so the device world never aliases the mirror
        if self._mesh_world:
            # the round-robin places slab: local id g at (g % n) * cl + g // n
            # (the base is a multiple of n, so g % n is the global owner)
            n_sh = self.plan.n_shards
            cl = self._cap // n_sh
            if rebuild or self._places_dev is None:
                g = np.arange(self.n - self._base, dtype=np.int64)
                phys = np.full((self._cap, self.L), PAD_PLACE, np.int32)
                phys[(g % n_sh) * cl + g // n_sh] = self._places_np[: g.shape[0]]
                self._places_dev = torch.tensor(phys, device=self.device)
                self._xfer["bytes_in"] += phys.nbytes
            else:
                g = np.arange(n0l, n0l + d, dtype=np.int64)
                idx = (g % n_sh) * cl + g // n_sh
                new_places = self._places_np[rows]
                self._places_dev[torch.tensor(idx, device=self.device)] = torch.tensor(
                    new_places, device=self.device)
                self._xfer["bytes_in"] += new_places.nbytes + idx.nbytes
        elif rebuild or self._codes_dev is None:
            self._codes_dev = encode_codes(
                torch.tensor(self._places_np, device=self.device), self.tables
            )
            self._len_dev = torch.tensor(self._lengths_np, device=self.device)
            self._xfer["bytes_in"] += self._places_np.nbytes + self._lengths_np.nbytes
        else:
            new_places = self._places_np[rows]
            self._codes_dev[rows] = encode_codes(
                torch.tensor(new_places, device=self.device), self.tables
            )
            self._len_dev[rows] = torch.tensor(lengths, device=self.device)
            self._xfer["bytes_in"] += new_places.nbytes + lengths.nbytes

    def _grown_capacity(self, needed: int) -> int:
        """The world capacity covering ``needed`` resident rows: amortized
        doubling, and on n > 1 shards n times a doubling of the per-shard
        rows, so the round-robin blocks stay equal."""
        cap = self.planner.grow_capacity(max(self._cap, self._cap_floor), needed)
        n_sh = self.plan.n_shards
        if n_sh > 1:
            cap = n_sh * self.planner.grow_capacity(1, -(-cap // n_sh))
        return cap

    # -- incremental candidate generation ------------------------------------

    def _new_row_keys(self, places: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Join keys of the given rows only, from the coarsest-level view:
        every backend's keys are a pure per-row function of the type codes
        and lengths, so keys computed at arrival stay valid."""
        pl = torch.tensor(places, dtype=torch.int32, device=self.device)
        ln = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        types = encode_types(pl, self.tables)
        view = EncodedBatch(codes=types[:, None, :], lengths=ln)
        mini = TrajectoryBatch(
            places=pl, lengths=ln,
            user_id=torch.arange(pl.shape[0], dtype=torch.int32, device=self.device),
        )
        keys = self.backend.join_keys(view, mini, self.backend_ctx)
        if keys is None:
            raise ValueError(
                f"candidate backend {self.backend.name!r} produces no join "
                "keys; streaming ingestion requires a key-based backend"
            )
        return to_numpy(keys)

    def _prune_delta(self, lo, hi):
        """MSS upper-bound prune of the delta pairs (the one-shot pass's
        float32 test, so the surviving pair set is identical)."""
        bsum = float(to_numpy(self.betas).astype(np.float32).sum())
        lens = self._lengths_np
        b = self._base
        ub = mss_upper_bound(lens[lo - b], lens[hi - b], bsum)
        keep = ub > np.float32(self.config.rho - PRUNE_EPS)
        return lo[keep], hi[keep], int(lo.shape[0] - keep.sum())

    # -- delta scoring through the one-shot lcs_impl dispatch ----------------

    def _score_delta(self, lo, hi):
        """Score the host join's delta pairs: against the one-shard code
        table, or through the score program on the mesh world."""
        if self._mesh_world:
            return self._score_delta_sharded(lo, hi)
        return self._score_delta_single(lo, hi)

    def _score_delta_single(self, lo, hi):
        """Score the delta pairs against the resident table.  The table is
        local-indexed, so the device gets LOCAL ids (g - base); the
        returned ids stay global."""
        impl = self.config.lcs_impl
        k = int(lo.shape[0])
        jl = torch.tensor(lo - self._base, dtype=torch.int32, device=self.device)
        jr = torch.tensor(hi - self._base, dtype=torch.int32, device=self.device)
        self._xfer["pair_rows"] += k
        self._xfer["bytes_in"] += 8 * k
        if impl in _KERNEL_MODES:
            enc = EncodedBatch(codes=self._codes_dev, lengths=self._len_dev)
            cand = CandidatePairs(
                left=jl, right=jr,
                count=torch.tensor(k, dtype=torch.int32, device=self.device),
                overflow=torch.tensor(0, dtype=torch.int32, device=self.device),
            )
            lvl, mss = _score_with_kernel(enc, cand, self.betas,
                                          mode=_KERNEL_MODES[impl])
        else:
            lvl, mss = score_pairs(
                self._codes_dev, self._len_dev, jl, jr, self.betas,
                impl_name=impl, wavefront_dtype=wavefront_dtype_from_env(),
            )
        return (lo.astype(np.int32), hi.astype(np.int32), to_numpy(lvl),
                to_numpy(mss))

    def _score_delta_sharded(self, lo, hi):
        """Score the delta pairs on the mesh: contiguous per-shard chunks of
        LOCAL ids at a sticky plan (monotone max while ``cap_local`` holds;
        the fresh plan's chunk loads are computed under the sticky
        ``pair_cap``), its owner hops doubled while they overflow."""
        n_sh = self.plan.n_shards
        cl = self._cap // n_sh
        lo, hi = lo - self._base, hi - self._base
        prev = self._stream_plan
        sticky = prev is not None and prev.cap_local == cl
        splan = plan_stream_capacities(
            lo, hi, n_sh, cl, score_mode=self.plan.score_mode,
            overlap_chunks=self.plan.overlap_chunks,
            pair_cap_floor=prev.pair_cap if sticky else 0,
        )
        if sticky:
            splan = StreamShardPlan(
                n_shards=n_sh, cap_local=cl, pair_cap=max(splan.pair_cap, prev.pair_cap),
                hop_cap=max(splan.hop_cap, prev.hop_cap),
                out_cap=max(splan.out_cap, prev.out_cap), n_chunks=splan.n_chunks,
            )
            if self.plan.score_mode == "replicate":
                splan = dataclasses.replace(splan, out_cap=splan.pair_cap)
        for _ in range(self.planner.max_retries + 1):
            out = self._run_stream_runner(splan, lo, hi)
            if int(out["overflow"].sum()) == 0:
                break
            splan = dataclasses.replace(splan, hop_cap=max(splan.hop_cap, 1) * 2,
                                        out_cap=splan.out_cap * 2)
        self._stream_plan = splan
        self._overflow += int(out["overflow"].sum())
        return self._collect_scored(out)

    def _run_stream_runner(self, splan, lo, hi):
        """One run of the score program on the host join's pairs (pruned on
        the host already, so the program does not prune)."""
        runner = self._score_runner(splan, score_prune=False)
        left, right = shard_chunks((lo, hi), splan.n_shards, splan.pair_cap, (PAD_ID, PAD_ID))
        self._xfer["pair_rows"] += int(lo.shape[0])
        self._xfer["bytes_in"] += left.nbytes + right.nbytes
        return runner(self._places_dev, torch.tensor(left.reshape(-1), device=self.device),
                      torch.tensor(right.reshape(-1), device=self.device), self.tables)

    # -- the device-resident delta join (delta_join="device") ---------------

    def _device_delta_join(self, keys_np, n_old: int):
        """Ship ONLY the new rows' key occurrences into the join function.

        The resident slabs are probed and merged on the device; the deduped
        delta pairs rest there as ``[n_shards, pair_cap]`` buffers that feed
        the score program.  Returns ``(left_dev, right_dev, num_delta,
        max_delta, examined)``, ``max_delta`` the post-dedup count that
        sizes the score buffers.

        The commit is functional: the join function RETURNS the merged
        slab, and the engine adopts it (and folds the update into the count
        mirror) only after a run with zero overflow, so the retries replan
        and rerun from unchanged state.
        """
        t_mirror = time.perf_counter()
        k_flat, row_idx = flat_row_keys(keys_np)
        if k_flat.size == 0:
            self.join_timing["mirror_s"] += time.perf_counter() - t_mirror
            return None, None, 0, 0, 0
        n_sh = self.plan.n_shards
        fresh = self.planner.plan_stream_join(k_flat, n_sh, self._join_stats)
        self.join_timing["mirror_s"] += time.perf_counter() - t_mirror
        if _fault_inject():
            # derate every stage of the FRESH plan (sticky maxima still
            # apply) so the overflow -> compact -> retry path runs
            fresh = dataclasses.replace(
                fresh,
                key_route_cap=_derate_cap(fresh.key_route_cap),
                nn_cap=_derate_cap(fresh.nn_cap), no_cap=_derate_cap(fresh.no_cap),
                pair_route_cap=_derate_cap(fresh.pair_route_cap),
                pair_cap=_derate_cap(fresh.pair_cap),
            )
        jplan = sticky_join_plan(fresh, self._join_plan)
        if self._slab_cap > jplan.slab_cap:
            # the slab only shrinks at a compaction; between them the plan
            # must match its allocation
            jplan = dataclasses.replace(jplan, slab_cap=self._slab_cap)
        if self._slab_floor:
            floor = _pow2(-(-self._slab_floor // n_sh))
            if floor > jplan.slab_cap:
                jplan = dataclasses.replace(jplan, slab_cap=floor)
        out = None
        retries = self.planner.max_retries + (4 if _fault_inject() else 0)
        compacted = False
        for _ in range(retries + 1):
            self._ensure_slab(jplan.slab_cap)
            # local row ids, recomputed per attempt: a compaction in the
            # loop moves the base
            r_flat = (n_old - self._base + row_idx).astype(np.int32)
            in_k, in_r = shard_chunks((k_flat, r_flat), n_sh, jplan.key_in_cap, (PAD_KEY, PAD_ID))
            self._xfer["key_rows"] += int(k_flat.shape[0])
            self._xfer["bytes_in"] += in_k.nbytes + in_r.nbytes
            out, ovf = self._run_join(jplan, in_k, in_r)
            if int(ovf.sum()) == 0:
                break
            if int(ovf[2]) and not compacted and int(self._join_stats.owner_dead.sum()):
                # slab overflow with tombstones resident: reclaim them FIRST
                # and retry at the (maybe smaller) post-compaction plan
                self._compact()
                compacted = True
                t_mirror = time.perf_counter()
                jplan = self.planner.plan_stream_join(k_flat, n_sh, self._join_stats)
                self.join_timing["mirror_s"] += time.perf_counter() - t_mirror
                if self._slab_cap > jplan.slab_cap:
                    jplan = dataclasses.replace(jplan, slab_cap=self._slab_cap)
                continue
            # exact planning makes a steady-state overflow impossible; double
            # whatever stage overflowed
            jplan = dataclasses.replace(
                jplan,
                key_route_cap=jplan.key_route_cap * 2,
                nn_cap=jplan.nn_cap * 2, no_cap=jplan.no_cap * 2,
                pair_route_cap=jplan.pair_route_cap * 2,
                pair_cap=jplan.pair_cap * 2,
                slab_cap=jplan.slab_cap * (2 if int(ovf[2]) else 1),
            )
            self._admission_check_bytes(
                self._resident_bytes_at(self._cap, jplan.slab_cap),
                "in-mesh delta join retry doubling",
            )
        if int(ovf.sum()):
            # never adopt a slab whose merge dropped entries: every later
            # pair of the dropped rows would be lost
            raise CapacityExceeded(
                "in-mesh delta join still overflowed after "
                f"{retries} retries (per-shard overflow "
                f"{to_numpy(out['overflow']).tolist()}); refusing to "
                "commit a lossy bucket state"
            )
        self._slab_keys = out["slab_keys"]
        self._slab_rows = out["slab_rows"]
        t_mirror = time.perf_counter()
        self._join_stats.commit(k_flat, _positive_hash_np(k_flat) % n_sh)
        self.join_timing["mirror_s"] += time.perf_counter() - t_mirror
        self._join_plan = jplan
        num_delta = int(out["count"].sum())
        max_delta = int(out["max_count"][0])
        examined = int(out["examined"].sum())
        return out["left"], out["right"], num_delta, max_delta, examined

    def _run_join(self, jplan, in_k: np.ndarray, in_r: np.ndarray):
        """One run of the join program on copies of the key buffers;
        returns its outputs and the host copy of its per-stage overflow
        (summed over the shards).  The run is timed into ``join_timing``
        (CUDA events on the card)."""
        dev = self.device
        keys = torch.tensor(in_k.reshape(-1), device=dev)
        rows = torch.tensor(in_r.reshape(-1), device=dev)
        runner = self._join_runner(jplan)
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = runner(self._slab_keys, self._slab_rows, keys, rows)
            end.record()
            ovf = to_numpy(out["overflow"]).sum(axis=0)
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = runner(self._slab_keys, self._slab_rows, keys, rows)
            ovf = to_numpy(out["overflow"]).sum(axis=0)
            ms = (time.perf_counter() - t0) * 1e3
        self.join_timing["program_ms"] += ms
        self.join_timing["attempts"] += 1
        return out, ovf

    def _ensure_slab(self, slab_cap: int) -> None:
        """Allocate the slabs, or regrow them to ``slab_cap`` a shard by
        padding each shard's segment at its end on the device (valid
        entries stay at the front; nothing goes through the host)."""
        n_sh = self.plan.n_shards
        if self._slab_keys is None:
            self._slab_cap = slab_cap
            n = n_sh * slab_cap
            self._slab_keys = torch.full((n,), PAD_KEY, dtype=torch.int32, device=self.device)
            self._slab_rows = torch.full((n,), PAD_ID, dtype=torch.int32, device=self.device)
        elif slab_cap > self._slab_cap:
            grow = (0, slab_cap - self._slab_cap)
            pad = torch.nn.functional.pad
            self._slab_keys = pad(self._slab_keys.reshape(n_sh, -1), grow,
                                  value=PAD_KEY).reshape(-1)
            self._slab_rows = pad(self._slab_rows.reshape(n_sh, -1), grow,
                                  value=PAD_ID).reshape(-1)
            self._slab_cap = slab_cap

    def _join_runner(self, jplan):
        runner = self._join_runner_cache.get(jplan)
        if runner is None:
            runner = make_streaming_join_pipeline(self._eng.mesh(), jplan,
                                                  axis_name=self.plan.axis_name,
                                                  trace_counter=self.join_traces)
            self._join_runner_cache[jplan] = runner
            self.runner_builds += 1
        return runner

    def _score_device_pairs(self, left_dev, right_dev, max_delta, num_delta):
        """Score the join's resting delta pairs straight off their device
        buffers, pruned in the score program under ``score_prune``.

        The buffers are cut to ``pow2(max_delta)`` columns, the worst
        per-shard post-dedup count (dedup compacts the valid pairs to the
        front), not the join plan's pre-dedup bound.  In ``"shuffle"`` mode
        the hop buckets and resting buffers take ``pow2(num_delta)``, the
        global count (the hops may pile every pair onto one owner), and
        double while they overflow.  Both caps are sticky (monotone max).
        """
        n_sh = self.plan.n_shards
        join_cap = int(left_dev.shape[-1])
        pair_cap = min(_pow2(max_delta), join_cap)
        rest_cap = min(_pow2(num_delta), join_cap)
        if self._score_caps is not None:
            pair_cap = min(max(pair_cap, self._score_caps[0]), join_cap)
            rest_cap = min(max(rest_cap, self._score_caps[1]), join_cap)
        self._score_caps = (pair_cap, rest_cap)
        left_dev = left_dev[:, :pair_cap].reshape(-1)
        right_dev = right_dev[:, :pair_cap].reshape(-1)
        shuffle = self.plan.score_mode == "shuffle"
        splan = StreamShardPlan(
            n_shards=n_sh, cap_local=self._cap // n_sh, pair_cap=pair_cap,
            hop_cap=rest_cap if shuffle else 0, out_cap=rest_cap if shuffle else pair_cap,
        )
        for _ in range(self.planner.max_retries + 1):
            # pruning, if configured, runs in the program: the pairs are not
            # on the host to be pruned there
            runner = self._score_runner(splan, score_prune=self.config.score_prune)
            out = runner(self._places_dev, left_dev, right_dev, self.tables)
            if int(out["overflow"].sum()) == 0:
                break
            splan = dataclasses.replace(splan, hop_cap=max(splan.hop_cap, 1) * 2,
                                        out_cap=splan.out_cap * 2)
        self._overflow += int(out["overflow"].sum())
        num_pruned = int(out["pruned"].sum())
        return (*self._collect_scored(out), num_pruned)

    def _score_runner(self, splan, *, score_prune: bool):
        """One score program per (plan, mode, impl, wavefront dtype, world
        shape, prune), shared by the host-pair and device-pair paths, as the
        JAX engine caches its compiled runners."""
        key = (splan, self.plan.score_mode, self.config.lcs_impl,
               wavefront_dtype_from_env(), self.L, self._H, score_prune)
        runner = self._runner_cache.get(key)
        if runner is None:
            runner = make_streaming_score_pipeline(
                self._eng.mesh(), splan, betas=self.betas, axis_name=self.plan.axis_name,
                score_mode=self.plan.score_mode, lcs_impl=self.config.lcs_impl,
                trace_counter=self.score_traces, score_prune=score_prune,
                prune_tau=self.config.rho,
            )
            self._runner_cache[key] = runner
            self.runner_builds += 1
        return runner

    def _collect_scored(self, out):
        """The valid slots of a score function's output, as global ids in
        lexicographic (left, right) order, the host join's order."""
        left = to_numpy(out["left"]).reshape(-1)
        right = to_numpy(out["right"]).reshape(-1)
        mss = to_numpy(out["mss"]).reshape(-1)
        lvl = to_numpy(out["level_lcs"]).reshape(-1, self._H)
        valid = left != PAD_ID
        left = left[valid] + np.int32(self._base)
        right = right[valid] + np.int32(self._base)
        order = np.lexsort((right, left))
        return left[order], right[order], lvl[valid][order], mss[valid][order]

    # -- accumulation + incremental communities ------------------------------

    def _accumulate_scored(self, left, right, lvl, mss):
        k = left.shape[0]
        if self._acc_n + k > self._acc_cap:
            cap = self.planner.grow_capacity(
                max(self._acc_cap, 16), self._acc_n + k
            )
            for name in ("_acc_left", "_acc_right", "_acc_lvl", "_acc_mss"):
                old = getattr(self, name)
                shape = (cap,) + old.shape[1:]
                grown = np.full(shape, PAD_ID, old.dtype) \
                    if old.dtype == np.int32 and old.ndim == 1 \
                    else np.zeros(shape, old.dtype)
                grown[: self._acc_n] = old[: self._acc_n]
                setattr(self, name, grown)
            self._acc_cap = cap
        s = slice(self._acc_n, self._acc_n + k)
        self._acc_left[s] = left
        self._acc_right[s] = right
        self._acc_lvl[s] = lvl
        self._acc_mss[s] = mss
        self._acc_n += k

    def _scored(self) -> ScoredPairs:
        """The accumulated scored pairs as tensors on the engine's device
        (views of the host buffers on the CPU: appends write past them and
        a purge writes fresh buffers, so they stay valid)."""
        n = self._acc_n

        def t(x):
            return torch.as_tensor(x, device=self.device)

        return ScoredPairs(
            left=t(self._acc_left[:n]), right=t(self._acc_right[:n]),
            level_lcs=t(self._acc_lvl[:n]), mss=t(self._acc_mss[:n]),
            count=torch.tensor(n, dtype=torch.int32, device=self.device),
            overflow=torch.tensor(self._overflow, dtype=torch.int32, device=self.device),
        )

    def _fold_edges(self, new_edges) -> set:
        self.similar_pairs.update((int(a), int(b)) for a, b in new_edges)
        # union-find / label state is LOCAL (node i = global id base + i),
        # so compaction can slide it with the world
        base = self._base
        self._uf.add(self.n - base - self._uf.num_nodes)
        for a, b in new_edges:
            self._uf.union(int(a) - base, int(b) - base)
        mode = self.config.community_mode
        if mode == "cliques":
            return comm.maximal_cliques(self.similar_pairs)
        if mode != "components":
            raise ValueError(
                f"unknown community_mode {mode!r}; valid modes: "
                "['cliques', 'components']"
            )
        if self.components_impl == "unionfind":
            self._labels = self._uf.labels()
        elif self.n > base:
            # resumable min-label propagation: the previous fixpoint enters
            # as star edges (label[v], v), so only the delta edges (plus the
            # stars) run, seeded with the stale labels
            seed = np.arange(self._cap, dtype=np.int64)
            seed[: self._labels.shape[0]] = self._labels
            delta = [(a - base, b - base) for a, b in new_edges]
            self._labels = self._propagate(seed, delta, self._cap)[: self.n - base]
        else:
            return set()
        return self._sets_to_global(comm.components_as_sets(self._labels))

    def _propagate(self, seed: np.ndarray, edges, cap: int) -> np.ndarray:
        """``connected_components`` on the device over ``cap`` nodes: star
        edges ``(seed[v], v)`` plus ``edges`` (padded to a power-of-two
        count, as the JAX engine pads them), seeded with ``seed``."""
        full = np.arange(cap, dtype=np.int32)
        full[: seed.shape[0]] = seed
        e_cap = self.planner.update_capacity(len(edges))
        el = np.full((e_cap,), PAD_ID, np.int32)
        er = np.full((e_cap,), PAD_ID, np.int32)
        if edges:
            el[: len(edges)], er[: len(edges)] = np.asarray(edges, np.int64).T
        left = np.concatenate([full, el])
        right = np.concatenate([np.arange(cap, dtype=np.int32), er])
        labels = comm.connected_components(
            torch.tensor(left, device=self.device),
            torch.tensor(right, device=self.device), num_nodes=cap,
            init_labels=torch.tensor(full, device=self.device),
        )
        return to_numpy(labels)

    def _sets_to_global(self, sets: set) -> set:
        """Translate local-index community sets to global trajectory ids."""
        base = self._base
        if not base:
            return sets
        return {frozenset(i + base for i in s) for s in sets}
