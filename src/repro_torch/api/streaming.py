"""`StreamingEngine`: micro-batch ingestion with incremental maintenance.

    from repro_torch.api import StreamingEngine, EngineConfig

    stream = StreamingEngine(forest, EngineConfig(backend="ssh", rho=2.0))
    for micro_batch in feed:
        result = stream.update(micro_batch)   # EngineResult, same type as
                                              # AnotherMeEngine.run

Port of ``repro/api/streaming.py`` on one device with the host delta join
(``ExecutionPlan(delta_join="host")``).  Per-update cost follows the DELTA,
not the world:

* the world's ``[cap, H, L]`` code table and its lengths live on the
  engine's device (the card unless ``device="cpu"``) and grow by amortized
  doubling (:meth:`CapacityPlanner.grow_capacity`); an update encodes and
  writes only its new rows, and a growth of the world width ``L`` rebuilds
  the table from the host mirror;
* candidates come from a host :class:`~repro_torch.core.stream_index.BucketIndex`
  that inserts the new rows' keys and emits exactly the pairs whose later
  member arrived in this update;
* the delta pairs are scored on the device through the one-shot engine's
  ``lcs_impl`` dispatch (the fused kernel #1 under ``"fused"``, the batched
  LCS kernel #2 under ``"kernel"``), on LOCAL ids (slot = id - base);
* communities are maintained incrementally: a host union-find, or
  ``connected_components`` on the device warm-started from the previous
  labels through star edges ``(label[v], v)``, or Bron-Kerbosch over the
  accumulated edges in ``"cliques"`` mode;
* rows leave by TTL, ``window`` or :meth:`StreamingEngine.retire`; their
  pairs, edges and communities go at once, and a watermark compaction
  rolls the world table to the live window.

The final update's result equals a one-shot ``AnotherMeEngine.run`` over
the surviving rows, for any split into micro-batches, and every buffer
equals the JAX engine's slot by slot.  ``delta_join="device"`` and
``n_shards > 1`` raise :class:`NotPortedError`; ``subtraj_window`` raises
``NotImplementedError``, as in the JAX package.  ``REPRO_FAULT_INJECT=1``
derates only the capacity plans of the JAX package's device join; the host
join has no capacity that can overflow, so, as there, it changes nothing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.engine import AnotherMeEngine, EngineConfig, ExecutionPlan
from repro_torch.api.errors import CapacityExceeded, NotPortedError
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.api.stages import _KERNEL_MODES, _score_with_kernel
from repro_torch.core import communities as comm
from repro_torch.core.device import synchronize, to_numpy
from repro_torch.core.device_index import ShardSummaries, StreamJoinStats
from repro_torch.core.encoding import encode_codes, encode_types
from repro_torch.core.pipeline import AnotherMeResult as EngineResult
from repro_torch.core.similarity import (
    PRUNE_EPS, mss_upper_bound, score_pairs, wavefront_dtype_from_env,
)
from repro_torch.core.stream_index import BucketIndex
from repro_torch.core.types import (
    PAD_ID, PAD_PLACE, CandidatePairs, EncodedBatch, ScoredPairs, TrajectoryBatch,
)

COMPONENTS_IMPLS = ("unionfind", "jit")
DELTA_JOINS = ("host", "device")

# a row with no TTL never expires on its own
NEVER_EXPIRES = np.iinfo(np.int64).max


class StreamingEngine:
    """Incremental AnotherMe over a fixed semantic forest, on one device.

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
    window: every row expires after at most ``window`` updates.
    max_resident_bytes: an update whose buffer growth would exceed this is
        refused with :class:`CapacityExceeded` before any mutation.
    compact_watermark: dead fraction at which the world is compacted.
    device: where the world table lives (None: the card; raises without one).

    Compile counters: the JAX engine counts XLA traces in ``score_traces``
    and ``join_traces`` and built runners in ``runner_builds``.  The port
    builds no per-shape program: its kernels are compiled once per process
    from source (``kernels/_build.py``), and the host join path runs no
    sharded runner, so all three stay 0, as they do in the JAX engine's
    host path; the stats keep them so the two engines' keys match.
    """

    def __init__(
        self,
        forest,
        config: EngineConfig = EngineConfig(),
        plan: ExecutionPlan = ExecutionPlan(),
        *,
        components_impl: str = "unionfind",
        world_capacity: int | None = None,
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
        if plan.delta_join == "device":
            raise NotPortedError("StreamingEngine with delta_join='device'")
        if plan.n_shards > 1:
            raise NotPortedError(f"StreamingEngine with n_shards={plan.n_shards}")
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
        self._codes_dev = None   # [cap, H, L] int32 on self.device
        self._len_dev = None     # [cap] int32 on self.device
        self.delta_join = plan.delta_join
        self._index = BucketIndex()
        # the device join's planning mirror: built as the JAX engine builds
        # it, and empty on the host join (the driver_mirror_keys stat)
        self._join_stats = StreamJoinStats(1)
        # one world shard: the serve-time REPOSE prune bounds
        self.shard_summaries = ShardSummaries(1)
        self._examined_total = 0
        self.join_traces = [0]
        self.score_traces = [0]
        self.runner_builds = 0
        # per-update host -> device transfer accounting of this port: the
        # new rows (or the whole mirror on a rebuild) and the scored pairs
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
        self._admission_check(d, places.shape[1] if d else 0)
        n_old = self.n
        with instr.phase("ingest"):
            if d:
                self._ingest(places, lengths, ttl=ttl)
                synchronize(self._codes_dev)
        with instr.phase("delta_join"):
            if d:
                lo, hi, examined = self._index.insert(keys_np, first_id=n_old)
            else:
                lo = hi = np.empty((0,), np.int32)
                examined = 0
        num_delta = int(lo.shape[0])
        num_pruned = 0
        if self.config.score_prune and num_delta:
            with instr.phase("prune"):
                lo, hi, num_pruned = self._prune_delta(lo, hi)
        with instr.phase("score"):
            if lo.shape[0]:
                s_left, s_right, s_lvl, s_mss = self._score_delta(lo, hi)
            else:
                s_left = s_right = np.empty((0,), np.int32)
                s_lvl = np.empty((0, self._H), np.int32)
                s_mss = np.empty((0,), np.float32)
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
        lengths): what ``max_resident_bytes`` bounds."""
        if self._codes_dev is None:
            return 0
        return int(self._codes_dev.numel() * 4 + self._len_dev.numel() * 4)

    def dead_fraction(self) -> float:
        """Tombstone fraction of the resident rows (the watermark input)."""
        span = self.n - self._base
        return float((span - self.live_size) / span if span else 0.0)

    def _resident_bytes_at(self, world_cap: int, world_L: int) -> int:
        """Projected resident bytes at the given capacity (admission)."""
        return world_cap * self._H * world_L * 4 + world_cap * 4

    def _admission_check(self, d: int, Lb: int) -> None:
        """Would this update's buffer growth exceed ``max_resident_bytes``?
        Mirrors ``_ingest``'s growth arithmetic and runs before any
        mutation, so a refusal leaves the world unchanged."""
        if self.max_resident_bytes is None or not d:
            return
        new_cap = self.planner.grow_capacity(
            max(self._cap, self._cap_floor), self.n - self._base + d
        )
        projected = self._resident_bytes_at(new_cap, max(self.L, Lb))
        if projected > self.max_resident_bytes:
            raise CapacityExceeded(
                f"ingesting {d} rows needs {projected} resident bytes, over "
                f"the max_resident_bytes budget of {self.max_resident_bytes}; "
                "the update was refused and the world is unchanged — "
                "retire rows, raise the budget, or shrink the batch",
                needed_bytes=projected,
                budget_bytes=self.max_resident_bytes,
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
        PREFIX rebase: global ids stay, the device sees local ids) and the
        world table rolls by ``(arange + shift) % cap``."""
        t0 = time.perf_counter()
        base = self._base
        span = self.n - base
        live_idx = np.nonzero(self._alive_np[:span])[0]
        shift = int(live_idx[0]) if live_idx.size else span
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
            if self._labels.shape[0] > shift:
                self._labels = self._labels[shift:] - shift
            else:
                self._labels = np.empty((0,), np.int32)
            self._uf.reset_from_labels(self._labels)
        self._base = base + shift
        self.compactions += 1
        self.compact_ms_total += (time.perf_counter() - t0) * 1e3

    # -- ingestion: world growth + device-resident appends -------------------

    def _ingest(self, places: np.ndarray, lengths: np.ndarray,
                *, ttl: int | None = None) -> None:
        d, Lb = places.shape
        new_L = max(self.L, Lb)
        span = self.n - self._base  # resident rows (live + tombstoned)
        new_cap = self.planner.grow_capacity(
            max(self._cap, self._cap_floor), span + d
        )
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
        # only the new rows go to the device, unless the table was rebuilt;
        # torch.tensor copies, so the device table never aliases the mirror
        if rebuild or self._codes_dev is None:
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
