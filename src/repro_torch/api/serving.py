"""Online top-k "find another me" serving over the resident world.

    from repro_torch.api import QueryEngine, StreamingEngine

    stream = StreamingEngine(forest, config)
    for batch in feed:
        stream.update(batch)
    serve = QueryEngine(stream, k=5)
    res = serve.query(query_batch)       # QueryResult
    res.match_ids[q], res.mss[q]         # top-k world rows per query

Port of ``repro/api/serving.py`` over a single-device
:class:`~repro_torch.api.streaming.StreamingEngine`, on either of its joins:

* queries are NOT ingested: the index is probed read-only and the world is
  untouched, so queries commute with ``StreamingEngine.update`` calls.  On
  the host join the probe is ``BucketIndex.probe``; on the device join
  (``delta_join="device"``) it is :func:`make_query_probe_pipeline` —
  :func:`~repro_torch.core.device_index.probe_rows` against the resident
  slab, then a dedup of the (row, query) candidates — and the candidate list
  is born on the device and stays there (``_SlabProber``);
* a query micro-batch runs one score function at pow2-sticky capacities
  (:class:`QueryPlan`, planned by ``CapacityPlanner.plan_query`` from the
  exact candidate count, or on the device join from the ``StreamJoinStats``
  count mirror);
* candidates score off the resident world through the engine's ``lcs_impl``
  dispatch: under ``"fused"`` the fused kernel #1 takes the query codes as
  table A and the world as table B (two tables, so its identity shortcut
  never fires), under ``"kernel"`` the batched LCS kernel #2; the device
  join's world is its places slab, encoded in the score function; then a
  segmented per-query top-k — sort by (query, -mss, row), rank within each
  query's run, scatter to ``[Q, k]`` — leaves only ``[Q, k]`` ids and
  scores to read;
* matches require ``mss > rho`` (per query), are ordered by (mss
  descending, row id ascending), and empty slots hold ``(PAD_ID, -1.0)``;
* with ``serve_prune=True`` the REPOSE-style rounds skip every (query,
  shard) cell whose free MSS bound ``betas_sum * min(len_q, max_len)``
  cannot beat the query's ``rho`` or its running kth-best; results are
  identical either way.  One device holds one world shard.

Every result equals the JAX ``QueryEngine``'s (ids equal, float32 ``mss``
bit-equal).  The programs' collectives (the key route's ``all_to_all``, the
``all_gather`` of the world and of the per-shard top-k) are identities at
one shard; more shards raise :class:`NotPortedError`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.errors import CapacityExceeded
from repro_torch.api.sharded import (
    _one_shard, _positive_hash, _positive_hash_np, _pow2, _route,
)
from repro_torch.core.device import to_numpy
from repro_torch.core.device_index import _sort2, flat_row_keys, probe_rows
from repro_torch.core.encoding import encode_codes
from repro_torch.core.similarity import (
    PRUNE_EPS, mss_scores, mss_upper_bound, multi_level_lcs,
)
from repro_torch.core.types import PAD_ID, PAD_KEY, PAD_PLACE

# Empty top-k slots hold (PAD_ID, NO_MATCH_MSS): PAD_ID is never the id of
# a world row and -1.0 is below any real MSS.
NO_MATCH_MSS = np.float32(-1.0)


# ---------------------------------------------------------------------------
# capacity planning (pow2-sticky)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Static shapes of one query micro-batch's score function.

    Shapes quantize to powers of two and the engine keeps them sticky
    (monotone max while the world shape holds), as the JAX package does to
    reuse its compiled programs.
    """

    n_shards: int
    cap_local: int      # resident world rows per shard (world cap if 1)
    L_pad: int          # scoring width: max(world L, longest query)
    q_cap: int          # padded queries per micro-batch
    k_cap: int          # padded top-k slots per query
    cand_cap: int       # candidate (row, query) slots per shard
    key_in_cap: int = 0     # query key occurrences per source shard
    key_route_cap: int = 0  # rows per (src, dst) bucket in the key route


def plan_query_capacities(
    num_queries: int,
    k_max: int,
    *,
    n_shards: int,
    cap_local: int,
    world_L: int,
    q_len_max: int,
    cand_total: int | None = None,
    keys_flat: np.ndarray | None = None,
    stats=None,
    floor_pow2: int = 2,
) -> QueryPlan:
    """Exact capacity plan for ONE query micro-batch.

    * host (``cand_total``): the BucketIndex probe already ran, so the
      candidate count is exact; buffers hold contiguous per-shard chunks;
    * device (``keys_flat`` + ``stats``): the exact per-owner match counts
      of the query keys from the device join's ``StreamJoinStats`` mirror,
      under its hash (new-vs-old only: queries never pair with each
      other), sizing the key route and the probe output.
    """
    q_cap = _pow2(num_queries, floor_pow2)
    k_cap = _pow2(max(k_max, 1), floor_pow2)
    L_pad = max(int(world_L), int(q_len_max), 1)
    if cand_total is not None:
        chunk = -(-int(cand_total) // n_shards) if cand_total else 0
        return QueryPlan(
            n_shards=n_shards, cap_local=cap_local, L_pad=L_pad,
            q_cap=q_cap, k_cap=k_cap,
            cand_cap=_pow2(chunk, floor_pow2),
        )
    k = int(keys_flat.shape[0])
    owners = _positive_hash_np(keys_flat) % n_shards if k else \
        np.zeros((0,), np.int64)
    nvo, _, _ = stats.plan_update(keys_flat, owners)
    chunk = -(-k // n_shards) if k else 0
    if k:
        src = np.arange(k, dtype=np.int64) // max(chunk, 1)
        load = np.zeros((n_shards, n_shards), np.int64)
        np.add.at(load, (src, owners), 1)
        route_need = int(load.max())
    else:
        route_need = 1
    return QueryPlan(
        n_shards=n_shards, cap_local=cap_local, L_pad=L_pad,
        q_cap=q_cap, k_cap=k_cap,
        cand_cap=_pow2(int(nvo.max()), floor_pow2),
        key_in_cap=_pow2(chunk, floor_pow2),
        key_route_cap=_pow2(route_need, floor_pow2),
    )


def sticky_query_plan(plan: QueryPlan, prev: QueryPlan | None) -> QueryPlan:
    """Monotone max over every capacity while the world shape holds; a
    world reshape (``cap_local`` moved) resets the sticky state."""
    if prev is None or prev.n_shards != plan.n_shards \
            or prev.cap_local != plan.cap_local:
        return plan
    return QueryPlan(
        n_shards=plan.n_shards, cap_local=plan.cap_local,
        L_pad=max(plan.L_pad, prev.L_pad),
        q_cap=max(plan.q_cap, prev.q_cap),
        k_cap=max(plan.k_cap, prev.k_cap),
        cand_cap=max(plan.cand_cap, prev.cand_cap),
        key_in_cap=max(plan.key_in_cap, prev.key_in_cap),
        key_route_cap=max(plan.key_route_cap, prev.key_route_cap),
    )


# ---------------------------------------------------------------------------
# segmented top-k (the [Q, k] reduction)
# ---------------------------------------------------------------------------
def _sort_by(keys, dim=-1):
    """Indices that sort by several keys, the first most significant: stable
    sorts from the last key to the first (torch has no multi-key sort, and
    ``jax.lax.sort(num_keys=...)`` is this lexicographic order)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else torch.gather(key, dim, order)
        step = torch.sort(k, dim=dim, stable=True).indices
        order = step if order is None else torch.gather(order, dim, step)
    return order


def _local_topk(qid, row, mss, *, q_cap, k_cap, rho_vec):
    """Segmented per-query top-k over one device's scored candidates.

    Sort by (query, -mss, row): each query's candidates become a run, best
    first, ties broken toward the smaller row id.  Adjacent duplicate
    (query, row) slots — the same candidate probed through several keys,
    scored to the identical mss — are dropped, the survivors ranked within
    their run, and the first ``k_cap`` scattered into a ``[q_cap, k_cap]``
    table.  Scores are carried NEGATED (``+inf`` = empty slot).
    """
    qsafe = qid.clamp(0, q_cap - 1).long()
    valid = (row != PAD_ID) & (mss > rho_vec[qsafe])
    qk = torch.where(valid, qid, q_cap).to(torch.int32)
    neg = torch.where(valid, -mss, torch.inf).to(torch.float32)
    rk = torch.where(valid, row, PAD_ID).to(torch.int32)
    order = _sort_by((qk, neg, rk))
    qs, ns, rs = qk[order], neg[order], rk[order]
    first = torch.ones((1,), dtype=torch.bool, device=qs.device)
    dup = torch.cat([~first, (qs[1:] == qs[:-1]) & (rs[1:] == rs[:-1]) & (qs[1:] < q_cap)])
    nd = (~dup) & (qs < q_cap)
    idx = torch.arange(qs.shape[0], dtype=torch.int64, device=qs.device)
    start = torch.cat([first, qs[1:] != qs[:-1]])
    run_start = torch.cummax(torch.where(start, idx, 0), dim=0).values
    c = torch.cumsum(nd.to(torch.int64), dim=0)
    base = torch.where(run_start > 0, c[(run_start - 1).clamp(min=0)], 0)
    rank = c - base - 1  # rank among this run's distinct survivors
    keep = nd & (rank < k_cap)
    # slot q_cap * k_cap collects every dropped entry (the JAX scatter's
    # mode="drop") and is cut off
    flat = torch.where(keep, qs.long() * k_cap + rank, q_cap * k_cap)
    top_row = torch.full((q_cap * k_cap + 1,), PAD_ID, dtype=torch.int32,
                         device=qs.device).scatter_(0, flat, rs)
    top_neg = torch.full((q_cap * k_cap + 1,), torch.inf, dtype=torch.float32,
                         device=qs.device).scatter_(0, flat, ns)
    return top_row[:-1].reshape(q_cap, k_cap), top_neg[:-1].reshape(q_cap, k_cap)


def _merge_topk(rows2d, negs2d, *, k_cap):
    """Merge per-query top-k columns from several sources: sort each
    query's row by (negated mss, row id), drop adjacent duplicate rows (the
    same candidate from two sources carries a bit-identical score), sort
    the gaps to the end, keep the best ``k_cap``."""
    valid = rows2d != PAD_ID
    neg = torch.where(valid, negs2d, torch.inf)
    rows = torch.where(valid, rows2d, PAD_ID)
    order = _sort_by((neg, rows), dim=1)
    ns, rs = torch.gather(neg, 1, order), torch.gather(rows, 1, order)
    dup = torch.cat([
        torch.zeros_like(rs[:, :1], dtype=torch.bool),
        (rs[:, 1:] == rs[:, :-1]) & (rs[:, 1:] != PAD_ID),
    ], dim=1)
    ns = torch.where(dup, torch.inf, ns)
    rs = torch.where(dup, PAD_ID, rs)
    order = _sort_by((ns, rs), dim=1)
    ns, rs = torch.gather(ns, 1, order), torch.gather(rs, 1, order)
    return rs[:, :k_cap], ns[:, :k_cap]


def _serve_score_block(
    codes_all, w_len, cand_row, cand_qid, q_places, rho_vec, active,
    tables, *, plan, betas, fused_mode, impl,
):
    """Encode the queries, gate candidates by the round's (query, shard)
    prune mask, score them off the resident table, and reduce to the
    [q_cap, k_cap] top-k.  ``cand_row`` holds local world slots."""
    if codes_all.shape[-1] < plan.L_pad:
        # -1 stays a non-matching sentinel column
        codes_all = torch.nn.functional.pad(
            codes_all, (0, plan.L_pad - codes_all.shape[-1]), value=-1
        )
    q_codes = encode_codes(q_places, tables)  # [q_cap, H, L_pad]
    q_len = (q_codes[:, 0, :] >= 0).sum(dim=-1).to(torch.int32)
    valid = cand_row != PAD_ID
    qsafe = cand_qid.clamp(0, plan.q_cap - 1)
    shard = torch.where(valid, cand_row % plan.n_shards, 0)
    row = torch.where(valid & active[qsafe.long(), shard.long()], cand_row, PAD_ID)
    alive = row != PAD_ID
    ri = torch.where(alive, row, 0)
    if fused_mode is not None:
        from repro_torch.kernels.lcs.fused import fused_score

        _, mss = fused_score(
            q_codes, q_len, codes_all, w_len, qsafe, ri, betas, mode=fused_mode,
        )
    else:
        qi, wi = qsafe.long(), ri.long()
        lvl = multi_level_lcs(q_codes[qi], q_len[qi], codes_all[wi], w_len[wi], impl=impl)
        mss = mss_scores(lvl, betas)
    mss = mss.masked_fill(~alive, float(NO_MATCH_MSS))
    return _local_topk(
        cand_qid, row, mss, q_cap=plan.q_cap, k_cap=plan.k_cap, rho_vec=rho_vec,
    )


# ---------------------------------------------------------------------------
# the score function and the probe programs
# ---------------------------------------------------------------------------
def make_query_score_pipeline(
    plan: QueryPlan,
    *,
    betas,
    places_world: bool = False,
    lcs_impl: str = "wavefront",
    trace_counter: list | None = None,
):
    """The query score + top-k function over one device's world.

    ``places_world=False`` (the host join's world)::

      fn(codes [cap, H, Lw], w_len [cap], cand_row [cand_cap] (local world
         slots), cand_qid [cand_cap], q_places [q_cap, L_pad],
         rho_vec [q_cap] f32, active [q_cap, 1] bool,
         prev_row/prev_neg [q_cap, k_cap] (the carried top-k state), tables)
        -> dict: top_row / top_neg [q_cap, k_cap] (merged with prev)

    ``places_world=True`` (the device join's world, the JAX package's mesh
    form at one shard) takes the places slab ``places [cap_local, Lw]`` in
    place of ``codes`` and ``w_len``: it is encoded here, its lengths come
    from the sentinels, and the per-shard top-k is merged with ``prev``.

    ``trace_counter`` counts the functions built (one per plan), where the
    JAX package counts the traces of its compiled program.
    """
    from repro_torch.api.stages import FUSED_MODES, lcs_impl_fn

    _one_shard(plan.n_shards, "make_query_score_pipeline")
    fused_mode = FUSED_MODES.get(lcs_impl)
    impl = None if fused_mode is not None else lcs_impl_fn(lcs_impl)
    if trace_counter is not None:
        trace_counter[0] += 1

    def run_single(codes, w_len, cand_row, cand_qid, q_places, rho_vec,
                   active, prev_row, prev_neg, tables):
        t_row, t_neg = _serve_score_block(
            codes, w_len, cand_row, cand_qid, q_places, rho_vec, active,
            tables, plan=plan, betas=betas, fused_mode=fused_mode, impl=impl,
        )
        m_row, m_neg = _merge_topk(
            torch.cat([t_row, prev_row], dim=1),
            torch.cat([t_neg, prev_neg], dim=1), k_cap=plan.k_cap,
        )
        return {"top_row": m_row, "top_neg": m_neg}

    if not places_world:
        return run_single

    def run_places(places, cand_row, cand_qid, q_places, rho_vec, active,
                   prev_row, prev_neg, tables):
        # encode the slab here (the all_gather of the encodings: identity);
        # at one shard the round-robin slot of row g is g
        codes = encode_codes(places, tables)
        w_len = (codes[:, 0, :] >= 0).sum(dim=-1).to(torch.int32)
        return run_single(codes, w_len, cand_row, cand_qid, q_places, rho_vec,
                          active, prev_row, prev_neg, tables)

    return run_places


def make_query_probe_pipeline(plan: QueryPlan, *, trace_counter: list | None = None):
    """The read-only candidate probe of the device join's slab::

      fn(slab_keys [slab_cap], slab_rows, keys [key_in_cap], qids)
        -> dict: cand_row / cand_qid [1, cand_cap], count [1],
                 examined [1], overflow [1]

    The join function's route and probe stages with everything mutable
    removed: query key occurrences route to their owner shard (identity at
    one shard), :func:`probe_rows` range-probes the slab, and the (world
    row, query) candidates are deduped (a sort by (row, query): copies
    found through several shared keys sort adjacent).
    """
    _one_shard(plan.n_shards, "make_query_probe_pipeline")
    if trace_counter is not None:
        trace_counter[0] += 1
    n_shards = plan.n_shards

    def run(slab_keys, slab_rows, keys, qids):
        (rk, rq), o1 = _route(
            (keys, qids), _positive_hash(keys) % n_shards, keys != PAD_KEY,
            n_shards=n_shards, capacity=plan.key_route_cap, pads=(PAD_KEY, PAD_ID),
        )
        row, qid, examined, o2 = probe_rows(slab_keys, slab_rows, rk, rq,
                                            cap=plan.cand_cap)
        row_s, qid_s = _sort2(row, qid)
        dup = torch.zeros_like(row_s, dtype=torch.bool)
        dup[1:] = (row_s[1:] == row_s[:-1]) & (qid_s[1:] == qid_s[:-1]) & (row_s[1:] != PAD_ID)
        row_d = row_s.masked_fill(dup, PAD_ID)
        qid_d = qid_s.masked_fill(dup, PAD_ID)
        count = (row_d != PAD_ID).sum().to(torch.int32)
        return {
            "cand_row": row_d.reshape(n_shards, -1), "cand_qid": qid_d.reshape(n_shards, -1),
            "count": count.reshape(n_shards), "examined": examined.reshape(n_shards),
            "overflow": (o1 + o2).to(torch.int32).reshape(n_shards),
        }

    return run


# ---------------------------------------------------------------------------
# the read-only probe protocol adapters
# ---------------------------------------------------------------------------
class _HostProber:
    """Candidate probe against the host ``BucketIndex``."""

    def __init__(self, engine: "QueryEngine"):
        self.engine = engine

    def prepare(self, keys_np, k_flat, q_flat):
        qidx, rows, examined = self.engine.stream._index.probe(keys_np)
        return {
            "qidx": qidx, "rows": rows, "examined": int(examined),
            "plan_kwargs": {"cand_total": int(qidx.shape[0])},
        }

    def finish(self, pre, qplan: QueryPlan):
        e = self.engine
        S, cap = qplan.n_shards, qplan.cand_cap
        qidx, rows = pre["qidx"], pre["rows"]
        # the BucketIndex speaks global ids and the table local slots
        # (slot = id - base); query() adds the base back to the results
        rows = rows - np.int32(e.stream._base)
        total = int(qidx.shape[0])
        buf_r = np.full((S, cap), PAD_ID, np.int32)
        buf_q = np.full((S, cap), PAD_ID, np.int32)
        chunk = -(-total // S) if total else 0
        for s in range(S):
            seg = slice(s * chunk, (s + 1) * chunk)
            buf_r[s, : rows[seg].shape[0]] = rows[seg]
            buf_q[s, : qidx[seg].shape[0]] = qidx[seg]
        e._xfer_bytes += buf_r.nbytes + buf_q.nbytes
        stats = {"candidates": total, "probe_examined": pre["examined"]}
        dev = e.stream.device
        return (torch.tensor(buf_r.reshape(-1), device=dev),
                torch.tensor(buf_q.reshape(-1), device=dev), qplan, stats)


class _SlabProber:
    """Candidate probe against the device join's resident slab: only the
    query key occurrences cross from the host; the candidate list is born on
    the device and rests in the buffers the score function reads."""

    def __init__(self, engine: "QueryEngine"):
        self.engine = engine

    def prepare(self, keys_np, k_flat, q_flat):
        return {
            "k_flat": k_flat, "q_flat": q_flat,
            "plan_kwargs": {"keys_flat": k_flat, "stats": self.engine.stream._join_stats},
        }

    def finish(self, pre, qplan: QueryPlan):
        e = self.engine
        stream = e.stream
        k_flat, q_flat = pre["k_flat"], pre["q_flat"]
        out = None
        for _ in range(e.planner.max_retries + 1):
            in_k = np.full((qplan.key_in_cap,), PAD_KEY, np.int32)
            in_q = np.full((qplan.key_in_cap,), PAD_ID, np.int32)
            in_k[: k_flat.shape[0]] = k_flat
            in_q[: q_flat.shape[0]] = q_flat
            e._xfer_bytes += in_k.nbytes + in_q.nbytes
            out = e._probe_runner(qplan)(
                stream._slab_keys, stream._slab_rows,
                torch.tensor(in_k, device=stream.device),
                torch.tensor(in_q, device=stream.device),
            )
            if int(out["overflow"].sum()) == 0:
                break
            # exact planning makes this unreachable
            qplan = dataclasses.replace(qplan, cand_cap=qplan.cand_cap * 2,
                                        key_route_cap=qplan.key_route_cap * 2)
        if int(out["overflow"].sum()):
            # a truncated candidate list would silently drop matches
            raise CapacityExceeded(
                "query probe still overflowed after "
                f"{e.planner.max_retries} retries (per-shard overflow "
                f"{to_numpy(out['overflow']).tolist()}); refusing to "
                "serve a truncated candidate set"
            )
        stats = {"candidates": int(out["count"].sum()),
                 "probe_examined": int(out["examined"].sum())}
        return out["cand_row"].reshape(-1), out["cand_qid"].reshape(-1), qplan, stats


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Per-query top-k matches against the resident world.

    match_ids: int32 [Q, k_max] world row ids, best first (mss descending,
        row id ascending), ``PAD_ID`` in empty slots.
    mss: float32 [Q, k_max] matching scores, ``-1.0`` in empty slots.
    stats: one dict of serving counters for this micro-batch.
    """

    match_ids: np.ndarray
    mss: np.ndarray
    stats: dict


class QueryEngine:
    """Top-k query serving over a :class:`StreamingEngine`'s world.

    Built FROM the streaming engine, never owning its state: every
    ``query`` reads the world as it stands (queries interleave freely with
    ``update`` calls) and mutates nothing.

    k: default result count (per-query override via ``query(k=...)``).
    serve_prune: the REPOSE-style pruning rounds (module docstring);
        results are identical either way.

    Counters: ``serve_traces`` and ``probe_traces`` count the score and probe
    functions built (one per new sticky plan; the JAX package counts its
    programs' traces there), ``runner_builds`` both; the host probe builds
    nothing.
    """

    def __init__(self, stream, *, k: int = 10, serve_prune: bool = False):
        self.stream = stream
        self.default_k = int(k)
        self.serve_prune = bool(serve_prune)
        self.planner = stream.planner
        self.betas = stream.betas
        self.config = stream.config
        self.plan = stream.plan
        self.serve_traces = [0]
        self.probe_traces = [0]
        self.runner_builds = 0
        self.queries_served = 0
        self._qplan: QueryPlan | None = None
        self._compactions_seen = stream.compactions
        self._runner_cache: dict = {}
        self._probe_cache: dict = {}
        self._xfer_bytes = 0
        # the probe adapters share prepare()/finish(), so query() never
        # branches on the world's index form
        self._prober = (_SlabProber(self) if stream.delta_join == "device"
                        else _HostProber(self))

    # -- public entry point --------------------------------------------------

    def query(self, batch, *, k=None, rho=None) -> QueryResult:
        """Top-k matches for one micro-batch of query trajectories.

        batch: a :class:`TrajectoryBatch` (or anything with ``places``
            [Q, L] and ``lengths`` [Q]).
        k: result count, an int for all queries or a [Q] array.
        rho: similarity threshold (matches require ``mss > rho``), a float
            for all queries or a [Q] array; defaults to ``config.rho``.
        """
        places = to_numpy(batch.places).astype(np.int32, copy=False)
        if places.ndim != 2:
            places = places.reshape((places.shape[0], -1) if places.size
                                    else (0, 1))
        lengths = to_numpy(batch.lengths).astype(np.int32, copy=False).reshape(-1)
        Q = places.shape[0]
        k_vec = np.broadcast_to(
            np.asarray(self.default_k if k is None else k, np.int32), (Q,)
        ).copy()
        k_vec = np.maximum(k_vec, 0)
        rho_vec = np.broadcast_to(np.asarray(
            self.config.rho if rho is None else rho, np.float32), (Q,)
        ).copy()
        k_max = int(k_vec.max()) if Q else 0
        self._xfer_bytes = 0
        # the sticky plan may shrink ONLY at a compaction boundary
        if self.stream.compactions != self._compactions_seen:
            self._qplan = None
            self._compactions_seen = self.stream.compactions
        stats = {
            "queries": Q, "world_size": self.stream.n,
            "world_live": self.stream.live_size, "candidates": 0,
            "probe_examined": 0, "rounds_run": 0, "rounds_skipped": 0,
            "cells_skipped": 0,
        }

        def empty():
            return self._finish_result(
                np.full((Q, k_max), PAD_ID, np.int32),
                np.full((Q, k_max), NO_MATCH_MSS, np.float32),
                k_vec, k_max, stats,
            )

        if Q == 0 or self.stream.n == 0:
            return empty()
        keys_np = self.stream._new_row_keys(places, lengths)
        k_flat, q_flat = flat_row_keys(keys_np)
        if k_flat.size == 0:
            return empty()
        pre = self._prober.prepare(keys_np, k_flat, q_flat)
        S = 1  # one device holds one world shard
        qplan = sticky_query_plan(
            self.planner.plan_query(
                Q, k_max, n_shards=S, cap_local=self.stream._cap // S,
                world_L=self.stream.L,
                q_len_max=int(lengths.max()),
                **pre["plan_kwargs"],
            ),
            self._qplan,
        )
        cand_row, cand_qid, qplan, probe_stats = self._prober.finish(pre, qplan)
        self._qplan = qplan
        stats.update(probe_stats)
        if stats["candidates"] == 0:
            return empty()
        top_row, top_neg = self._run_rounds(
            qplan, cand_row, cand_qid, places, lengths, k_vec, rho_vec, stats,
        )
        ids = to_numpy(top_row)[:Q, :k_max]
        neg = to_numpy(top_neg)[:Q, :k_max]
        mss = np.where(ids != PAD_ID, -neg, NO_MATCH_MSS).astype(np.float32)
        # the table speaks local slots; matches surface as global ids
        ids = np.where(ids != PAD_ID, ids + np.int32(self.stream._base), PAD_ID)
        return self._finish_result(ids.astype(np.int32), mss, k_vec, k_max, stats)

    # -- internals -----------------------------------------------------------

    def _finish_result(self, ids, mss, k_vec, k_max, stats):
        if k_max:
            cols = np.arange(k_max, dtype=np.int32)[None, :]
            drop = cols >= k_vec[:, None]
            ids = np.where(drop, PAD_ID, ids)
            mss = np.where(drop, NO_MATCH_MSS, mss).astype(np.float32)
        self.queries_served += int(stats["queries"])
        stats.update(
            serve_traces=self.serve_traces[0],
            probe_traces=self.probe_traces[0],
            runner_builds=self.runner_builds,
            driver_bytes_in=self._xfer_bytes,
        )
        return QueryResult(match_ids=ids, mss=mss, stats=dict(stats))

    def _run_rounds(self, qplan, cand_row, cand_qid, places, lengths,
                    k_vec, rho_vec, stats):
        """Run the score function once (no pruning) or once per surviving
        world shard (REPOSE rounds), carrying the [q_cap, k_cap] top-k."""
        dev = self.stream.device
        Q = places.shape[0]
        S = qplan.n_shards
        q_places = np.full((qplan.q_cap, qplan.L_pad), PAD_PLACE, np.int32)
        w = min(places.shape[1], qplan.L_pad)
        q_places[:Q, :w] = places[:, :w]
        # positions past each query's length must be PAD_PLACE: the score
        # function derives query lengths from it
        cols = np.arange(qplan.L_pad, dtype=np.int32)[None, :]
        q_places[:Q] = np.where(cols < lengths[:, None], q_places[:Q], PAD_PLACE)
        rho_pad = np.full((qplan.q_cap,), np.inf, np.float32)
        rho_pad[:Q] = rho_vec
        self._xfer_bytes += q_places.nbytes + rho_pad.nbytes
        q_places_dev = torch.tensor(q_places, device=dev)
        rho_dev = torch.tensor(rho_pad, device=dev)
        prev_row = torch.full((qplan.q_cap, qplan.k_cap), PAD_ID, dtype=torch.int32, device=dev)
        prev_neg = torch.full((qplan.q_cap, qplan.k_cap), torch.inf, dtype=torch.float32,
                              device=dev)
        runner = self._score_runner(qplan)
        world = self._world_args()

        def run_round(active_np, prow, pneg):
            self._xfer_bytes += active_np.nbytes
            out = runner(*world, cand_row, cand_qid, q_places_dev, rho_dev,
                         torch.tensor(active_np, device=dev), prow, pneg,
                         self.stream.tables)
            stats["rounds_run"] += 1
            return out["top_row"], out["top_neg"]

        if not self.serve_prune:
            return run_round(np.ones((qplan.q_cap, S), bool), prev_row, prev_neg)
        # REPOSE rounds: shards in descending resident-length order; a
        # (query, shard) cell is skipped when its free MSS bound cannot
        # beat rho or, once k matches exist, the running kth-best (both
        # with PRUNE_EPS on the KEEP side)
        summ = self.stream.shard_summaries
        bsum = float(to_numpy(self.betas).astype(np.float32).sum())
        ub = mss_upper_bound(
            np.minimum(lengths, qplan.L_pad)[:, None],
            np.broadcast_to(summ.max_len[None, :], (Q, S)), bsum,
        )  # f32 [Q, S]
        order = np.argsort(-summ.max_len, kind="stable")
        kth = np.full((Q,), -np.inf, np.float32)
        have_k = k_vec == 0
        kth[have_k] = np.inf
        row_state, neg_state = prev_row, prev_neg
        for pos, s in enumerate(order.tolist()):
            act = ub[:, s] > rho_vec - PRUNE_EPS
            act &= ~have_k | (ub[:, s] > kth - PRUNE_EPS)
            if not act.any():
                # ub is monotone in the shard's max_len and kth only grows,
                # so every remaining shard is skippable too
                stats["rounds_skipped"] += len(order) - pos
                stats["cells_skipped"] += (len(order) - pos) * Q
                break
            stats["cells_skipped"] += int(Q - act.sum())
            active = np.zeros((qplan.q_cap, S), bool)
            active[:Q, s] = act
            row_state, neg_state = run_round(active, row_state, neg_state)
            mss_state = -to_numpy(neg_state)[:Q]  # sorted best-first
            counts = (to_numpy(row_state)[:Q] != PAD_ID).sum(axis=1)
            have_k = (counts >= np.maximum(k_vec, 1)) | (k_vec == 0)
            idx = np.clip(np.maximum(k_vec, 1) - 1, 0, qplan.k_cap - 1)
            kth = np.where(have_k, mss_state[np.arange(Q), idx], -np.inf).astype(np.float32)
            kth[k_vec == 0] = np.inf
        return row_state, neg_state

    def _world_args(self):
        stream = self.stream
        if stream._mesh_world:
            return (stream._places_dev,)
        return (stream._codes_dev, stream._len_dev)

    def _score_runner(self, qplan: QueryPlan):
        key = (qplan, self.config.lcs_impl, self.stream._H)
        runner = self._runner_cache.get(key)
        if runner is None:
            runner = make_query_score_pipeline(
                qplan, betas=self.betas, places_world=self.stream._mesh_world,
                lcs_impl=self.config.lcs_impl, trace_counter=self.serve_traces,
            )
            self._runner_cache[key] = runner
            self.runner_builds += 1
        return runner

    def _probe_runner(self, qplan: QueryPlan):
        runner = self._probe_cache.get(qplan)
        if runner is None:
            runner = make_query_probe_pipeline(qplan, trace_counter=self.probe_traces)
            self._probe_cache[qplan] = runner
            self.runner_builds += 1
        return runner
