"""Sharded AnotherMe: the Spark shuffle mapped onto mesh collectives.

Port of ``repro/api/sharded.py``.  Every Spark stage of the paper's Fig. 5
has its counterpart on a :class:`~repro_torch.core.compat.ShardMesh`, one
torch device per shard, driven by one process:

  Spark executors            -> the shards of a flat "ex" mesh
  semantic encoding (D2->D3) -> each shard encodes its OWN rows through the
                                replicated forest tables
  hash-shuffle on shingle    -> ``mesh.all_to_all`` of fixed-capacity
    (D4 repartition)            buckets routed by hash(join key) % n_shards
  local sort-merge join      -> ``ssh.pairs_from_rows`` on received rows
  shuffle pairs for dedup    -> a second all_to_all routed by hash(lo, hi),
                                so every pair is scored on exactly ONE shard
  executor-local scoring     -> the batched LCS on local pairs, through the
                                same ``lcs_impl`` selection as the
                                single-device path (the fused scorers #1/#3,
                                the batched LCS kernel #2, or plain code)

Every program runs as bulk-synchronous phases: a loop over the shards between
collectives.  Capacities are planned on the host from exact cardinalities
(numpy, with the device's own int32 hashes), and every stage counts its
overflow, so a capacity bust is detected, never silent.

  * :func:`make_sharded_pipeline` (planned by :func:`plan_capacities`): the
    one-shot encode, join and score;
  * :class:`StreamJoinPlan`, :func:`plan_stream_join` and
    :func:`sticky_join_plan`: the exact per-owner capacity plan of one
    streaming update's join, from the ``StreamJoinStats`` count mirror;
  * :func:`make_streaming_join_pipeline`: route the new rows' keys to their
    owner's slab, probe it for the delta pairs, route and dedup them by pair
    hash, merge the keys in;
  * :class:`StreamShardPlan`, :func:`plan_stream_capacities` and
    :func:`make_streaming_score_pipeline`: encode each shard's block of the
    places slab, prune and score the delta pairs, in place against the
    gathered world (``"replicate"``) or at rest after the owner hops
    (``"shuffle"``).

The streaming world is laid out round-robin, as the JAX package's: row g on
shard ``g % n`` at local slot ``g // n``, physical row
``(g % n) * cap_local + g // n``.  Each streaming builder returns a plain
function and counts its builds in ``trace_counter``, where the JAX package
counts the traces of its compiled program: one per distinct plan in both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device import to_numpy
from repro_torch.core.device_index import merge_insert, probe_pairs
from repro_torch.core.encoding import encode_codes
from repro_torch.core.shingling import shingles_from_types
from repro_torch.core.similarity import (
    PRUNE_EPS, gather_windows, mss_scores, mss_upper_bound, multi_level_lcs,
)
from repro_torch.core.ssh import _runs, dedup_pairs, pairs_from_rows, saturate_int32
from repro_torch.core.types import PAD_ID, PAD_KEY

_MIX = np.int32(np.uint32(2654435761 % (1 << 31)))  # Knuth multiplicative mix


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement (still int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _positive_hash(x: torch.Tensor) -> torch.Tensor:
    """The key-to-shard hash on int32 tensors: ``abs((x * MIX) ^ (x >> 13))``
    with int32 wraparound, so ``abs(INT32_MIN)`` stays negative, as in the
    reference and its numpy twin.  Computed in int64 and wrapped, because
    signed overflow in a torch kernel is not defined to wrap."""
    x = x.to(torch.int64)
    h = _wrap32(x * int(_MIX)) ^ (x >> 13)
    return _wrap32(h.abs()).to(torch.int32)


def _pair_hash(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``abs(hash(lo) * 92821 + hash(hi))`` with int32 wraparound."""
    h = _positive_hash(lo).to(torch.int64) * 92821 + _positive_hash(hi).to(torch.int64)
    return _wrap32(_wrap32(h).abs()).to(torch.int32)


def _positive_hash_np(x: np.ndarray) -> np.ndarray:
    """The JAX package's key-to-shard hash with exact int32 wraparound, so
    capacity planning sees the shard destinations the device join would."""
    x = np.asarray(x).astype(np.int32)
    with np.errstate(over="ignore"):
        h = (x * _MIX) ^ (x >> 13)
    return np.abs(h)


def _pair_hash_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host replica of :func:`_pair_hash` with exact int32 wraparound."""
    with np.errstate(over="ignore"):
        h = _positive_hash_np(lo) * np.int32(92821) + _positive_hash_np(hi)
    return np.abs(h)


def _pow2(x: int, floor_pow2: int = 4) -> int:
    """The smallest power of two >= ``x`` and >= ``2**floor_pow2``."""
    return 1 << max(floor_pow2, int(np.ceil(np.log2(max(int(x), 1)))))


def _scatter(values: tuple, dest: torch.Tensor, valid: torch.Tensor, *, n_shards: int,
             capacity: int, pads: tuple):
    """One shard's half of a route: scatter rows into ``[n_shards, capacity]``
    buckets by destination.

    values: int32 [R] or [R, W] tensors routed together; pads: the pad value
    of each.  The rows of each destination keep their order (a stable sort
    on the destination), rows past ``capacity`` are counted in the overflow.
    Returns (tuple of flat [n_shards * capacity(, W)] buffers, overflow);
    :func:`_route` hands the buffers to the mesh's ``all_to_all``.
    """
    dest = torch.where(valid, dest, n_shards)  # n_shards = the drop bucket
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    rank, _ = _runs(torch.where(dest_s == n_shards, PAD_KEY, dest_s).to(torch.int32))
    ok = (dest_s < n_shards) & (rank < capacity)
    # slot n_shards * capacity collects the dropped rows and is cut off
    slot = torch.where(ok, dest_s.long() * capacity + rank, n_shards * capacity)
    overflow = ((dest_s < n_shards) & (rank >= capacity)).sum().to(torch.int32)
    outs = []
    for v, pad in zip(values, pads):
        buf = torch.full((n_shards * capacity + 1,) + tuple(v.shape[1:]), pad,
                         dtype=v.dtype, device=v.device)
        buf[slot] = v[order]
        outs.append(buf[:-1])
    return tuple(outs), overflow


def _route(mesh, values: list, dest: list, valid: list, *, capacity: int, pads: tuple):
    """Route rows between the shards: every shard scatters its rows into
    per-destination buckets (:func:`_scatter`), then the mesh's
    ``all_to_all`` delivers to shard j the buckets addressed to it, in
    source order.  The received buffer holds each source's bucket in turn,
    valid rows first within a bucket and PAD rows after them.

    values/dest/valid: one entry per shard (values: a tuple of tensors routed
    together).  Returns (per shard, the tuple of received
    ``[n_shards * capacity(, W)]`` buffers; per shard, its overflow).
    """
    n = mesh.size
    sent = [_scatter(v, d, ok, n_shards=n, capacity=capacity, pads=pads)
            for v, d, ok in zip(values, dest, valid)]
    recv = [mesh.all_to_all([bufs[k] for bufs, _ in sent]) for k in range(len(pads))]
    return [tuple(r[i] for r in recv) for i in range(n)], [o for _, o in sent]


def _check_mesh(mesh, n_shards: int, axis_name: str) -> None:
    """A program planned for ``n_shards`` shards on ``axis_name`` runs on a
    mesh of that size and axis only."""
    if mesh.size != n_shards or mesh.axis_name != axis_name:
        raise ValueError(f"plan of {n_shards} shards on axis {axis_name!r} given {mesh}")


def shard_chunks(arrays, n_shards: int, cap: int, pads):
    """Host arrays of one length cut into ``n_shards`` contiguous chunks of
    ``ceil(len / n_shards)``, each at the front of its shard's row of a
    ``[n_shards, cap]`` int32 buffer filled with its pad: the per-shard
    inputs of the streaming and serving programs.  One buffer per array."""
    total = int(arrays[0].shape[0])
    chunk = -(-total // n_shards) if total else 0
    outs = []
    for a, pad in zip(arrays, pads):
        buf = np.full((n_shards, cap), pad, np.int32)
        for s in range(n_shards):
            seg = a[s * chunk:(s + 1) * chunk]
            buf[s, :seg.shape[0]] = seg
        outs.append(buf)
    return outs


def _betas_sum(betas: torch.Tensor) -> torch.Tensor:
    """float32 sum of the betas in index order (XLA's order for the few
    levels of a forest), as the reference's ``jnp.sum(betas)``."""
    acc = betas[0].to(torch.float32)
    for h in range(1, betas.shape[0]):
        acc = acc + betas[h]
    return acc


def _prune_keep(len_l, len_r, betas, prune_tau, valid):
    """The one float32 MSS upper-bound prune test (the JAX package's; the
    host join's ``_prune_delta`` applies the same bound and margin)."""
    ub = mss_upper_bound(len_l, len_r, _betas_sum(betas))
    return valid & (ub > float(np.float32(prune_tau - PRUNE_EPS)))


def _fit(x: torch.Tensor, cap: int, pad_val) -> torch.Tensor:
    """Pad or truncate the leading axis of ``x`` to exactly ``cap`` rows
    (truncation only on buffers whose valid rows are at the front)."""
    m = x.shape[0]
    if m >= cap:
        return x[:cap]
    tail = torch.full((cap - m,) + tuple(x.shape[1:]), pad_val, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def _lengths_of(code_rows: torch.Tensor) -> torch.Tensor:
    """Row lengths from the padding sentinel of level 0."""
    return (code_rows[:, 0, :] >= 0).sum(dim=-1).to(torch.int32)


def _hop_gather_codes(mesh, left, right, codes_local, *, owner_of, slot_of, hop_cap, out_cap):
    """The two-hop pair/code shuffle of the shuffle score mode.

    Route every pair to owner(left), attach that shard's code rows, route it
    on to owner(right), attach, and come to rest there (the pairs are
    already globally deduped).  Ownership is pluggable: the one-shot
    pipeline owns rows in blocks, ``owner_of(g) = g // local_n`` and
    ``slot_of(g, i) = g - i * local_n`` on shard i; the streaming world
    round-robins them, ``g % n`` and ``g // n``.  Received rows sit
    scattered across per-source buckets, so the valid rows are compacted to
    the front (a stable sort) before the fit to ``out_cap``.

    left/right/codes_local: one tensor per shard.  Returns per-shard lists
    (left, right, left codes [out_cap, H, L], right codes, overflow).
    """
    H, L = codes_local[0].shape[1], codes_local[0].shape[2]
    local_n = codes_local[0].shape[0]
    shards = range(mesh.size)

    def rows_of(i, ids):
        safe = slot_of(torch.where(ids == PAD_ID, 0, ids), i)
        return codes_local[i][safe.clamp(0, local_n - 1)]

    # hop 1: to owner(left)
    hop1, o1 = _route(mesh, list(zip(left, right)), [owner_of(x) for x in left],
                      [x != PAD_ID for x in left], capacity=hop_cap, pads=(PAD_ID, PAD_ID))
    payload = [(l1, r1, rows_of(i, l1).reshape(l1.shape[0], H * L))
               for i, (l1, r1) in zip(shards, hop1)]
    # hop 2: to owner(right), the payload is the left codes
    hop2, o2 = _route(mesh, payload, [owner_of(r1) for _, r1, _ in payload],
                      [l1 != PAD_ID for l1, _, _ in payload], capacity=hop_cap,
                      pads=(PAD_ID, PAD_ID, 0))
    outs = ([], [], [], [], [])
    for i, (l2, r2, cl2) in zip(shards, hop2):
        cr = rows_of(i, r2)
        cl_rows = cl2.reshape(l2.shape[0], H, L)
        order = torch.sort((l2 == PAD_ID).to(torch.uint8), stable=True).indices
        l2, r2, cl_rows, cr = l2[order], r2[order], cl_rows[order], cr[order]
        n_valid = (l2 != PAD_ID).sum().to(torch.int32)
        ovf_fit = (n_valid - out_cap).clamp(min=0)
        for out, x in zip(outs, (_fit(l2, out_cap, PAD_ID), _fit(r2, out_cap, PAD_ID),
                                 _fit(cl_rows, out_cap, 0), _fit(cr, out_cap, 0),
                                 o1[i] + o2[i] + ovf_fit)):
            out.append(x)
    return outs


# ---------------------------------------------------------------------------
# the one-shot sharded pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistributedPlan:
    n_shards: int
    local_n: int          # trajectories per shard
    shingle_route_cap: int  # rows per (src, dst) bucket in shuffle 1
    local_pair_cap: int     # pre-dedup pairs per shard after local join
    pair_route_cap: int     # rows per (src, dst) bucket in shuffle 2
    scored_cap: int         # deduped pairs per shard
    owner_route_cap: int = 0  # rows per (src, dst) bucket in the shuffle-mode
    #                           owner hops; 0 -> uniform fallback
    pruned_cap: int = 0     # post-prune pairs per shard when the MSS
    #                         upper-bound pruning pass runs; 0 -> scored_cap
    n_chunks: int = 1       # shuffle mode: split the pair buffer into this
    #                         many chunks, each hopped and scored in turn;
    #                         1 -> one gather-then-score pass
    chunk_hop_cap: int = 0  # rows per (src, dst) bucket in ONE chunk's
    #                         owner hops; 0 -> uniform fallback
    chunk_rest_cap: int = 0  # resting pairs per shard for ONE chunk;
    #                          0 -> uniform fallback


def plan_capacities(
    keys_np: np.ndarray,
    n_shards: int,
    *,
    slack: float = 1.3,
    quiet: bool = True,
    score_mode: str = "replicate",
    exact_pair_limit: int = 5_000_000,
    lengths_np: np.ndarray | None = None,
    prune_tau: float | None = None,
    betas_sum: float = 1.0,
    overlap_chunks: int = 1,
    windows_per_row: int = 1,
) -> DistributedPlan:
    """Host-side exact capacity planning from the actual join keys (numpy;
    the JAX package's function, line for line).

    Mirrors what a Spark driver learns from partition statistics.  Works for
    any backend's keys: only PAD_KEY rows are excluded.  Every shard
    destination is computed with the device's own int32 hashes
    (:func:`_positive_hash_np` / :func:`_pair_hash_np`), so per-bucket loads
    are exact: shuffle 1, the local join, the pair-dedup shuffle and, with
    ``score_mode="shuffle"``, the per-owner loads of the two code-gather
    hops.  Above ``exact_pair_limit`` pre-dedup pairs the pair list is not
    materialized and the uniform-hash bound takes over (the overflow
    counters and the engine's retry doubling catch any bust).

    With ``prune_tau`` and ``lengths_np`` the plan also sizes
    ``pruned_cap`` from the exact per-shard survivor counts of the MSS
    upper-bound prune (the same float32 bound the device applies); in
    shuffle mode the prune runs before the owner hops, so the hop buckets
    and the resting buffer are sized from survivors only.

    ``overlap_chunks > 1`` (shuffle mode) sizes the per-chunk hop and
    resting buffers: the device buffer layout is deterministic (the dedup
    sorts by (lo, hi) with PAD at the end and the prune compaction keeps
    that order), so the planner replays which pair lands in which chunk.

    ``windows_per_row > 1`` declares subtrajectory keys: one key row per
    WINDOW (``n = n_traj * nw``, window id ``t * nw + j``) while shards own
    whole trajectories, so ``local_n`` is in trajectory units and ownership
    maps a window id to its trajectory first; ``lengths_np`` is then
    per-window.
    """
    n, s = keys_np.shape
    nw = windows_per_row
    local_n = int(np.ceil((n // nw) / n_shards))
    keys_flat = keys_np.reshape(-1)
    ids_flat = np.repeat(np.arange(n, dtype=np.int64), s)
    valid = keys_flat != PAD_KEY
    kf, idf = keys_flat[valid], ids_flat[valid]
    # shuffle 1 loads: rows from one src shard to one dst shard (a window
    # row lives on the shard owning its trajectory)
    src = (idf // nw) // local_n
    dst = _positive_hash_np(kf) % n_shards
    load1 = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(load1, (src, dst), 1)
    cap1 = int(np.ceil(load1.max() * slack)) + 8

    # local join size per dst shard: sum over keys of rank contributions
    order = np.lexsort((idf, kf))
    kf_s, idf_s = kf[order], idf[order]
    dst_s = dst[order]
    run_start = np.ones(kf_s.shape, bool)
    run_start[1:] = kf_s[1:] != kf_s[:-1]
    idx = np.arange(kf_s.shape[0])
    starts = np.maximum.accumulate(np.where(run_start, idx, 0))
    ranks = idx - starts
    pair_count = np.zeros(n_shards, np.int64)
    np.add.at(pair_count, dst_s, ranks)
    cap2 = int(np.ceil(max(pair_count.max(), 1) * slack)) + 64

    total_pairs = int(ranks.sum())
    owner_cap = 0
    pruned_cap = 0
    chunk_hop = chunk_rest = 0
    if total_pairs <= exact_pair_limit:
        # materialize the pre-dedup pair list host-side (the Spark
        # driver's statistics pass): element at sorted position p with in-run rank r
        # pairs with the r earlier members of its key run
        rows = np.repeat(idx, ranks)
        excl = np.cumsum(ranks) - ranks
        t = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(excl, ranks)
        partners = rows - np.repeat(ranks, ranks) + t
        a_ids, b_ids = idf_s[rows], idf_s[partners]
        lo = np.minimum(a_ids, b_ids).astype(np.int32)
        hi = np.maximum(a_ids, b_ids).astype(np.int32)
        # shuffle 2 loads: pairs travel from their join shard to their
        # pair-hash dedup shard (self-pairs still occupy route slots)
        src2 = dst_s[rows]
        dst2 = _pair_hash_np(lo, hi) % n_shards
        load2 = np.zeros((n_shards, n_shards), np.int64)
        np.add.at(load2, (src2, dst2), 1)
        cap3 = int(np.ceil(max(load2.max(), 1) * slack)) + 64
        # deduped pairs per dedup shard (exact scored_cap)
        keep = lo != hi
        uniq = np.unique(
            (lo[keep].astype(np.int64) << 32) | hi[keep].astype(np.int64)
        )
        ulo = (uniq >> 32).astype(np.int32)
        uhi = (uniq & 0xFFFFFFFF).astype(np.int32)
        ded_dst = _pair_hash_np(ulo, uhi) % n_shards
        scored_need = int(np.bincount(ded_dst, minlength=n_shards).max()) \
            if uniq.size else 1
        prune = prune_tau is not None and lengths_np is not None
        if prune and uniq.size:
            # survivors of the MSS upper-bound prune, same f32 test as the
            # device pass; pruning runs after the dedup fit, so scored_cap
            # keeps its pre-prune sizing and pruned_cap sizes what is left
            ub = mss_upper_bound(lengths_np[ulo], lengths_np[uhi], betas_sum)
            surv = ub > np.float32(prune_tau - PRUNE_EPS)
        else:
            surv = np.ones(ulo.shape, bool)
        if score_mode == "shuffle":
            # per-owner loads of the code-gather hops: dedup shard ->
            # owner(left) -> owner(right); pairs come to rest on
            # owner(right).  Pruning happens before the hops, so with it on
            # only survivors travel.
            own_lo = ((ulo // nw) // local_n)[surv]
            own_hi = ((uhi // nw) // local_n)[surv]
            h1 = np.zeros((n_shards, n_shards), np.int64)
            np.add.at(h1, (ded_dst[surv], own_lo), 1)
            h2 = np.zeros((n_shards, n_shards), np.int64)
            np.add.at(h2, (own_lo, own_hi), 1)
            owner_cap = int(np.ceil(max(h1.max(), h2.max(), 1) * slack)) + 64
            rest_need = int(np.bincount(own_hi, minlength=n_shards).max()) \
                if own_hi.size else 1
            if prune:
                # the post-prune buffer first holds survivors compacted AT
                # the dedup shard (before the hops), then the resting
                # loads at owner(right) — size for both skews
                surv_need = int(
                    np.bincount(ded_dst[surv], minlength=n_shards).max()
                ) if surv.any() else 1
                pruned_cap = int(
                    np.ceil(max(surv_need, rest_need, 1) * slack)
                ) + 64
            else:
                scored_need = max(scored_need, rest_need)
        elif prune:
            surv_need = int(
                np.bincount(ded_dst[surv], minlength=n_shards).max()
            ) if surv.any() else 1
            pruned_cap = int(np.ceil(max(surv_need, 1) * slack)) + 64
        cap4 = int(np.ceil(max(scored_need, 1) * slack)) + 64
        if score_mode == "shuffle" and overlap_chunks > 1:
            # chunked planning: replay the deterministic device buffer
            # layout (np.unique gives the dedup's global (lo, hi) order) to
            # find which surviving pair occupies which chunk slice of which
            # shard's buffer, then size ONE chunk's hop buckets and resting
            # buffer from the worst chunk
            if prune:
                pruned_cap += (-pruned_cap) % overlap_chunks
                pre_cap = pruned_cap
            else:
                cap4 += (-cap4) % overlap_chunks
                pre_cap = cap4
            sub = pre_cap // overlap_chunks
            sel = np.nonzero(surv)[0]
            d_sel = ded_dst[sel]
            rank = np.zeros(sel.shape[0], np.int64)
            for s in range(n_shards):
                m = d_sel == s
                rank[m] = np.arange(int(m.sum()))
            chunk_of = np.minimum(rank // sub, overlap_chunks - 1)
            olo = (ulo[sel] // nw) // local_n
            ohi = (uhi[sel] // nw) // local_n
            ch1 = np.zeros((overlap_chunks, n_shards, n_shards), np.int64)
            np.add.at(ch1, (chunk_of, d_sel, olo), 1)
            ch2 = np.zeros((overlap_chunks, n_shards, n_shards), np.int64)
            np.add.at(ch2, (chunk_of, olo, ohi), 1)
            crest = np.zeros((overlap_chunks, n_shards), np.int64)
            np.add.at(crest, (chunk_of, ohi), 1)
            chunk_hop = int(np.ceil(max(ch1.max(), ch2.max(), 1) * slack)) + 64
            chunk_rest = int(np.ceil(max(crest.max(), 1) * slack)) + 64
    else:
        # uniform-hash bound with extra slack (skew caught by overflow+retry)
        cap3 = int(
            np.ceil(max(total_pairs / (n_shards * n_shards), 1) * slack * 2)
        ) + 64
        cap4 = int(np.ceil(max(total_pairs / n_shards, 1) * slack * 2)) + 64
        if score_mode == "shuffle" and overlap_chunks > 1:
            cap4 += (-cap4) % overlap_chunks  # device needs even chunk slices
    return DistributedPlan(
        n_shards=n_shards, local_n=local_n, shingle_route_cap=cap1,
        local_pair_cap=cap2, pair_route_cap=cap3, scored_cap=cap4,
        owner_route_cap=owner_cap, pruned_cap=pruned_cap,
        n_chunks=overlap_chunks if score_mode == "shuffle" else 1,
        chunk_hop_cap=chunk_hop, chunk_rest_cap=chunk_rest,
    )


SCORE_MODES = ("replicate", "shuffle")


def make_sharded_pipeline(
    mesh,
    plan: DistributedPlan,
    *,
    betas: torch.Tensor,
    key_fn: Callable | None,
    axis_name: str = "ex",
    score_mode: str = "replicate",
    lcs_impl: str = "wavefront",
    score_prune: bool = False,
    prune_tau: float = 0.0,
    tuning=None,
    subtraj: tuple[int, int, int] | None = None,
):
    """Build the sharded encode+join+score program over ``mesh``.

    key_fn: ``(local_type_codes [n, L], local_lengths [n]) -> keys [n, S]``
      run per shard (a backend's ``shard_key_fn``) on the shard's own
      encodings, or None, in which case the first input of the returned fn
      carries keys precomputed on the host instead (the "udf" backend's host wall).

    Call signature of the returned fn::

      fn(first, places [N, L] int32, lengths [N] int32,
         tables [n_levels, num_places] int32)
        -> dict of per-shard stacked outputs (on the mesh's first device):
           left/right [n, cap], level_lcs [n, cap, H], mss [n, cap],
           overflow [n, 3], pruned [n]

    ``places``/``lengths`` (and ``first`` without a key_fn) are split into
    row blocks, one per shard; ``tables`` is copied to each shard's device.
    Each shard encodes its own rows, so the [N, n_levels, L] code table is
    built in one piece only by the replicate mode's gather.

    score_mode:
      "replicate" — each shard all_gathers the per-shard encodings into a
        replica of the table and scores its deduped pairs locally.
      "shuffle"   — the table stays sharded; two more all_to_all rounds
        route each pair to owner(left) then owner(right), attaching the
        owner's code rows on the way, and the pair is scored where it comes
        to rest (the fused scorer then runs on two operand stacks with iota
        indices).

    lcs_impl selects the scorer as on the single-device path: the fused
    family ("fused", "fused-pallas", "fused-interpret") through
    ``kernels/lcs/fused``, the others through ``multi_level_lcs``.

    score_prune runs the MSS upper-bound prune right after the pair dedup
    (the lengths vector is all_gathered, never the code table) and compacts
    the survivors into ``pruned_cap``; in shuffle mode pruned pairs never
    travel.  With ``plan.n_chunks > 1`` (shuffle mode) the pair buffer is
    split into chunks, and chunk i+1's owner hops are issued before chunk i
    is scored, the JAX program's order; every pair still hops and scores
    once with the same operands, so the scores are the same.

    ``subtraj=(W, stride, nw)`` runs the subtrajectory mode: key rows are
    the nw windows of each local trajectory, candidate ids are window ids
    ``t * nw + j``, ownership stays per trajectory (``plan.local_n`` in
    trajectory units), the owner hops move whole [H, L] rows, and scoring
    windows them (#3 for the fused family, a width-W gather otherwise).

    ``tuning`` (an optional :class:`repro_torch.perf.LCSTuning`) resolves
    eagerly, at build time, into the non-fused impl's fixed launch
    arguments (``lcs_impl_fn``); the fused family ignores it.
    """
    from repro_torch.api.stages import FUSED_MODES, lcs_impl_fn
    from repro_torch.core import compat

    if score_mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {score_mode!r}; valid: {list(SCORE_MODES)}")
    n_shards = plan.n_shards
    _check_mesh(mesh, n_shards, axis_name)
    if subtraj is not None:
        W, stride, nw = subtraj
    else:
        W, stride, nw = 0, 1, 1
    fused_mode = FUSED_MODES.get(lcs_impl)
    impl = None if fused_mode is not None else lcs_impl_fn(lcs_impl, tuning)
    out_cap = (plan.pruned_cap or plan.scored_cap) if score_prune \
        else plan.scored_cap
    n_chunks = plan.n_chunks if score_mode == "shuffle" else 1
    if n_chunks > 1:
        if out_cap % n_chunks:
            raise ValueError(
                f"pair buffer ({out_cap}) must divide into n_chunks="
                f"{n_chunks} slices; plan_capacities rounds it up"
            )
        _sub = out_cap // n_chunks
        chunk_hop_cap = plan.chunk_hop_cap or (_sub // n_shards + 64)
        chunk_rest_cap = plan.chunk_rest_cap or _sub
        rest_total = n_chunks * chunk_rest_cap
    else:
        rest_total = out_cap
    betas_on = mesh.replicate(betas)
    shards = range(n_shards)

    def owner_of(g):
        return (g if subtraj is None else g // nw) // plan.local_n

    def slot_of(g, i):
        return (g if subtraj is None else g // nw) - i * plan.local_n

    def zeros(like):
        return torch.zeros((), dtype=torch.int32, device=like.device)

    def program(first, places, lengths, tables):
        # first: LOCAL key rows (key_fn=None) or unused; places, lengths:
        # LOCAL rows; tables: the replicated semantic forest
        gid0 = [i * plan.local_n for i in mesh.axis_index()]

        # in-mesh encoding of each shard's rows, then its join keys
        codes = [encode_codes(places[i], tables[i]) for i in shards]  # [local_n, H, L]
        if key_fn is not None:
            keys = [key_fn(codes[i][:, 0, :], lengths[i]) for i in shards]
        else:
            keys = first
        s = keys[0].shape[1]
        rows = plan.local_n if subtraj is None else plan.local_n * nw
        flat_keys = [k.reshape(-1) for k in keys]
        # one key row per row (or per WINDOW: global ids t * nw + j)
        flat_ids = [(torch.arange(rows, dtype=torch.int32, device=k.device)
                     + (gid0[i] if subtraj is None else gid0[i] * nw)).repeat_interleave(s)
                    for i, k in zip(shards, flat_keys)]
        recv, ovf1 = _route(
            mesh, list(zip(flat_keys, flat_ids)),
            [_positive_hash(k) % n_shards for k in flat_keys],
            [k != PAD_KEY for k in flat_keys],
            capacity=plan.shingle_route_cap, pads=(PAD_KEY, PAD_ID),
        )
        del keys, flat_keys, flat_ids

        # local sort-merge join on the received rows
        joined = [pairs_from_rows(rk, rid, pair_capacity=plan.local_pair_cap)
                  for rk, rid in recv]
        del recv
        ovf2 = [o for _, _, o in joined]

        # shuffle 2: route pairs by pair hash so the dedup is globally exact
        recv2, ovf3 = _route(
            mesh, [(lo, hi) for lo, hi, _ in joined],
            [_pair_hash(lo, hi) % n_shards for lo, hi, _ in joined],
            [lo != PAD_ID for lo, _, _ in joined],
            capacity=plan.pair_route_cap, pads=(PAD_ID, PAD_ID),
        )
        del joined
        # dedup over the WHOLE received buffer, then fit to scored_cap with
        # the excess surfaced as overflow
        cands = [dedup_pairs(rlo, rhi) for rlo, rhi in recv2]
        del recv2
        left = [_fit(c.left, plan.scored_cap, PAD_ID) for c in cands]
        right = [_fit(c.right, plan.scored_cap, PAD_ID) for c in cands]
        ovf4 = [(c.count - plan.scored_cap).clamp(min=0) for c in cands]
        del cands

        # the MSS upper-bound prune: drop pairs that cannot reach tau before
        # any code row moves for scoring (only the [N] lengths are gathered)
        n_pruned = [zeros(x) for x in left]
        if score_prune:
            lengths_all = mesh.all_gather(lengths)
            for i in shards:
                la = lengths_all[i]
                pl_valid = left[i] != PAD_ID
                sl = torch.where(pl_valid, left[i], 0)
                sr = torch.where(pl_valid, right[i], 0)
                if subtraj is None:
                    len_l, len_r = la[sl], la[sr]
                else:
                    # per-WINDOW lengths from the [N] trajectory lengths
                    len_l = (la[sl // nw] - (sl % nw) * stride).clamp(0, W)
                    len_r = (la[sr // nw] - (sr % nw) * stride).clamp(0, W)
                keep = _prune_keep(len_l, len_r, betas_on[i], prune_tau, pl_valid)
                n_keep = keep.sum().to(torch.int32)
                n_pruned[i] = pl_valid.sum().to(torch.int32) - n_keep
                order = torch.sort(torch.logical_not(keep).to(torch.uint8), stable=True).indices
                slots = torch.arange(out_cap, dtype=torch.int32, device=keep.device)
                # out_cap may exceed scored_cap (skewed owners): pad, then mask
                left[i] = torch.where(slots < n_keep, _fit(left[i][order], out_cap, PAD_ID), PAD_ID)
                right[i] = torch.where(slots < n_keep, _fit(right[i][order], out_cap, PAD_ID),
                                       PAD_ID)
                ovf4[i] = ovf4[i] + (n_keep - out_cap).clamp(min=0)

        # scoring, through the selected lcs_impl
        if score_mode == "replicate":
            codes_all = mesh.all_gather(codes)
            scores = [_score_table(codes_all[i], left[i], right[i], betas_on[i]) for i in shards]
            ovf5 = [zeros(x) for x in left]
        elif n_chunks == 1:
            cap = plan.owner_route_cap or (out_cap // n_shards + 64)
            left, right, codes_l, codes_r, ovf5 = _hop_gather_codes(
                mesh, left, right, codes, owner_of=owner_of, slot_of=slot_of,
                hop_cap=cap, out_cap=out_cap,
            )
            scores = [_score_gathered(codes_l[i], codes_r[i], out_cap, left[i], right[i],
                                      betas_on[i]) for i in shards]
        else:
            # the chunked gather+score: issue chunk i+1's owner hops BEFORE
            # scoring chunk i's resting pairs (the JAX program's order)
            def hop(c):
                sl = slice(c * _sub, (c + 1) * _sub)
                return _hop_gather_codes(
                    mesh, [x[sl] for x in left], [x[sl] for x in right], codes,
                    owner_of=owner_of, slot_of=slot_of,
                    hop_cap=chunk_hop_cap, out_cap=chunk_rest_cap,
                )

            def score_chunk(p):
                return [_score_gathered(p[2][i], p[3][i], chunk_rest_cap, p[0][i], p[1][i],
                                        betas_on[i]) for i in shards]

            parts = []
            pending = hop(0)
            for c in range(1, n_chunks):
                nxt = hop(c)
                parts.append((pending, score_chunk(pending)))
                pending = nxt
            parts.append((pending, score_chunk(pending)))
            left = [torch.cat([p[0][i] for p, _ in parts]) for i in shards]
            right = [torch.cat([p[1][i] for p, _ in parts]) for i in shards]
            scores = [tuple(torch.cat([sc[i][k] for _, sc in parts]) for k in range(2))
                      for i in shards]
            ovf5 = [sum(p[4][i] for p, _ in parts) for i in shards]
        level_lcs = [lv for lv, _ in scores]
        mss = [m.masked_fill(x == PAD_ID, -1.0) for (_, m), x in zip(scores, left)]
        overflow = [saturate_int32(torch.stack([ovf1[i].long() + ovf2[i], ovf3[i], ovf4[i] + ovf5[i]]))
                    for i in shards]
        return left, right, level_lcs, mss, overflow, [p.reshape(1) for p in n_pruned]

    def _score_table(codes_all, left, right, betas):
        """Replicate mode: score a shard's pairs out of the gathered table."""
        li = torch.where(left == PAD_ID, 0, left)
        ri = torch.where(right == PAD_ID, 0, right)
        len_all = _lengths_of(codes_all)
        if subtraj is not None:
            # window ids -> (traj, offset); score the [H, W] slices
            ta, oa = li // nw, (li % nw) * stride
            tb, ob = ri // nw, (ri % nw) * stride
            if fused_mode is not None:
                from repro_torch.kernels.lcs.fused import fused_windowed_score

                return fused_windowed_score(codes_all, len_all, codes_all, len_all,
                                            ta, tb, oa, ob, betas, window=W, mode=fused_mode)
            lvl = multi_level_lcs(
                gather_windows(codes_all[ta], oa, W), (len_all[ta] - oa).clamp(0, W),
                gather_windows(codes_all[tb], ob, W), (len_all[tb] - ob).clamp(0, W),
                impl=impl,
            )
            return lvl, mss_scores(lvl, betas)
        if fused_mode is not None:
            from repro_torch.kernels.lcs.fused import fused_score

            return fused_score(codes_all, len_all, codes_all, len_all, li, ri, betas,
                               mode=fused_mode)
        a, b = codes_all[li], codes_all[ri]
        lvl = multi_level_lcs(a, _lengths_of(a), b, _lengths_of(b), impl=impl)
        return lvl, mss_scores(lvl, betas)

    def _score_gathered(codes_l, codes_r, cap, left, right, betas):
        """Shuffle mode: score one resting operand stack (post-hop).  The
        gather already happened through the owner hops, so the fused
        scorers run over the two stacks with iota indices; in the
        subtrajectory mode the resting window ids give the offsets."""
        la, lb = _lengths_of(codes_l), _lengths_of(codes_r)
        iota = torch.arange(cap, dtype=torch.int32, device=codes_l.device)
        if subtraj is not None:
            oa = (torch.where(left == PAD_ID, 0, left) % nw) * stride
            ob = (torch.where(right == PAD_ID, 0, right) % nw) * stride
            if fused_mode is not None:
                from repro_torch.kernels.lcs.fused import fused_windowed_score

                return fused_windowed_score(codes_l, la, codes_r, lb, iota, iota, oa, ob,
                                            betas, window=W, mode=fused_mode)
            lvl = multi_level_lcs(
                gather_windows(codes_l, oa, W), (la - oa).clamp(0, W),
                gather_windows(codes_r, ob, W), (lb - ob).clamp(0, W), impl=impl,
            )
            return lvl, mss_scores(lvl, betas)
        if fused_mode is not None:
            from repro_torch.kernels.lcs.fused import fused_score

            return fused_score(codes_l, la, codes_r, lb, iota, iota, betas, mode=fused_mode)
        lvl = multi_level_lcs(codes_l, la, codes_r, lb, impl=impl)
        return lvl, mss_scores(lvl, betas)

    P = compat.P
    fn = compat.shard_map(
        program, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name), P(None, None)),
        out_specs=(P(axis_name),) * 6,
    )

    def run(first, places, lengths, tables):
        left, right, level_lcs, mss, overflow, pruned = fn(first, places, lengths, tables)
        return {
            "left": left.reshape(n_shards, -1),
            "right": right.reshape(n_shards, -1),
            "level_lcs": level_lcs.reshape(n_shards, rest_total, -1),
            "mss": mss.reshape(n_shards, -1),
            "overflow": overflow.reshape(n_shards, -1),
            "pruned": pruned.reshape(n_shards),
        }

    return run


def make_distributed_anotherme(
    mesh,
    plan: DistributedPlan,
    *,
    tables: torch.Tensor,
    k: int,
    num_types: int,
    betas: torch.Tensor,
    axis_name: str = "ex",
    dedup: bool = True,
    score_mode: str = "replicate",
    lcs_impl: str = "wavefront",
):
    """Legacy entry point: the SSH-shingle sharded pipeline.

    A thin adapter over :func:`make_sharded_pipeline` with the shingle
    key_fn; prefer ``AnotherMeEngine`` with ``ExecutionPlan(n_shards=...)``.
    The returned fn takes ``(places [N, L], lengths [N])``.
    """
    def key_fn(local_types, local_lengths):
        return shingles_from_types(
            local_types, local_lengths, k=k, num_types=num_types, dedup=dedup
        )

    inner = make_sharded_pipeline(
        mesh, plan, betas=betas, key_fn=key_fn,
        axis_name=axis_name, score_mode=score_mode, lcs_impl=lcs_impl,
    )

    def run(places, lengths):
        return inner(places, places, lengths, tables)

    return run


def gather_similar_pairs(out: dict, rho: float) -> set[tuple[int, int]]:
    """The globally deduped similar pair set: ``mss > rho`` (in float32) on
    the valid slots of every shard, collected on the host."""
    left = torch.as_tensor(out["left"]).reshape(-1)
    right = torch.as_tensor(out["right"]).reshape(-1)
    mss = torch.as_tensor(out["mss"]).reshape(-1)
    keep = (left != PAD_ID) & (mss > float(np.float32(rho)))
    return set(zip(to_numpy(left[keep]).tolist(), to_numpy(right[keep]).tolist()))


def pad_to_shards(places: np.ndarray, lengths: np.ndarray, n_shards: int):
    """Pad N up to a multiple of n_shards with empty trajectories."""
    n = places.shape[0]
    n_pad = (-n) % n_shards
    if n_pad:
        places = np.concatenate(
            [places, np.full((n_pad, places.shape[1]), -1, places.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros((n_pad,), lengths.dtype)])
    return places, lengths


# ---------------------------------------------------------------------------
# the in-mesh streaming delta join
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamJoinPlan:
    """Static shapes of one streaming delta-join program.

    Every (key, row id) occurrence lives on shard ``hash(key) % n_shards``
    in a sorted slab of ``slab_cap`` slots.  Per update the new rows' key
    occurrences enter, ``key_in_cap`` per source shard, are routed to their
    owners (``key_route_cap`` per (src, dst) bucket), probed against the slab
    into the ``nn_cap``/``no_cap`` pair buffers, routed by pair hash for the
    dedup (``pair_route_cap``), and come to rest ``pair_cap`` per shard.
    All are powers of two, and the engine keeps them sticky.
    """

    n_shards: int
    slab_cap: int       # resident (key, row) occurrences per shard
    key_in_cap: int     # incoming key occurrences per source shard
    key_route_cap: int  # rows per (src, dst) bucket in the key route
    nn_cap: int         # new-vs-new pair slots per owner shard
    no_cap: int         # new-vs-old pair slots per owner shard
    pair_route_cap: int  # rows per (src, dst) bucket in the dedup shuffle
    pair_cap: int       # deduped resting delta pairs per shard


def plan_stream_join(keys_flat: np.ndarray, n_shards: int, stats, *,
                     floor_pow2: int = 4) -> StreamJoinPlan:
    """Exact capacity plan for ONE update's delta join.

    keys_flat: the new rows' per-row-deduped key occurrences (flat, row
    order).  ``stats`` (a ``StreamJoinStats``) gives the exact per-owner
    new-vs-old / new-vs-new emission counts and slab-entry deltas under the
    device's hash; the two pair-stage caps use the pre-dedup emission
    totals, a safe bound on any post-dedup skew.
    """
    k = int(keys_flat.shape[0])
    owners = _positive_hash_np(keys_flat) % n_shards if k else np.zeros((0,), np.int64)
    nvo, nvn, ent = stats.plan_update(keys_flat, owners)
    chunk = -(-k // n_shards) if k else 0
    if k:
        src = np.arange(k, dtype=np.int64) // max(chunk, 1)
        load = np.zeros((n_shards, n_shards), np.int64)
        np.add.at(load, (src, owners), 1)
        route_need = int(load.max())
    else:
        route_need = 1
    emit = nvo + nvn
    return StreamJoinPlan(
        n_shards=n_shards,
        slab_cap=_pow2(int((stats.owner_entries + ent).max()), floor_pow2),
        key_in_cap=_pow2(chunk, floor_pow2),
        key_route_cap=_pow2(route_need, floor_pow2),
        nn_cap=_pow2(int(nvn.max()), floor_pow2),
        no_cap=_pow2(int(nvo.max()), floor_pow2),
        pair_route_cap=_pow2(int(emit.max()), floor_pow2),
        pair_cap=_pow2(int(emit.sum()), floor_pow2),
    )


def sticky_join_plan(plan: StreamJoinPlan, prev: StreamJoinPlan | None) -> StreamJoinPlan:
    """Monotone max over every capacity, so consecutive updates of similar
    shape resolve to the same plan (and the same built function)."""
    if prev is None:
        return plan
    return StreamJoinPlan(**{
        f.name: max(getattr(plan, f.name), getattr(prev, f.name))
        for f in dataclasses.fields(StreamJoinPlan)
    })


def make_streaming_join_pipeline(mesh, plan: StreamJoinPlan, *, axis_name: str = "ex",
                                 trace_counter: list | None = None):
    """Build the streaming delta-join program over ``mesh`` (the device-side
    replacement for ``BucketIndex.insert``)::

      fn(slab_keys [n_shards * slab_cap] int32,   # the resident sorted slabs
         slab_rows [n_shards * slab_cap] int32,
         keys      [n_shards * key_in_cap] int32,  # the new occurrences,
         rows      [n_shards * key_in_cap] int32)  # PAD-padded chunks
        -> dict: slab_keys/slab_rows (merged: commit only on success),
                 left/right [n_shards, pair_cap] deduped delta pairs,
                 count [n_shards], max_count [n_shards] (the pmax of the
                 post-dedup counts, on every shard), examined [n_shards],
                 overflow [n_shards, 4]

    Stages per shard: (1) ``all_to_all`` the incoming occurrences to
    ``hash(key) % n_shards`` (:func:`_route`); (2) :func:`probe_pairs`
    against the shard's slab (new-vs-old and new-vs-new, exact ``examined``
    counts); (3) route the pairs by pair hash and :func:`dedup_pairs`, so
    every delta pair rests on exactly one shard (cross-owner duplicates
    collapse here); (4) :func:`merge_insert` the received occurrences into
    the slab.  The program is pure: it returns new slabs, stacked from the
    shards' (one copy of the slab an update).
    """
    from repro_torch.core import compat

    n_shards = plan.n_shards
    _check_mesh(mesh, n_shards, axis_name)
    if trace_counter is not None:
        trace_counter[0] += 1  # one build per plan (the JAX trace count)
    shards = range(n_shards)

    def program(slab_k, slab_r, keys, rows):
        recv, o1 = _route(
            mesh, list(zip(keys, rows)), [_positive_hash(k) % n_shards for k in keys],
            [k != PAD_KEY for k in keys], capacity=plan.key_route_cap, pads=(PAD_KEY, PAD_ID),
        )
        probed = [probe_pairs(slab_k[i], slab_r[i], rk, rr, nn_cap=plan.nn_cap,
                              no_cap=plan.no_cap) for i, (rk, rr) in zip(shards, recv)]
        recv2, o3 = _route(
            mesh, [(lo, hi) for lo, hi, _, _ in probed],
            [_pair_hash(lo, hi) % n_shards for lo, hi, _, _ in probed],
            [lo != PAD_ID for lo, _, _, _ in probed],
            capacity=plan.pair_route_cap, pads=(PAD_ID, PAD_ID),
        )
        cands = [dedup_pairs(rlo, rhi) for rlo, rhi in recv2]
        merged = [merge_insert(slab_k[i], slab_r[i], rk, rr) for i, (rk, rr) in zip(shards, recv)]
        count = [c.count.clamp(max=plan.pair_cap) for c in cands]
        # the worst per-shard post-dedup count, on every shard: the engine
        # sizes the score program's pair buffers from it
        max_count = mesh.pmax(count)
        overflow = []
        for i, c in zip(shards, cands):
            o4 = (c.count - plan.pair_cap).clamp(min=0)
            zero = torch.zeros((), dtype=torch.int32, device=c.count.device)
            overflow.append(torch.stack([o1[i] + probed[i][3], o3[i] + o4, merged[i][2],
                                         zero]).to(torch.int32))
        return ([m[0] for m in merged], [m[1] for m in merged],
                [_fit(c.left, plan.pair_cap, PAD_ID) for c in cands],
                [_fit(c.right, plan.pair_cap, PAD_ID) for c in cands],
                [x.reshape(1) for x in count], [x.reshape(1) for x in max_count],
                [p[2].reshape(1) for p in probed], overflow)

    P = compat.P
    fn = compat.shard_map(program, mesh=mesh, in_specs=(P(axis_name),) * 4,
                          out_specs=(P(axis_name),) * 8)

    def run(slab_keys, slab_rows, keys, rows):
        sk, sr, left, right, count, max_count, examined, overflow = fn(
            slab_keys, slab_rows, keys, rows)
        return {
            "slab_keys": sk.reshape(-1), "slab_rows": sr.reshape(-1),
            "left": left, "right": right,
            "count": count.reshape(n_shards), "max_count": max_count.reshape(n_shards),
            "examined": examined.reshape(n_shards), "overflow": overflow,
        }

    return run


# ---------------------------------------------------------------------------
# the streaming score program over the places slab
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamShardPlan:
    """Static shapes of one streaming score program.

    The world is laid out round-robin: row g on shard ``g % n_shards`` at
    local slot ``g // n_shards``, so appends keep every shard within one row
    of balanced.  All capacities are powers of two, kept sticky by the
    engine.
    """

    n_shards: int
    cap_local: int   # physical world rows per shard (world cap / n_shards)
    pair_cap: int    # delta pairs per shard (host-assigned input slices)
    hop_cap: int     # rows per (src, dst) bucket in the owner hops (shuffle);
    #                  PER CHUNK when n_chunks > 1
    out_cap: int     # resting pairs per shard after the hops (PER CHUNK when
    #                  n_chunks > 1); "replicate" scores in place: == pair_cap
    n_chunks: int = 1  # shuffle: split each shard's pair slice into this many
    #                    sub-chunks, chunk i+1's hops issued before chunk i
    #                    scores (a power of two dividing pair_cap)


def plan_stream_capacities(
    lo: np.ndarray,
    hi: np.ndarray,
    n_shards: int,
    cap_local: int,
    *,
    score_mode: str = "replicate",
    floor_pow2: int = 4,
    overlap_chunks: int = 1,
    pair_cap_floor: int = 0,
    windows_per_row: int = 1,
) -> StreamShardPlan:
    """Exact skew-aware capacity plan for ONE micro-batch's delta pairs
    (numpy; the JAX package's function, line for line).

    The delta pairs are deduped on the host already, so planning is the
    score shuffle's: pairs go to source shards in contiguous chunks, and in
    ``score_mode="shuffle"`` the two owner hops are sized from the actual
    per-(chunk, src, dst) loads under round-robin ownership ``id %
    n_shards``.  Capacities are powers of two; the engine keeps them sticky.
    ``pair_cap_floor`` (the sticky ``pair_cap``) lets a fresh plan compute
    its chunk loads under the slice layout the runner will use.
    ``windows_per_row > 1`` declares window ids (``t * nw + j``), owned per
    trajectory; the streaming engine rejects windows, the planner keeps
    them for parity.
    """
    p = int(lo.shape[0])
    chunk = -(-p // n_shards) if p else 0  # ceil
    pair_cap = max(_pow2(chunk, floor_pow2), pair_cap_floor or 0)
    if score_mode == "replicate":
        return StreamShardPlan(
            n_shards=n_shards, cap_local=cap_local, pair_cap=pair_cap,
            hop_cap=0, out_cap=pair_cap,
        )
    n_chunks = max(int(overlap_chunks), 1)
    sub = pair_cap // n_chunks if n_chunks > 1 else pair_cap
    if p:
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        idx = np.arange(p, dtype=np.int64)
        src = idx // max(chunk, 1)
        pos = idx - src * max(chunk, 1)    # front slot in the shard's slice
        cidx = np.minimum(pos // max(sub, 1), n_chunks - 1)
        own_lo = (lo // windows_per_row) % n_shards
        own_hi = (hi // windows_per_row) % n_shards
        h1 = np.zeros((n_chunks, n_shards, n_shards), np.int64)
        np.add.at(h1, (cidx, src, own_lo), 1)
        h2 = np.zeros((n_chunks, n_shards, n_shards), np.int64)
        np.add.at(h2, (cidx, own_lo, own_hi), 1)
        rest = np.zeros((n_chunks, n_shards), np.int64)
        np.add.at(rest, (cidx, own_hi), 1)
        hop_need = int(max(h1.max(), h2.max()))
        rest_need = int(rest.max())
    else:
        hop_need = rest_need = 1
    return StreamShardPlan(
        n_shards=n_shards, cap_local=cap_local, pair_cap=pair_cap,
        hop_cap=_pow2(hop_need, floor_pow2),
        out_cap=_pow2(rest_need, floor_pow2),
        n_chunks=n_chunks,
    )


def make_streaming_score_pipeline(
    mesh,
    plan: StreamShardPlan,
    *,
    betas: torch.Tensor,
    axis_name: str = "ex",
    score_mode: str = "replicate",
    lcs_impl: str = "wavefront",
    trace_counter: list | None = None,
    score_prune: bool = False,
    prune_tau: float = 0.0,
    tuning=None,
):
    """Build the streaming delta score program over ``mesh``::

      fn(places [n_shards * cap_local, L] int32,  # the round-robin slab
         left   [n_shards * pair_cap] int32,      # local ids, PAD_ID pad
         right  [n_shards * pair_cap] int32,
         tables [n_levels, num_places] int32)
        -> dict: left/right [n, rest], level_lcs [n, rest, H], mss [n, rest],
                 overflow [n], pruned [n]   (rest = out_cap * n_chunks)

    Each shard encodes its own block of the slab every call; lengths come
    from the encodings' sentinels.  ``"replicate"`` all_gathers the
    encodings and scores each shard's pair slice in place (output slot ==
    input slot), the fused scorer (#1) with the gathered world as both of
    its tables; ``"shuffle"`` keeps the table sharded and runs the two owner
    hops (:func:`_hop_gather_codes`, owner ``g % n``, slot ``g // n``), then
    scores the resting stacks (#1 on two stacks with iota indices), chunk
    i+1's hops issued before chunk i scores when ``plan.n_chunks > 1``.
    Other impls gather the rows for ``multi_level_lcs`` (the batched LCS
    kernel #2 under ``"kernel"``).

    ``score_prune`` masks the pairs whose float32 MSS bound cannot clear
    ``prune_tau`` to PAD (in shuffle mode BEFORE the hops, from an
    all_gather of the lengths only, so pruned pairs never travel); pruned
    slots read mss -1.0 and their count returns as ``pruned``.
    ``tuning`` (an optional :class:`repro_torch.perf.LCSTuning`) resolves
    eagerly, at build time, as in :func:`make_sharded_pipeline`.
    """
    from repro_torch.api.stages import FUSED_MODES, lcs_impl_fn
    from repro_torch.core import compat

    if score_mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {score_mode!r}; valid: {list(SCORE_MODES)}")
    n_shards = plan.n_shards
    _check_mesh(mesh, n_shards, axis_name)
    fused_mode = FUSED_MODES.get(lcs_impl)
    impl = None if fused_mode is not None else lcs_impl_fn(lcs_impl, tuning)
    out_cap = plan.out_cap
    n_chunks = plan.n_chunks if score_mode == "shuffle" else 1
    if n_chunks > 1:
        if plan.pair_cap % n_chunks:
            raise ValueError(f"pair_cap ({plan.pair_cap}) must divide into n_chunks="
                             f"{n_chunks} slices (both are powers of two)")
        sub = plan.pair_cap // n_chunks
    rest_total = n_chunks * out_cap
    if trace_counter is not None:
        trace_counter[0] += 1  # one build per plan (the JAX trace count)
    betas_on = mesh.replicate(betas)
    shards = range(n_shards)

    def phys(g, valid):
        # round-robin physical row: (g % n) * cap_local + g // n
        safe = torch.where(valid, g, 0).long()
        return (safe % n_shards) * plan.cap_local + safe // n_shards

    def zeros(like):
        return torch.zeros((), dtype=torch.int32, device=like.device)

    def prune(left, right, len_all, i):
        """Mask shard i's pairs that cannot clear tau to PAD; returns the
        masked pairs and the pruned count."""
        valid = left != PAD_ID
        keep = _prune_keep(len_all[phys(left, valid)], len_all[phys(right, valid)],
                           betas_on[i], prune_tau, valid)
        return (torch.where(keep, left, PAD_ID), torch.where(keep, right, PAD_ID),
                (valid.sum() - keep.sum()).to(torch.int32))

    def score_table(codes_all, li, ri, betas):
        """Replicate: score a shard's pairs (physical rows ``li``, ``ri``)
        out of the gathered world."""
        if fused_mode is not None:
            from repro_torch.kernels.lcs.fused import fused_score

            len_all = _lengths_of(codes_all)
            return fused_score(codes_all, len_all, codes_all, len_all, li.to(torch.int32),
                               ri.to(torch.int32), betas, mode=fused_mode)
        a, b = codes_all[li], codes_all[ri]
        lvl = multi_level_lcs(a, _lengths_of(a), b, _lengths_of(b), impl=impl)
        return lvl, mss_scores(lvl, betas)

    def score_gathered(codes_l, codes_r, betas):
        """Shuffle: score one resting operand stack (the hops gathered it)."""
        la, lb = _lengths_of(codes_l), _lengths_of(codes_r)
        if fused_mode is not None:
            from repro_torch.kernels.lcs.fused import fused_score

            iota = torch.arange(codes_l.shape[0], dtype=torch.int32, device=codes_l.device)
            return fused_score(codes_l, la, codes_r, lb, iota, iota, betas, mode=fused_mode)
        lvl = multi_level_lcs(codes_l, la, codes_r, lb, impl=impl)
        return lvl, mss_scores(lvl, betas)

    def program(places, left, right, tables):
        codes = [encode_codes(places[i], tables[i]) for i in shards]  # [cap_local, H, L]
        n_pruned = [zeros(x) for x in left]
        left, right = list(left), list(right)
        if score_mode == "replicate":
            codes_all = mesh.all_gather(codes)
            del codes
            # the rows of every slot, pruned ones too: their slots still
            # score, as the reference's do, and read mss -1.0
            rows = [(phys(x, x != PAD_ID), phys(y, x != PAD_ID)) for x, y in zip(left, right)]
            if score_prune:
                for i in shards:
                    left[i], right[i], n_pruned[i] = prune(
                        left[i], right[i], _lengths_of(codes_all[i]), i)
            scores = [score_table(codes_all[i], *rows[i], betas_on[i]) for i in shards]
            ovf = [zeros(x) for x in left]
        else:
            if score_prune:
                # prune BEFORE the hops: only the [N] lengths are gathered,
                # and masked pairs are invalid to the route, so never travel
                len_all = mesh.all_gather([_lengths_of(c) for c in codes])
                for i in shards:
                    left[i], right[i], n_pruned[i] = prune(left[i], right[i], len_all[i], i)

            def hop(l_parts, r_parts):
                return _hop_gather_codes(
                    mesh, l_parts, r_parts, codes, owner_of=lambda g: g % n_shards,
                    slot_of=lambda g, i: g // n_shards, hop_cap=plan.hop_cap, out_cap=out_cap,
                )

            def score_chunk(p):
                return [score_gathered(p[2][i], p[3][i], betas_on[i]) for i in shards]

            if n_chunks == 1:
                p = hop(left, right)
                parts = [(p, score_chunk(p))]
            else:
                # issue chunk c+1's owner hops BEFORE scoring chunk c's
                # resting pairs (the JAX program's order)
                parts = []
                pending = hop([x[:sub] for x in left], [x[:sub] for x in right])
                for c in range(1, n_chunks):
                    sl = slice(c * sub, (c + 1) * sub)
                    nxt = hop([x[sl] for x in left], [x[sl] for x in right])
                    parts.append((pending, score_chunk(pending)))
                    pending = nxt
                parts.append((pending, score_chunk(pending)))
            left = [torch.cat([p[0][i] for p, _ in parts]) for i in shards]
            right = [torch.cat([p[1][i] for p, _ in parts]) for i in shards]
            scores = [tuple(torch.cat([sc[i][k] for _, sc in parts]) for k in range(2))
                      for i in shards]
            ovf = [sum(p[4][i] for p, _ in parts) for i in shards]
        mss = [m.masked_fill(x == PAD_ID, -1.0) for (_, m), x in zip(scores, left)]
        return (left, right, [lv for lv, _ in scores], mss,
                [o.to(torch.int32).reshape(1) for o in ovf], [p.reshape(1) for p in n_pruned])

    P = compat.P
    fn = compat.shard_map(
        program, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name), P(None, None)),
        out_specs=(P(axis_name),) * 6,
    )

    def run(places, left, right, tables):
        out_l, out_r, level_lcs, mss, overflow, pruned = fn(places, left, right, tables)
        return {
            "left": out_l.reshape(n_shards, -1), "right": out_r.reshape(n_shards, -1),
            "level_lcs": level_lcs.reshape(n_shards, rest_total, -1),
            "mss": mss.reshape(n_shards, -1), "overflow": overflow.reshape(n_shards),
            "pruned": pruned.reshape(n_shards),
        }

    return run
