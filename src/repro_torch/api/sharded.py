"""The JAX package's sharded streaming programs at one shard.

Port of the pieces of ``repro/api/sharded.py`` that the device-resident
streaming join (``ExecutionPlan(delta_join="device")``) and serving over
its slabs run on one device:

  * the int32 hashes :func:`_positive_hash` / :func:`_pair_hash` (with the
    reference's wraparound) and their numpy twin :func:`_positive_hash_np`;
  * :func:`_route`, the bucket scatter of the key and pair shuffles;
  * :class:`StreamJoinPlan`, :func:`plan_stream_join` and
    :func:`sticky_join_plan`: the exact per-owner capacity plan of one
    update's join, from the ``StreamJoinStats`` count mirror;
  * :func:`make_streaming_join_pipeline`: route the new rows' keys, probe
    the slab for the delta pairs, route and dedup them, merge the keys in;
  * :class:`StreamShardPlan` and :func:`make_streaming_score_pipeline`:
    encode the places slab, prune and score the resting delta pairs
    (``score_mode="replicate"``).

The JAX programs run as ``shard_map`` over a mesh even at one shard.  Here
there is one shard and no mesh: each collective (``all_to_all`` in the
routes, ``all_gather``, ``pmax``) is the identity, and :func:`_one_shard`
refuses anything else with :class:`NotPortedError`, as it does
``score_mode="shuffle"`` (the owner hops).  The world keeps the JAX
package's round-robin layout (row g at ``(g % n) * cap_local + g // n``),
which at one shard is row g at slot g.

Each builder returns a plain function and counts its builds in
``trace_counter``, where the JAX package counts the traces of its compiled
program: one per distinct plan in both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.errors import NotPortedError
from repro_torch.core.device_index import merge_insert, probe_pairs
from repro_torch.core.encoding import encode_codes
from repro_torch.core.similarity import (
    PRUNE_EPS, mss_scores, mss_upper_bound, multi_level_lcs,
)
from repro_torch.core.ssh import _runs, dedup_pairs
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


def _pow2(x: int, floor_pow2: int = 4) -> int:
    """The smallest power of two >= ``x`` and >= ``2**floor_pow2``."""
    return 1 << max(floor_pow2, int(np.ceil(np.log2(max(int(x), 1)))))


def _one_shard(n_shards: int, what: str) -> None:
    """The collectives of the JAX programs are identities at one shard;
    more shards need ``torch.distributed``, which is not ported."""
    if n_shards != 1:
        raise NotPortedError(f"{what} with n_shards={n_shards}")


def _route(values: tuple, dest: torch.Tensor, valid: torch.Tensor, *, n_shards: int,
           capacity: int, pads: tuple):
    """Scatter rows into ``[n_shards, capacity]`` buckets by destination.

    values: int32 [R] or [R, W] tensors routed together; pads: the pad value
    of each.  The rows of each destination keep their order (a stable sort
    on the destination), rows past ``capacity`` are counted in the overflow.
    The JAX package then ``all_to_all``s the buckets; at one shard that is
    the identity.  Returns (tuple of [n_shards * capacity(, W)], overflow).
    """
    _one_shard(n_shards, "_route")
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


def make_streaming_join_pipeline(plan: StreamJoinPlan, *, trace_counter: list | None = None):
    """Build the streaming delta-join function (the device-side replacement
    for ``BucketIndex.insert``)::

      fn(slab_keys [slab_cap] int32,   # the resident sorted slab
         slab_rows [slab_cap] int32,
         keys      [key_in_cap] int32,  # the new occurrences, PAD-padded
         rows      [key_in_cap] int32)
        -> dict: slab_keys/slab_rows (merged: commit only on success),
                 left/right [1, pair_cap] deduped delta pairs, count [1],
                 max_count [1] (the post-dedup count, the JAX program's
                 pmax), examined [1], overflow [1, 4]

    Stages: (1) route the occurrences to ``hash(key) % n_shards``;
    (2) :func:`probe_pairs` against the slab; (3) route by pair hash and
    :func:`dedup_pairs`; (4) :func:`merge_insert` the occurrences into the
    slab.  The function is pure: it returns new slabs.
    """
    _one_shard(plan.n_shards, "make_streaming_join_pipeline")
    if trace_counter is not None:
        trace_counter[0] += 1  # one build per plan (the JAX trace count)
    n_shards = plan.n_shards

    def run(slab_keys, slab_rows, keys, rows):
        valid = keys != PAD_KEY
        (rk, rr), o1 = _route(
            (keys, rows), _positive_hash(keys) % n_shards, valid, n_shards=n_shards,
            capacity=plan.key_route_cap, pads=(PAD_KEY, PAD_ID),
        )
        lo, hi, examined, o2 = probe_pairs(slab_keys, slab_rows, rk, rr,
                                           nn_cap=plan.nn_cap, no_cap=plan.no_cap)
        (rlo, rhi), o3 = _route(
            (lo, hi), _pair_hash(lo, hi) % n_shards, lo != PAD_ID, n_shards=n_shards,
            capacity=plan.pair_route_cap, pads=(PAD_ID, PAD_ID),
        )
        cand = dedup_pairs(rlo, rhi)
        left = _fit(cand.left, plan.pair_cap, PAD_ID)
        right = _fit(cand.right, plan.pair_cap, PAD_ID)
        o4 = (cand.count - plan.pair_cap).clamp(min=0)
        slab_k2, slab_r2, o5 = merge_insert(slab_keys, slab_rows, rk, rr)
        count = cand.count.clamp(max=plan.pair_cap)
        zero = torch.zeros((), dtype=torch.int32, device=keys.device)
        overflow = torch.stack([o1 + o2, o3 + o4, o5, zero]).to(torch.int32)
        return {
            "slab_keys": slab_k2, "slab_rows": slab_r2,
            "left": left.reshape(n_shards, -1), "right": right.reshape(n_shards, -1),
            "count": count.reshape(n_shards), "max_count": count.reshape(n_shards),
            "examined": examined.reshape(n_shards),
            "overflow": overflow.reshape(n_shards, -1),
        }

    return run


# ---------------------------------------------------------------------------
# the streaming score program over the places slab
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StreamShardPlan:
    """Static shapes of one streaming score program.

    The world is laid out round-robin: row g on shard ``g % n_shards`` at
    local slot ``g // n_shards``.  In ``"replicate"`` mode pairs score in
    place, so ``out_cap == pair_cap`` (the JAX plan's ``hop_cap`` and
    ``n_chunks`` size the ``"shuffle"`` owner hops, not ported).
    """

    n_shards: int
    cap_local: int   # physical world rows per shard
    pair_cap: int    # delta pairs per shard
    out_cap: int     # resting pairs per shard


def _lengths_of(code_rows: torch.Tensor) -> torch.Tensor:
    """Row lengths from the padding sentinel of level 0."""
    return (code_rows[:, 0, :] >= 0).sum(dim=-1).to(torch.int32)


def make_streaming_score_pipeline(
    plan: StreamShardPlan,
    *,
    betas: torch.Tensor,
    score_mode: str = "replicate",
    lcs_impl: str = "wavefront",
    trace_counter: list | None = None,
    score_prune: bool = False,
    prune_tau: float = 0.0,
):
    """Build the streaming delta score function::

      fn(places [cap_local, L] int32,   # the round-robin places slab
         left   [pair_cap] int32,       # local ids, PAD_ID pad
         right  [pair_cap] int32,
         tables [n_levels, num_places] int32)
        -> dict: left/right [1, out_cap], level_lcs [1, out_cap, H],
                 mss [1, out_cap], overflow [1], pruned [1]

    The world is encoded inside the function every call, and lengths come
    from the encoding's sentinels, as the reference does.  ``score_prune``
    masks the pairs whose float32 MSS bound cannot clear ``prune_tau`` to
    PAD (their slots still score, as the reference's do, and read mss
    -1.0).  Under the fused family the fused scorer (#1) runs with the
    world as both of its tables; otherwise the pairs' rows are gathered for
    ``multi_level_lcs`` (the batched LCS kernel #2 under ``"kernel"``).
    """
    from repro_torch.api.stages import FUSED_MODES, lcs_impl_fn

    _one_shard(plan.n_shards, "make_streaming_score_pipeline")
    if score_mode != "replicate":
        raise NotPortedError(f"make_streaming_score_pipeline(score_mode={score_mode!r})")
    fused_mode = FUSED_MODES.get(lcs_impl)
    impl = None if fused_mode is not None else lcs_impl_fn(lcs_impl)
    if trace_counter is not None:
        trace_counter[0] += 1  # one build per plan (the JAX trace count)
    n_shards = plan.n_shards

    def _phys(g, valid):
        # round-robin physical slot: (g % n) * cap_local + g // n
        safe = torch.where(valid, g, 0).long()
        return (safe % n_shards) * plan.cap_local + safe // n_shards

    def run(places, left, right, tables):
        codes_all = encode_codes(places, tables)  # the all_gather: identity
        valid = left != PAD_ID
        li, ri = _phys(left, valid), _phys(right, valid)
        n_pruned = torch.zeros((), dtype=torch.int32, device=left.device)
        if score_prune:
            len_all = _lengths_of(codes_all)
            keep = _prune_keep(len_all[li], len_all[ri], betas, prune_tau, valid)
            n_pruned = (valid.sum() - keep.sum()).to(torch.int32)
            left = torch.where(keep, left, PAD_ID)
            right = torch.where(keep, right, PAD_ID)
        if fused_mode is not None:
            from repro_torch.kernels.lcs.fused import fused_score

            len_all = _lengths_of(codes_all)
            level_lcs, mss = fused_score(codes_all, len_all, codes_all, len_all,
                                         li.to(torch.int32), ri.to(torch.int32), betas,
                                         mode=fused_mode)
        else:
            a, b = codes_all[li], codes_all[ri]
            level_lcs = multi_level_lcs(a, _lengths_of(a), b, _lengths_of(b), impl=impl)
            mss = mss_scores(level_lcs, betas)
        mss = mss.masked_fill(left == PAD_ID, -1.0)
        zero = torch.zeros((1,), dtype=torch.int32, device=left.device)
        return {
            "left": left.reshape(n_shards, -1), "right": right.reshape(n_shards, -1),
            "level_lcs": level_lcs.reshape(n_shards, plan.out_cap, -1),
            "mss": mss.reshape(n_shards, -1), "overflow": zero,
            "pruned": n_pruned.reshape(n_shards),
        }

    return run
