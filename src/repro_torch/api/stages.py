"""Typed pipeline stages: Encode -> Candidate -> Score -> Communities.

Each stage is a small object with a ``run(ctx)`` method that reads and
writes one :class:`PipelineContext`.  Stages hold no timing code (the
instrumentation wrapper's job) and no capacity policy (the planner's).

``lcs_impl`` names and what they run:

  name                on a CUDA tensor                 on a CPU tensor
  "wavefront"         plain anti-diagonal wavefront    the same
  "ref"               plain row-DP oracle              the same
  "kernel"            Hopper LCS kernel (lcs.cu)       wavefront (small
                                                       batches) or the
                                                       kernel's plain version
  "pallas"            Hopper LCS kernel (lcs.cu)       the kernel's plain
                                                       version
  "pallas-interpret"  plain version                    the same
  "fused"             Hopper fused kernel              gather-then-score
                      (fused_score.cu)                 reference
  "fused-pallas"      Hopper fused kernel              the fused kernel's
                                                       plain version
  "fused-interpret"   fused kernel's plain version     the same

Every name yields the same ``level_lcs`` and bit-identical float32 ``mss``.
Host decisions (the ``mss > rho`` mask and the prune) run in numpy exactly
as in the JAX package, so float32-versus-Python-float comparisons match.

In the subtrajectory mode (``config.subtraj_window`` set) candidate ids are
window ids: "fused*" run the windowed fused scorer
(fused_windowed_score.cu on a CUDA tensor), the kernel family slices the
windows and runs the same LCS kernel over width-W rows, and "wavefront" and
"ref" gather the windows.  The scored window pairs are then folded to
trajectory pairs on the buffers' device (``core/subtraj.aggregate_window_pairs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import numpy as np
import torch

import repro_torch.core.communities as comm
from repro_torch.api.backends import BackendContext, CandidateBackend
from repro_torch.api.capacity import CapacityPlanner
from repro_torch.api.instrumentation import Instrumentation
from repro_torch.core.device import synchronize
from repro_torch.core.device import to_numpy as _np
from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B, SemanticForest, encode_batch
from repro_torch.core.similarity import (
    PRUNE_EPS, lcs_ref, lcs_wavefront, mss_scores, mss_upper_bound, repad,
    score_pairs, score_windowed_pairs, wavefront_dtype_from_env,
)
from repro_torch.core.subtraj import (
    aggregate_window_pairs, num_windows, window_coords, window_lengths,
)
from repro_torch.core.ssh import ssh_candidates
from repro_torch.core.types import (
    PAD_ID, CandidatePairs, EncodedBatch, ScoredPairs, TrajectoryBatch,
)
from repro_torch.kernels.lcs import ops as lcs_ops
from repro_torch.kernels.lcs.fused import FUSED_IMPL_MODES

LCS_IMPLS = (
    "wavefront", "ref", "kernel", "pallas", "pallas-interpret",
    "fused", "fused-pallas", "fused-interpret",
)

# kernel-family impls map to a dispatch mode of kernels/lcs/ops.py
_KERNEL_MODES = {"kernel": "auto", "pallas": "pallas", "pallas-interpret": "interpret"}

# fused-family impls map to a dispatch mode of kernels/lcs/fused.py
FUSED_MODES = FUSED_IMPL_MODES


def validate_lcs_impl(name: str) -> str:
    if name not in LCS_IMPLS:
        raise ValueError(
            f"unknown lcs_impl {name!r}; valid implementations: {list(LCS_IMPLS)}"
        )
    return name


def lcs_impl_fn(name: str):
    """Batched LCS ``(a [B,L], b [B,L]) -> [B]`` for an impl name.

    The fused family takes the code table plus pair indices rather than
    gathered operands, so it has no pairwise form — callers route it through
    ``kernels/lcs/fused.fused_score`` (see FUSED_MODES) instead.
    """
    validate_lcs_impl(name)
    if name in FUSED_MODES:
        raise ValueError(
            f"lcs_impl {name!r} is table-indexed (gather-free); it has no "
            "pairwise (a, b) form — dispatch through "
            "repro_torch.kernels.lcs.fused.fused_score"
        )
    dt = wavefront_dtype_from_env()
    if name in _KERNEL_MODES:
        mode = _KERNEL_MODES[name]
        return lambda a, b: lcs_ops.lcs(a, b, mode=mode, wavefront_dtype=dt)
    if name == "ref":
        return lcs_ref
    return lambda a, b: lcs_wavefront(a, b, dtype=dt)


@dataclasses.dataclass
class PipelineContext:
    """Mutable blackboard the stages read from / write to."""

    batch: TrajectoryBatch
    forest: SemanticForest
    tables: torch.Tensor
    betas: torch.Tensor
    config: Any                   # EngineConfig (kept untyped: no cycle)
    backend: CandidateBackend
    backend_ctx: BackendContext
    planner: CapacityPlanner
    instr: Instrumentation
    # stage outputs
    encoded: EncodedBatch | None = None
    keys: torch.Tensor | None = None
    candidates: CandidatePairs | None = None
    scored: ScoredPairs | None = None
    similar_pairs: set | None = None
    communities: set | None = None


class Stage(Protocol):
    name: str

    def run(self, ctx: PipelineContext) -> None: ...


class EncodeStage:
    """Phase (i): multi-level semantic encoding of the batch."""

    name = "encode"

    def run(self, ctx: PipelineContext) -> None:
        with ctx.instr.phase("encode"):
            ctx.encoded = encode_batch(ctx.batch, ctx.tables)
            synchronize(ctx.encoded.codes)


class CandidateStage:
    """Phase (ii): join keys + candidate pairs via the configured backend.

    Key-based backends go through the shared sort-merge join with planned
    capacity and overflow retries; key-less backends (legacy callables)
    produce CandidatePairs directly.
    """

    name = "candidates"

    def run(self, ctx: PipelineContext) -> None:
        backend, instr = ctx.backend, ctx.instr
        with instr.phase("keys"):
            keys = backend.join_keys(ctx.encoded, ctx.batch, ctx.backend_ctx)
            if keys is not None:
                synchronize(keys)
        ctx.keys = keys

        with instr.phase("join"):
            if keys is None:
                cand = backend.candidates(
                    ctx.encoded, ctx.batch, ctx.backend_ctx,
                    pair_capacity=ctx.config.pair_capacity or 0,
                )
                cap = int(cand.left.shape[0])
            else:
                cap = ctx.config.pair_capacity
                if cap is None:
                    cap = ctx.planner.initial_capacity(backend.expected_pairs(keys))
                cand, cap = ctx.planner.run_with_retry(
                    lambda c: ssh_candidates(keys, pair_capacity=c), cap
                )
            synchronize(cand.left)
        ctx.candidates = cand
        instr.record(
            pair_capacity=cap,
            num_candidates=int(cand.count),
            join_overflow=int(cand.overflow),
        )


class ScoreStage:
    """Phase (iii): multi-level LCS + MSS scoring, then the rho threshold.

    With ``config.score_prune`` the stage first runs the MSS upper-bound
    pruning pass: pairs whose free bound ``sum_h beta_h * min(len_a, len_b)``
    cannot clear ``rho`` are compacted away before exact scoring, into a
    buffer the CapacityPlanner sizes from the survivor count.
    """

    name = "score"

    def run(self, ctx: PipelineContext) -> None:
        cfg, cand = ctx.config, ctx.candidates
        impl = validate_lcs_impl(cfg.lcs_impl)
        L = int(ctx.encoded.codes.shape[2])
        subtraj = _subtraj_of(cfg, L)
        if cfg.score_prune:
            with ctx.instr.phase("prune"):
                if subtraj is None:
                    prune_lengths = ctx.encoded.lengths
                else:
                    # windowed candidates index per-WINDOW lengths: the MSS
                    # bound of a window pair is betas_sum * min(wlen_a, wlen_b)
                    prune_lengths = window_lengths(
                        _np(ctx.encoded.lengths), max_len=L,
                        window=subtraj[0], stride=subtraj[1],
                    )
                cand, num_pruned = prune_candidates(
                    cand, prune_lengths, ctx.betas, cfg.rho, ctx.planner
                )
            ctx.candidates = cand
            ctx.instr.record(
                num_pruned=num_pruned,
                post_prune_capacity=int(cand.left.shape[0]),
            )
        with ctx.instr.phase("score"):
            if subtraj is not None:
                level_lcs, mss = _score_windowed(
                    ctx.encoded, cand, ctx.betas, impl, subtraj
                )
            elif impl in _KERNEL_MODES:
                level_lcs, mss = _score_with_kernel(
                    ctx.encoded, cand, ctx.betas, mode=_KERNEL_MODES[impl]
                )
            else:
                level_lcs, mss = score_pairs(
                    ctx.encoded.codes, ctx.encoded.lengths,
                    cand.left, cand.right, ctx.betas, impl_name=impl,
                    wavefront_dtype=wavefront_dtype_from_env(),
                )
            synchronize(mss)

        if subtraj is not None:
            # fold scored window pairs to trajectory pairs (max over
            # windows); downstream stages and the result speak traj ids
            with ctx.instr.phase("aggregate"):
                tl, tr, tlvl, tmss = aggregate_window_pairs(
                    cand.left, cand.right, level_lcs, mss, nw=subtraj[2],
                )
                ctx.similar_pairs = {
                    (int(a), int(b))
                    for a, b, m in zip(tl.tolist(), tr.tolist(), tmss > np.float32(cfg.rho))
                    if m
                }
            dev = cand.left.device
            ctx.scored = ScoredPairs(
                left=torch.as_tensor(tl, device=dev),
                right=torch.as_tensor(tr, device=dev),
                level_lcs=torch.as_tensor(tlvl, device=dev),
                mss=torch.as_tensor(tmss, device=dev),
                count=torch.tensor(tl.shape[0], dtype=torch.int32, device=dev),
                overflow=cand.overflow,
            )
            ctx.instr.record(
                num_window_pairs=int(cand.count),
                num_traj_pairs=int(tl.shape[0]),
                num_similar=len(ctx.similar_pairs),
                subtraj_windows=subtraj[2],
            )
            return

        left_np = _np(cand.left)
        right_np = _np(cand.right)
        similar_mask = (left_np != PAD_ID) & (_np(mss) > cfg.rho)
        ctx.similar_pairs = {
            (int(a), int(b))
            for a, b in zip(left_np[similar_mask].tolist(), right_np[similar_mask].tolist())
        }
        ctx.scored = ScoredPairs(
            left=cand.left, right=cand.right, level_lcs=level_lcs, mss=mss,
            count=cand.count, overflow=cand.overflow,
        )
        ctx.instr.record(num_similar=len(ctx.similar_pairs))


class CommunitiesStage:
    """Phase (iv): communities of interest from the similar-pair graph."""

    name = "communities"

    def run(self, ctx: PipelineContext) -> None:
        cfg = ctx.config
        pairs = ctx.similar_pairs
        with ctx.instr.phase("communities"):
            if cfg.community_mode == "cliques":
                ctx.communities = comm.maximal_cliques(pairs)
            elif cfg.community_mode == "components":
                edges = np.asarray(sorted(pairs), np.int32).reshape(-1, 2)
                dev = ctx.batch.device
                labels = comm.connected_components(
                    torch.as_tensor(edges[:, 0], device=dev),
                    torch.as_tensor(edges[:, 1], device=dev),
                    num_nodes=ctx.batch.num_trajectories,
                )
                ctx.communities = comm.components_as_sets(labels)
            else:
                raise ValueError(
                    f"unknown community_mode {cfg.community_mode!r}; "
                    "valid modes: ['cliques', 'components']"
                )
        ctx.instr.record(num_communities=len(ctx.communities))


def prune_candidates(
    cand: CandidatePairs,
    lengths,
    betas,
    tau: float,
    planner: CapacityPlanner,
) -> tuple[CandidatePairs, int]:
    """MSS upper-bound pruning: drop pairs that cannot reach ``tau``.

    The bound is free — ``sum_h beta_h * min(len_a, len_b)`` needs lengths
    only — and safe: ``MSS <= bound``, so a dropped pair can never satisfy
    ``mss > tau`` (a PRUNE_EPS of slack keeps exact-threshold ties on the
    scored side).  Survivors are compacted to the front of a fresh buffer
    sized by the planner from the survivor count.  Returns (compacted
    candidates, number pruned).
    """
    left = _np(cand.left)
    right = _np(cand.right)
    lengths = _np(lengths)
    valid = left != PAD_ID
    safe_l = np.where(valid, left, 0)
    safe_r = np.where(valid, right, 0)
    bsum = float(_np(betas).astype(np.float32).sum())
    ub = mss_upper_bound(lengths[safe_l], lengths[safe_r], bsum)
    keep = valid & (ub > np.float32(tau - PRUNE_EPS))
    idx = np.nonzero(keep)[0]
    cap = planner.initial_capacity(len(idx))
    new_left = np.full((cap,), PAD_ID, np.int32)
    new_right = np.full((cap,), PAD_ID, np.int32)
    new_left[: len(idx)] = left[idx]
    new_right[: len(idx)] = right[idx]
    dev = cand.left.device
    pruned = CandidatePairs(
        left=torch.as_tensor(new_left, device=dev),
        right=torch.as_tensor(new_right, device=dev),
        count=torch.tensor(len(idx), dtype=torch.int32, device=dev),
        overflow=cand.overflow,
    )
    return pruned, int(valid.sum()) - len(idx)


def _subtraj_of(cfg, max_len: int):
    """``(window, stride, nw)`` of the subtrajectory mode, or None.

    The effective window caps at the padded length (W >= L degenerates to
    whole-trajectory) and ``nw`` derives from the PADDED length."""
    if cfg.subtraj_window is None:
        return None
    return (
        min(cfg.subtraj_window, max_len), cfg.subtraj_stride,
        num_windows(max_len, cfg.subtraj_window, cfg.subtraj_stride),
    )


def _score_windowed(encoded, cand, betas, impl, subtraj):
    """Windowed dispatch: pair ids are window ids; every impl family scores
    the windowed [H, W] slices (the fused family masks in its kernel, the
    kernel family slices via ``lcs_windowed``, the plain impls gather
    windows)."""
    if impl in _KERNEL_MODES:
        return _score_windowed_with_kernel(
            encoded, cand, betas, subtraj=subtraj, mode=_KERNEL_MODES[impl]
        )
    W, stride, nw = subtraj
    return score_windowed_pairs(
        encoded.codes, encoded.lengths, cand.left, cand.right, betas,
        nw=nw, window=W, stride=stride, impl_name=impl,
        wavefront_dtype=wavefront_dtype_from_env(),
    )


def _score_windowed_with_kernel(encoded, cand, betas, *, subtraj, mode="auto"):
    """Windowed twin of :func:`_score_with_kernel`: decode (traj, offset)
    from the window ids and run the batched LCS kernel over the sliced
    ``[P*H, W]`` windows (``kernels/lcs/ops.lcs_windowed``)."""
    W, stride, nw = subtraj
    ta, oa = window_coords(cand.left, nw=nw, stride=stride)
    tb, ob = window_coords(cand.right, nw=nw, stride=stride)
    P = ta.shape[0]
    H, L = encoded.codes.shape[1], encoded.codes.shape[2]
    rep = lambda x: torch.repeat_interleave(x, H)  # noqa: E731
    level_lcs = lcs_ops.lcs_windowed(
        encoded.codes[ta].reshape(P * H, L),
        encoded.codes[tb].reshape(P * H, L),
        rep(oa), rep(ob),
        rep(encoded.lengths[ta]), rep(encoded.lengths[tb]),
        window=W, mode=mode, wavefront_dtype=wavefront_dtype_from_env(),
    ).reshape(P, H)
    return level_lcs, mss_scores(level_lcs, betas)


def _score_with_kernel(encoded, cand, betas, *, mode="auto"):
    """Score candidates with the batched LCS kernel (kernels/lcs/ops.py)
    over two gathered, repadded ``[P*H, L]`` operand copies."""
    li = torch.where(cand.left == PAD_ID, 0, cand.left)
    ri = torch.where(cand.right == PAD_ID, 0, cand.right)
    P = li.shape[0]
    H, L = encoded.codes.shape[1], encoded.codes.shape[2]
    a = repad(encoded.codes[li], encoded.lengths[li], PAD_CODE_A).reshape(P * H, L)
    b = repad(encoded.codes[ri], encoded.lengths[ri], PAD_CODE_B).reshape(P * H, L)
    level_lcs = lcs_ops.lcs(
        a, b, mode=mode, wavefront_dtype=wavefront_dtype_from_env()
    ).reshape(P, H)
    return level_lcs, mss_scores(level_lcs, betas)
