"""Subtrajectory ("windowed") coordinates: windows as virtual rows.

Port of ``repro/core/subtraj.py``.  The subtrajectory mode
(``EngineConfig(subtraj_window=W, subtraj_stride=s)``) matches users whose
*parts* of a day match by treating every sliding window as a VIRTUAL ROW:

* trajectory ``t`` (padded length L) owns ``nw`` windows, where ``nw = 1``
  if ``L <= W`` else ``(L - W) // s + 1`` — a shape quantity derived from
  the padded length, never from per-row lengths; rows shorter than the
  padding own trailing empty windows (window length 0) that emit no keys
  and never pair;
* window ``j`` of trajectory ``t`` is global window id ``w = t * nw + j``,
  covering positions ``[j*s, j*s + W)`` clipped to the row's true length;
  ``(traj, offset) = (w // nw, (w % nw) * s)`` is what the scoring layer
  decodes to slice the resident ``[N, H, L]`` table;
* the candidate layers (shingle keys, join, dedup, capacity planning) run
  unchanged over window ids; a final host-side max-over-windows reduction
  (:func:`aggregate_window_pairs`) folds window-pair scores back to
  trajectory pairs.

``W >= L`` degenerates to ``nw = 1``, offset 0, window length = row length
— bit-identical to the whole-trajectory mode by construction.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import PAD_ID


def num_windows(max_len: int, window: int, stride: int = 1) -> int:
    """Windows per trajectory row, from the PADDED length.

    Offsets ``0, s, 2s, ...`` while a window still starts inside the padded
    row: the last window starts at the largest multiple of ``stride`` <=
    ``max_len - window``, and ``window >= max_len`` collapses to a single
    window — the whole-trajectory degeneration.
    """
    if window < 1:
        raise ValueError(f"subtraj window must be positive, got {window}")
    if stride < 1:
        raise ValueError(f"subtraj stride must be positive, got {stride}")
    if max_len <= window:
        return 1
    return (max_len - window) // stride + 1


def window_lengths(lengths, *, max_len: int, window: int, stride: int = 1):
    """Per-window valid lengths: [N] -> [N*nw] (numpy in -> numpy out,
    tensor in -> tensor out).

    Window j of row i holds ``clip(lengths[i] - j*stride, 0, min(W, L))``
    positions — what every masking and pruning layer uses in place of the
    full row length.
    """
    nw = num_windows(max_len, window, stride)
    offs = np.arange(nw, dtype=np.int32) * stride
    if isinstance(lengths, torch.Tensor):
        offs = torch.as_tensor(offs, device=lengths.device)
    return slice_lengths(lengths[:, None], offs[None, :], min(window, max_len)).reshape(-1)


def slice_lengths(lengths, off, width: int):
    """Valid positions of the window ``[off, off + width)`` of rows of
    ``lengths`` positions: ``clip(lengths - off, 0, width)``, broadcast
    (numpy or tensor).  ``width`` is the window already cut to the padded
    length, ``min(W, L)``.  The one rule every windowed layer masks by."""
    return (lengths - off).clip(0, width)


def window_coords(ids: torch.Tensor, *, nw: int, stride: int = 1):
    """Window ids [P] -> (trajectory [P], window offset [P]): ``w // nw``
    and ``(w % nw) * stride``.  PAD_ID slots decode as window 0 of row 0;
    callers mask them by pair validity."""
    w = torch.where(ids == PAD_ID, 0, ids)
    return w // nw, (w % nw) * stride


def aggregate_window_pairs(left, right, level_lcs, mss, *, nw: int):
    """Fold scored window pairs to trajectory pairs: max-over-windows MSS.

    left/right: int window ids [P] (PAD_ID rows ignored), level_lcs [P, H],
    mss [P] -> ``(tleft, tright, tlevel, tmss)`` numpy arrays with ONE row
    per distinct ``(traj_lo, traj_hi)`` pair.  Same-trajectory window pairs
    (overlapping windows of one user trivially match) are dropped; each
    surviving pair reports the WINNING window pair's integer level_lcs row
    and float32 mss, mss ties broken to the lexicographically smallest
    ``(window_lo, window_hi)`` — so the aggregate does not depend on the
    order the pairs were scored in.  Runs on the host, in numpy.
    """
    left = np.asarray(left).reshape(-1)
    right = np.asarray(right).reshape(-1)
    level_lcs = np.asarray(level_lcs).reshape(left.shape[0], -1)
    mss = np.asarray(mss).reshape(-1)
    ta, tb = left // nw, right // nw
    keep = (left != PAD_ID) & (ta != tb)
    wl, wr = left[keep], right[keep]
    lv, ms = level_lcs[keep], mss[keep]
    lo = np.minimum(ta[keep], tb[keep])
    hi = np.maximum(ta[keep], tb[keep])
    if lo.size == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty((0, level_lcs.shape[1]), lv.dtype),
                np.empty(0, np.float32))
    # group by (lo, hi); within a group the winner sorts first:
    # descending mss, then ascending (window_lo, window_hi)
    order = np.lexsort((wr, wl, -ms, hi, lo))
    lo, hi = lo[order], hi[order]
    first = np.ones(lo.shape[0], bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    rows = np.nonzero(first)[0]
    winners = order[rows]
    return (lo[rows].astype(np.int32), hi[rows].astype(np.int32),
            lv[winners], ms[winners])
