"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the reference works out."""
from __future__ import annotations

import statistics

import torch


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float32."""
    got, ref = got.float(), ref.float()
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref).clamp(min=1e-30))


def worst_rel_l2(got: torch.Tensor, ref: torch.Tensor, keep_dims: int) -> float:
    """The largest relative L2 gap over the leading ``keep_dims`` dims of
    ``ref`` (each of them its own vector): e.g. each layer, or each layer
    and position of a cache."""
    got = got[tuple(slice(0, n) for n in ref.shape)].float()
    ref = ref.float()
    lead = ref.shape[:keep_dims]
    diff = torch.linalg.vector_norm((got - ref).reshape(*lead, -1), dim=-1)
    norm = torch.linalg.vector_norm(ref.reshape(*lead, -1), dim=-1).clamp(min=1e-30)
    return float((diff / norm).max())


def worst_norm_gap(got: dict, ref: dict, leave_out=()) -> float:
    """The largest gap between two norms of one leaf, ``|got - ref|``,
    over the larger of the reference's norm of that leaf and of the
    median leaf; leaves in ``leave_out`` are not compared.  A leaf the
    program does not report reads 1."""
    floor = statistics.median(ref.values())
    worst = 0.0
    for name, r in ref.items():
        if name in leave_out:
            continue
        if name not in got:
            return 1.0
        worst = max(worst, abs(got[name] - r) / max(r, floor, 1e-30))
    return worst
