"""Hand numpy arrays to the port.

This system has no weights; what crosses between the JAX package and the
port is the world (forest and trajectories) and intermediate buffers.  Each
function here takes numpy arrays only, so a caller can feed both packages
the same inputs and compare them stage by stage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import SemanticForest
from repro_torch.core.types import CandidatePairs, TrajectoryBatch


def _i32(x, device) -> torch.Tensor:
    # a copy: arrays handed over (e.g. from JAX) may be read-only views
    return torch.as_tensor(np.array(x, dtype=np.int32), device=device)


def forest_from_numpy(parents, sizes) -> SemanticForest:
    """A forest from its parent maps (coarsest first) and level sizes."""
    return SemanticForest(
        parents=tuple(np.asarray(p, np.int32) for p in parents),
        sizes=tuple(int(s) for s in sizes),
    )


def batch_from_numpy(places, lengths, user_id=None, *, device=None) -> TrajectoryBatch:
    """A trajectory batch from int [N, L] places and int [N] lengths."""
    device = resolve_device(device)
    places = _i32(places, device)
    if user_id is None:
        user_id = np.arange(places.shape[0], dtype=np.int32)
    return TrajectoryBatch(
        places=places, lengths=_i32(lengths, device), user_id=_i32(user_id, device)
    )


def candidates_from_numpy(left, right, count, overflow, *, device=None) -> CandidatePairs:
    """A candidate buffer from [P_cap] pair ids and the two scalar counters."""
    device = resolve_device(device)
    return CandidatePairs(
        left=_i32(left, device), right=_i32(right, device),
        count=_i32(count, device).reshape(()),
        overflow=_i32(overflow, device).reshape(()),
    )
