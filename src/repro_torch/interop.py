"""Hand numpy arrays to the port.

What crosses between the JAX package and the port is the world (forest and
trajectories), intermediate buffers and, for the LM scaffold, a parameter
tree.  Each function here takes numpy arrays only, so a caller can feed
both packages the same inputs and compare them stage by stage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import SemanticForest
from repro_torch.core.types import CandidatePairs, TrajectoryBatch
from repro_torch.models.model import PS, build_param_specs


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


def _tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a copy: arrays handed over may be read-only views
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def lm_params_from_numpy(tree, cfg, device=None) -> dict:
    """The port's parameters from the reference's parameter tree (nested
    dicts of numpy arrays: per-layer leaves stacked ``[L, ...]`` under
    ``blocks``, the hybrid's shared block under ``shared``), leaf for leaf
    in the arrays' own dtypes.  Raises if the tree's keys or shapes differ
    from ``build_param_specs(cfg)``."""
    device = resolve_device(device)

    def convert(node, spec, path):
        if isinstance(spec, PS):
            t = _tensor(node, device)
            if tuple(t.shape) != tuple(spec.shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                                 f"the spec says {tuple(spec.shape)}")
            return t
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {got}, the spec has {sorted(spec)}")
        return {k: convert(node[k], spec[k], path + (k,)) for k in spec}

    return convert(tree, build_param_specs(cfg), ())
