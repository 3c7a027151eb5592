"""The executor mesh of the AnotherMe analytics plane.

``make_executor_mesh`` is the flat ``"ex"`` mesh the sharded pipeline runs
on (trajectory shards == Spark executors), one torch device per shard (see
``repro_torch.core.compat``).  It is a function, never a module constant, so
importing this module touches no device.  The JAX package's production and
smoke meshes (``data``/``model``/``pod`` axes) serve its LM training half
and have no counterpart here yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import compat


def make_executor_mesh(n_devices: int | None = None, *, devices=None) -> compat.ShardMesh:
    """A flat ``"ex"`` mesh: over ``devices`` when given (repeats allowed),
    else over the first ``n_devices`` CUDA devices (default: every one)."""
    if devices is not None:
        devices = tuple(devices)
        n = n_devices or len(devices)
    else:
        n = n_devices or torch.cuda.device_count()
    return compat.make_mesh((n,), ("ex",), devices=devices)
