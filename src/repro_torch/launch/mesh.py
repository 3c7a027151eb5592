"""Production, smoke and executor meshes.

Port of ``repro/launch/mesh.py``.  Each mesh is built by a function, never
a module constant, so importing this module touches no device.  A mesh is
a ``core.compat.ShardMesh``: one torch device per rank, in rank order
(see ``repro_torch.core.compat``).

* ``make_production_mesh``: ``(data=16, model=16)``, 256 ranks, or with
  ``multi_pod`` ``(pod=2, data=16, model=16)``, 512 ranks; the ``pod``
  axis carries data-parallel replication, model collectives stay inside a
  pod.  The dry-run builds them on ``meta`` devices
  (``devices=("meta",) * 256``) to read per-rank shapes and bytes.
* ``make_smoke_mesh``: ``(1, 1)`` on ``("data", "model")``.
* ``make_executor_mesh``: every rank on one ``"ex"`` axis, for the
  AnotherMe analytics plane (trajectory shards == Spark executors).

Without ``devices`` each takes the first CUDA devices and raises with
fewer cards than ranks; ``devices=(card,) * n`` places n ranks on one card.
"""
from __future__ import annotations

import torch

from repro_torch.core import compat


def make_production_mesh(multi_pod: bool = False, *, devices=None) -> compat.ShardMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes, devices=devices)


def make_smoke_mesh(*, devices=None) -> compat.ShardMesh:
    """One rank with the production axis names."""
    return compat.make_mesh((1, 1), ("data", "model"), devices=devices)


def make_executor_mesh(n_devices: int | None = None, *, devices=None) -> compat.ShardMesh:
    """A flat ``"ex"`` mesh: over ``devices`` when given (repeats allowed),
    else over the first ``n_devices`` CUDA devices (default: every one)."""
    if devices is not None:
        devices = tuple(devices)
        n = n_devices or len(devices)
    else:
        n = n_devices or torch.cuda.device_count()
    return compat.make_mesh((n,), ("ex",), devices=devices)
