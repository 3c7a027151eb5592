"""The counterpart of the JAX package's ``make_mesh`` and ``shard_map``.

The JAX package drives its sharded programs from one controller: a Python
process builds a mesh of devices and runs a ``shard_map`` program over a flat
``"ex"`` axis, whose collectives (``all_to_all``, ``all_gather``, ``pmax``)
move buffers between the shards.  Here one Python process drives a tuple of
torch devices, one per shard:

* a :class:`ShardMesh` holds the devices; a device may be listed more than
  once, so ``("cuda:0",) * 4`` runs four shards on one card and
  ``("cpu",) * 4`` four shards on the CPU (the counterpart of the forced host
  device count the JAX package's multi-shard runs use);
* a shard program runs as a loop over the shards between collectives
  (bulk-synchronous phases): each local step is a list comprehension over
  the shards' tensors, and each collective is a mesh method that takes one
  tensor per shard and returns, for each receiver, a tensor on the
  receiver's device (``all_to_all``, ``all_gather``, ``pmax``, ``psum``,
  ``ppermute``);
* :func:`shard_map` splits the global inputs by their specs (row blocks for
  ``P(axis, None)``, one copy per shard for ``P(None, ...)``), calls the
  program once with one list per input, and stacks its per-shard outputs.

The shards run one after another, with no stream concurrency: the order of
operations, and so every buffer, is the one the program spells out.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class P(tuple):
    """A partition spec: ``P("ex", None)`` splits dimension 0 over the axis
    ``"ex"`` in row blocks; ``P(None, None)`` (or ``P()``) replicates."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class ShardMesh:
    """A flat mesh: one torch device per shard along ``axis_name``."""

    def __init__(self, devices: Sequence, axis_name: str = "ex"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ShardMesh({self.axis_name}={self.size}, devices={list(map(str, self.devices))})"

    def axis_index(self) -> range:
        """``lax.axis_index``: shard i of the loop is shard i of the axis."""
        return range(self.size)

    # -- placement ------------------------------------------------------------
    def shard_rows(self, x: torch.Tensor) -> list:
        """``P(axis, None)``: the i-th of ``size`` equal row blocks on shard i."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split into {self.size} equal shards")
        b = n // self.size
        return [x[i * b:(i + 1) * b].to(d) for i, d in enumerate(self.devices)]

    def replicate(self, x: torch.Tensor) -> list:
        """``P(None, ...)``: one copy on each shard's device (shards that
        share a device share the copy)."""
        return self._per_device(lambda d: x.to(d))

    def stack(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Out spec ``P(axis)``: the shards' tensors stacked along a new
        leading shard axis, on the first shard's device."""
        return torch.stack([x.to(self.devices[0]) for x in xs])

    def _per_device(self, make: Callable) -> list:
        made: dict = {}
        for d in self.devices:
            if d not in made:
                made[d] = make(d)
        return [made[d] for d in self.devices]

    # -- collectives ----------------------------------------------------------
    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """``all_to_all(split_axis=0, concat_axis=0, tiled=True)``: each
        source's leading axis holds ``size`` equal buckets, bucket j
        addressed to shard j; receiver j gets the concatenation, in source
        order, of each source's bucket j."""
        n = self.size
        parts = [x.unflatten(0, (n, -1)) for x in xs]
        return [torch.cat([p[j].to(d) for p in parts]) for j, d in enumerate(self.devices)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """``all_gather(axis=0, tiled=True)``: the shards' tensors
        concatenated in shard order, on every shard's device (shards that
        share a device share the result; callers do not write into it)."""
        return self._per_device(lambda d: torch.cat([x.to(d) for x in xs]))

    def pmax(self, xs: Sequence[torch.Tensor]) -> list:
        """``pmax``: the elementwise maximum over the shards, on every
        shard's device."""
        m = xs[0].to(self.devices[0])
        for x in xs[1:]:
            m = torch.maximum(m, x.to(self.devices[0]))
        return self._per_device(lambda d: m.to(d))

    def psum(self, xs: Sequence[torch.Tensor]) -> list:
        """``psum``: the elementwise sum over the shards, in shard order, on
        every shard's device."""
        total = xs[0].to(self.devices[0])
        for x in xs[1:]:
            total = total + x.to(self.devices[0])
        return self._per_device(lambda d: total.to(d))

    def ppermute(self, xs: Sequence[torch.Tensor], perm) -> list:
        """``ppermute``: for each ``(src, dst)`` of ``perm`` shard ``dst``
        receives shard ``src``'s tensor, on its device; a shard that is no
        pair's destination receives zeros."""
        out = [torch.zeros_like(x) for x in xs]
        for src, dst in perm:
            out[dst] = xs[src].to(self.devices[dst])
        return out


def make_mesh(axis_shapes, axis_names, *, devices=None) -> ShardMesh:
    """A flat mesh of ``axis_shapes[0]`` shards named ``axis_names[0]``.

    ``devices`` lists one device per shard (repeats allowed); by default the
    first ``n`` CUDA devices, and fewer cards than shards raise.  Only a
    one-axis mesh exists here: the JAX package's two- and three-axis
    production meshes belong to its LM training half.
    """
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    if len(axis_shapes) != 1 or len(axis_names) != 1:
        raise ValueError(f"only a flat one-axis mesh is supported, got {axis_names}")
    n = int(axis_shapes[0])
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"a mesh of {n} shards needs {n} CUDA devices, have {have}; "
                "pass devices=(...) to place several shards on one device"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(devices)
    if len(devices) != n:
        raise ValueError(f"mesh of {n} shards given {len(devices)} devices")
    return ShardMesh(devices, axis_names[0])


def shard_map(fn: Callable, *, mesh: ShardMesh, in_specs, out_specs) -> Callable:
    """Run ``fn`` as a program over the mesh's shards.

    ``fn`` is called once, with one list per input holding each shard's
    piece (row blocks for an input whose spec shards dimension 0 over the
    mesh axis, the replicated tensor otherwise), and returns one list of
    per-shard tensors per output.  An output whose spec names the axis is
    stacked along a new leading shard axis (``mesh.stack``); a replicated
    output is shard 0's tensor.
    """
    def sharded(spec) -> bool:
        return len(spec) > 0 and spec[0] == mesh.axis_name

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} inputs, got {len(args)}")
        pieces = [mesh.shard_rows(a) if sharded(s) else mesh.replicate(a)
                  for a, s in zip(args, in_specs)]
        outs = list(fn(*pieces))
        for k, s in enumerate(out_specs):  # stack one output at a time, freeing its shards
            outs[k] = mesh.stack(outs[k]) if sharded(s) else outs[k][0]
        return tuple(outs)

    return run
