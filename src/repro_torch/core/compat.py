"""The counterpart of the JAX package's ``make_mesh`` and ``shard_map``.

The JAX package drives its sharded programs from one controller: a Python
process builds a mesh of devices and runs a ``shard_map`` program over it,
whose collectives (``all_to_all``, ``all_gather``, ``pmax``, ``psum``)
move buffers between the shards.  The analytics plane runs on a flat
``"ex"`` axis; the LM scaffold on ``("data", "model")`` or ``("pod",
"data", "model")``.  Here one Python process drives a tuple of torch
devices, one per rank:

* a :class:`ShardMesh` holds the devices in rank order (row-major over the
  axes, as JAX lays a device array out) with ``axis_names`` and ``shape``
  (axis name -> size, as JAX's ``mesh.shape``); a device may be listed
  more than once, so ``("cuda:0",) * 4`` runs four ranks on one card and
  ``("cpu",) * 4`` four on the CPU (the counterpart of the forced host
  device count the JAX package's multi-device runs use), and ``("meta",)
  * 256`` gives per-rank shapes and bytes without allocating anything;
* a shard program runs as a loop over the ranks between collectives
  (bulk-synchronous phases): each local step is a list comprehension over
  the ranks' tensors, and each collective is a mesh method that takes one
  tensor per rank and returns, for each receiver, a tensor on the
  receiver's device.  On a mesh of two or three axes a collective takes
  an axis name (or a tuple of names) and works within each group of ranks
  that share their coordinates on the other axes, as ``jax.lax.psum(x,
  "model")`` does; without an axis it spans every rank;
* a :class:`Placement` is a partition spec over a mesh (the counterpart of
  ``NamedSharding``): each rank's block of a global tensor, as a view on
  the rank's device; ranks that share a device and a block share one
  tensor, so weights replicated over ``"data"`` are never copied per rank
  on one card;
* :func:`shard_map` splits the global inputs by their specs, calls the
  program once with one list per input, and reassembles its outputs.

The ranks run one after another, with no stream concurrency: the order of
operations, and so every buffer, is the one the program spells out.  Each
collective adds its operands' bytes, summed over the ranks, to
``mesh.collective_bytes`` under the reference's HLO names
(``launch/hlo_analysis.py``'s ``collective_bytes`` sums each device's
operand bytes the same way); ``reset_collective_bytes`` zeroes them.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "all-to-all", "collective-permute")


class P(tuple):
    """A partition spec: one entry a dimension, ``None`` (not split), an
    axis name, or a tuple of axis names (split over their product, the
    first name major).  ``P("ex", None)`` splits dimension 0 over ``"ex"``;
    ``P(None, None)`` (or ``P()``) replicates."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


class ShardMesh:
    """Ranks on torch devices, over one axis (``axis_name``) or over
    ``axis_names`` of sizes ``shape``."""

    def __init__(self, devices: Sequence, axis_name: str = "ex", *, axis_names=None, shape=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        if axis_names is None:
            axis_names, shape = (axis_name,), (len(self.devices),)
        axis_names, shape = tuple(axis_names), tuple(int(s) for s in shape)
        if len(axis_names) != len(shape) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names {axis_names} do not name the axes of shape {shape}")
        if math.prod(shape) != len(self.devices):
            raise ValueError(f"a mesh of shape {shape} given {len(self.devices)} devices")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        # the flat mesh's one axis (the analytics plane's programs read it)
        self.axis_name = axis_names[0] if len(axis_names) == 1 else None
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ShardMesh({axes}, devices={list(map(str, self.devices))})"

    def reset_collective_bytes(self) -> None:
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def _count(self, kind: str, xs) -> None:
        self.collective_bytes[kind] += _nbytes(xs)

    # -- coordinates ----------------------------------------------------------
    def coords(self, rank: int) -> tuple:
        """Rank ``rank``'s coordinate on each axis (row-major)."""
        out = []
        for n in reversed(self.shape.values()):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def axis_index(self, axis: str | None = None):
        """``lax.axis_index``: each rank's coordinate on ``axis`` (on a
        flat mesh, with no axis: shard i of the loop is shard i of the
        axis)."""
        if axis is None:
            if self.axis_name is None:
                raise ValueError(f"name an axis of {self.axis_names}")
            return range(self.size)
        return [self._group_position(r, _names(axis)) for r in range(self.size)]

    def _group_position(self, rank: int, names: tuple) -> int:
        """The row-major index of ``rank``'s coordinates on ``names``."""
        c = dict(zip(self.axis_names, self.coords(rank)))
        pos = 0
        for a in names:
            pos = pos * self.shape[a] + c[a]
        return pos

    def groups(self, axis=None) -> list:
        """The groups of ranks a collective over ``axis`` (a name or a
        tuple of names; None: every axis) spans: ranks sharing their
        coordinates on the other axes, each group ordered by the position
        on ``axis``."""
        names = self.axis_names if axis is None else _names(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not an axis of {self.axis_names}")
        rest = [a for a in self.axis_names if a not in names]
        by_key: dict = {}
        for r in range(self.size):
            c = dict(zip(self.axis_names, self.coords(r)))
            by_key.setdefault(tuple(c[a] for a in rest), []).append(r)
        return [sorted(g, key=lambda r: self._group_position(r, names)) for g in by_key.values()]

    # -- placement ------------------------------------------------------------
    def shard_rows(self, x: torch.Tensor) -> list:
        """``P(axis, None)`` on a flat mesh: the i-th of ``size`` equal row
        blocks on shard i."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split into {self.size} equal shards")
        return Placement(self, P(tuple(self.axis_names))).place(x)

    def replicate(self, x: torch.Tensor) -> list:
        """``P(None, ...)``: one copy on each rank's device; ranks that
        share a device share the tensor (``x`` itself on its own device)."""
        return Placement(self, P()).place(x)

    def stack(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Out spec ``P(axis)`` on a flat mesh: the shards' tensors stacked
        along a new leading shard axis, on the first shard's device."""
        return torch.stack([x.to(self.devices[0]) for x in xs])

    def _per_device(self, make: Callable, ranks=None) -> list:
        made: dict = {}
        ranks = range(self.size) if ranks is None else ranks
        for r in ranks:
            d = self.devices[r]
            if d not in made:
                made[d] = make(d)
        return [made[self.devices[r]] for r in ranks]

    # -- collectives ----------------------------------------------------------
    def _over_groups(self, xs, axis, one: Callable) -> list:
        """``one(group, tensors of the group)`` -> the group's outputs, in
        group order; assembled into one output a rank."""
        if len(xs) != self.size:
            raise ValueError(f"a collective over {self.size} ranks given {len(xs)} tensors")
        out = [None] * self.size
        for g in self.groups(axis):
            for r, y in zip(g, one(g, [xs[r] for r in g])):
                out[r] = y
        return out

    def all_to_all(self, xs: Sequence[torch.Tensor], axis=None) -> list:
        """``all_to_all(split_axis=0, concat_axis=0, tiled=True)``: each
        source's leading axis holds one equal bucket a group member, bucket
        j addressed to member j; member j gets the concatenation, in group
        order, of each source's bucket j."""
        self._count("all-to-all", xs)

        def one(g, ys):
            parts = [y.unflatten(0, (len(g), -1)) for y in ys]
            return [torch.cat([p[j].to(self.devices[r]) for p in parts]) for j, r in enumerate(g)]

        return self._over_groups(xs, axis, one)

    def all_gather(self, xs: Sequence[torch.Tensor], axis=None) -> list:
        """``all_gather(axis=0, tiled=True)``: the group's tensors
        concatenated in group order, on every member's device (members that
        share a device share the result; callers do not write into it)."""
        self._count("all-gather", xs)
        return self._over_groups(xs, axis, lambda g, ys: self._per_device(
            lambda d: torch.cat([y.to(d) for y in ys]), g))

    def pmax(self, xs: Sequence[torch.Tensor], axis=None) -> list:
        """``pmax``: the elementwise maximum over the group, on every
        member's device."""
        self._count("all-reduce", xs)

        def one(g, ys):
            m = ys[0].to(self.devices[g[0]])
            for y in ys[1:]:
                m = torch.maximum(m, y.to(self.devices[g[0]]))
            return self._per_device(lambda d: m.to(d), g)

        return self._over_groups(xs, axis, one)

    def psum(self, xs: Sequence[torch.Tensor], axis=None) -> list:
        """``psum``: the elementwise sum over the group, in group order, on
        every member's device."""
        self._count("all-reduce", xs)

        def one(g, ys):
            total = ys[0].to(self.devices[g[0]])
            for y in ys[1:]:
                total = total + y.to(self.devices[g[0]])
            return self._per_device(lambda d: total.to(d), g)

        return self._over_groups(xs, axis, one)

    def pmean(self, xs: Sequence[torch.Tensor], axis=None) -> list:
        """``pmean``: :meth:`psum` divided by the group's size."""
        n = len(self.groups(axis)[0])
        return [s / n for s in self.psum(xs, axis)]

    def ppermute(self, xs: Sequence[torch.Tensor], perm, axis=None) -> list:
        """``ppermute``: within each group, for each ``(src, dst)`` of
        ``perm`` (positions in the group) member ``dst`` receives member
        ``src``'s tensor, on its device; a member that is no pair's
        destination receives zeros."""
        self._count("collective-permute", [xs[g[src]] for g in self.groups(axis) for src, _ in perm])

        def one(g, ys):
            out = [torch.zeros_like(y) for y in ys]
            for src, dst in perm:
                out[dst] = ys[src].to(self.devices[g[dst]])
            return out

        return self._over_groups(xs, axis, one)


class Placement:
    """A partition spec over a mesh, the counterpart of ``NamedSharding``:
    dimension i of a tensor is cut into ``spec[i]``'s axis sizes' product
    of equal blocks, and a rank holds the block its coordinates index (the
    ranks that differ on the axes the spec does not name hold the same
    block)."""

    def __init__(self, mesh: ShardMesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"Placement({tuple(self.spec)})"

    def _cuts(self, shape) -> list:
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {tuple(self.spec)} has more entries than shape {tuple(shape)}")
        cuts = []
        for i, n in enumerate(shape):
            names = _names(self.spec[i]) if i < len(self.spec) else ()
            k = math.prod(self.mesh.shape[a] for a in names)
            if n % k:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not split into {k} blocks")
            cuts.append((names, k))
        return cuts

    def shard_shape(self, shape) -> tuple:
        """One rank's block shape of a tensor of ``shape``."""
        return tuple(n // k for n, (_, k) in zip(shape, self._cuts(shape)))

    def index(self, rank: int, shape) -> tuple:
        """Rank ``rank``'s block of a tensor of ``shape``, as slices."""
        out = []
        for n, (names, k) in zip(shape, self._cuts(shape)):
            b = n // k
            i = self.mesh._group_position(rank, names) if names else 0
            out.append(slice(i * b, (i + 1) * b))
        return tuple(out)

    def place(self, x: torch.Tensor) -> list:
        """Each rank's block of ``x`` on its device: a view of ``x`` (``x``
        itself for a whole block) where the rank's device is ``x``'s, one
        tensor for the ranks that share a device and a block."""
        made: dict = {}
        out = []
        for r, d in enumerate(self.mesh.devices):
            idx = self.index(r, x.shape)
            key = (d, tuple((s.start, s.stop) for s in idx))
            if key not in made:
                whole = all(s.stop - s.start == n for s, n in zip(idx, x.shape))
                made[key] = (x if whole else x[idx]).to(d)
            out.append(made[key])
        return out

    def assemble(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global tensor of the ranks' blocks ``xs`` (the first rank
        holding each block), on rank 0's device."""
        first: dict = {}
        for r in range(self.mesh.size):
            key = tuple(self.mesh._group_position(r, _names(e)) for e in self.spec)
            first.setdefault(key, r)

        def build(dim, prefix):
            if dim == len(self.spec):
                return xs[first[prefix]].to(self.mesh.devices[0])
            k = math.prod(self.mesh.shape[a] for a in _names(self.spec[dim]))
            parts = [build(dim + 1, prefix + (i,)) for i in range(k)]
            return parts[0] if k == 1 else torch.cat(parts, dim=dim)

        return build(0, ())


def make_mesh(axis_shapes, axis_names, *, devices=None) -> ShardMesh:
    """A mesh of ``prod(axis_shapes)`` ranks on the axes ``axis_names``
    (one, two or three: the flat ``"ex"`` mesh, the LM's ``("data",
    "model")`` and ``("pod", "data", "model")``).

    ``devices`` lists one device per rank in rank order (repeats allowed,
    ``"meta"`` for shapes without allocation); by default the first ``n``
    CUDA devices, and fewer cards than ranks raise.
    """
    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if not 1 <= len(axis_shapes) <= 3 or len(axis_names) != len(axis_shapes):
        raise ValueError(f"a mesh of one to three axes, got shape {axis_shapes} named {axis_names}")
    n = math.prod(axis_shapes)
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
    if len(axis_names) == 1:
        return ShardMesh(devices, axis_names[0])
    return ShardMesh(devices, axis_names=axis_names, shape=axis_shapes)


def shard_map(fn: Callable, *, mesh: ShardMesh, in_specs, out_specs) -> Callable:
    """Run ``fn`` as a program over the mesh's ranks.

    ``fn`` is called once, with one list per input holding each rank's
    piece, and returns one list of per-rank tensors per output.  On a flat
    mesh an input whose spec shards dimension 0 over the axis is cut into
    row blocks (the replicated tensor otherwise), and an output whose spec
    names the axis is stacked along a new leading shard axis
    (``mesh.stack``; the analytics plane's layout).  On a mesh of two or
    three axes every spec is a :class:`Placement`: inputs are cut into
    each rank's block, and outputs reassembled from the ranks' blocks as
    JAX concatenates them (a replicated output is rank 0's tensor).
    """
    if mesh.axis_name is not None:
        return _flat_shard_map(fn, mesh, in_specs, out_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} inputs, got {len(args)}")
        pieces = [Placement(mesh, s).place(a) for a, s in zip(args, in_specs)]
        outs = list(fn(*pieces))
        for k, s in enumerate(out_specs):
            outs[k] = Placement(mesh, s).assemble(outs[k])
        return tuple(outs)

    return run


def _flat_shard_map(fn, mesh, in_specs, out_specs):
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
