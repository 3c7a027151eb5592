"""Seeded random weights, made on the device in a few large calls.

Every leaf of the layout (``perfbench/reference/lm.py::layout``) is a view
of one of two flat buffers, one a storage dtype.  The bfloat16 buffer is
filled by ``normal_`` from a generator on the device seeded with the run's
seed, in slices of :data:`SLICE` elements, and each leaf is then scaled by
its own factor; the float32 leaves (norms, the SSM's dynamics) are drawn
after it from the same generator.  The same seed on the same device gives
the same weights, so the reference can make them again after the program
has changed its own.
"""
from __future__ import annotations

import math

import torch


SLICE = 1 << 30
# the weights' generator and the tokens' generator are seeded apart
WEIGHTS_STREAM = 0x5EED_0001


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 0x9E3779B1 + stream) % (1 << 63))


def walk(tree: dict, path: tuple = ()):
    """(path, value) of every leaf of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, path + (k,))
        else:
            yield path + (k,), v


def _sizes(layout: dict) -> dict:
    sizes: dict = {}
    for _, leaf in walk(layout):
        sizes[leaf.dtype] = sizes.get(leaf.dtype, 0) + math.prod(leaf.shape)
    return sizes


def views(layout: dict, flats: list) -> dict:
    """The weight tree of ``layout`` as views of ``flats`` (one flat buffer
    a storage dtype, in the order :func:`make` returns them)."""
    by_dtype = {f.dtype: f for f in flats}
    at = dict.fromkeys(by_dtype, 0)
    tree: dict = {}
    for path, leaf in walk(layout):
        n = math.prod(leaf.shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = by_dtype[leaf.dtype][at[leaf.dtype]:at[leaf.dtype] + n].view(leaf.shape)
        at[leaf.dtype] += n
    return tree


def make(layout: dict, seed: int, device) -> tuple:
    """(the weight tree, [the flat buffers]) for ``layout`` and ``seed``."""
    g = generator(seed, WEIGHTS_STREAM, device)
    flats = [torch.empty(n, dtype=dt, device=device) for dt, n in _sizes(layout).items()]
    tree = views(layout, flats)
    bf = next((f for f in flats if f.dtype == torch.bfloat16), None)
    if bf is not None:
        for i in range(0, bf.numel(), SLICE):
            bf[i:i + SLICE].normal_(generator=g)
    for path, leaf in walk(layout):
        v = tree
        for k in path:
            v = v[k]
        if leaf.dtype == torch.bfloat16:
            if leaf.init != "normal":
                raise ValueError(f"bfloat16 leaf {path} must be drawn normal")
            v.mul_(leaf.scale)
        elif leaf.init == "normal":
            v.normal_(generator=g).mul_(leaf.scale)
        elif leaf.init == "ones":
            v.fill_(1.0)
        elif leaf.init == "A_log":          # A = -exp(A_log), -A uniform in [1, 16]
            v.uniform_(1.0, 16.0, generator=g).log_()
        elif leaf.init == "dt_bias":        # softplus(dt_bias) uniform in [1e-3, 1e-1]
            v.uniform_(1e-3, 1e-1, generator=g)
            v.add_(torch.log(-torch.expm1(-v)))
        else:
            raise ValueError(f"unknown init {leaf.init!r} of {path}")
    return tree, flats


def check_layout(layout: dict, program: dict) -> None:
    """The benchmark's weight layout must be the program's, leaf for leaf."""
    mine = {p: (tuple(leaf.shape), leaf.dtype) for p, leaf in walk(layout)}
    theirs = {p: (tuple(s.shape), s.dtype) for p, s in walk(program)}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()), key=str)[:6]
        raise ValueError(f"the benchmark's weight layout is not the program's: {diff}")
