"""GPipe-style pipeline parallelism over a ``"stage"`` axis of the
in-process mesh.

Port of ``repro/train/pipeline.py``.  With S stages (one mesh shard each)
and M microbatches the schedule runs T = M + S - 1 ticks (fill-drain): at
tick t stage s applies its slice of the parameters to microbatch t - s,
when there is one, stage 0 taking it from the input and every later stage
from the activation its predecessor handed on with ``ppermute`` at the
previous tick; the last stage's results are the output.  A stage with no
microbatch at a tick (the bubble, (S - 1) / T of the ticks) computes
nothing: the reference computes and masks to zeros, the same output.
The mesh's collectives are tensor copies, so the output is differentiable
with respect to the parameters and the input.
"""
from __future__ import annotations

import torch


def _stage_slice(tree, s: int, device):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s, device) for v in tree)
    return tree[s].to(device)


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, mesh, axis: str = "stage"):
    """Run microbatches through a linear pipeline of stages.

    ``stage_fn(params_slice, x [mb, ...]) -> y [mb, ...]`` (same shape);
    ``stage_params`` a tree of tensors with a leading [n_stages] dim (stage
    s owns slice s); ``x_micro`` [n_micro, mb, ...]; ``mesh`` a
    ``ShardMesh`` named ``axis``, one shard a stage.  Returns [n_micro, mb,
    ...] on the first shard's device."""
    if mesh.axis_name != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis!r}")
    n_stages, n_micro = mesh.size, x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    params = [_stage_slice(stage_params, s, d) for s, d in enumerate(mesh.devices)]
    x_first = x_micro.to(mesh.devices[0])
    buf = [torch.zeros_like(x_micro[0], device=d) for d in mesh.devices]
    out = [None] * n_micro
    for t in range(ticks):
        ys = []
        for s in range(n_stages):
            mb = t - s  # the microbatch stage s holds at tick t
            if not 0 <= mb < n_micro:
                ys.append(torch.zeros_like(buf[s]))
                continue
            y = stage_fn(params[s], x_first[mb] if s == 0 else buf[s])
            if s == n_stages - 1:
                out[mb] = y
            ys.append(y)
        buf = mesh.ppermute(ys, perm)
    return torch.stack([y.to(mesh.devices[0]) for y in out])
