"""Int8 error-feedback gradient compression for the data-parallel sum.

Port of ``repro/train/compression.py``.  Two pieces:

* :func:`compressed_psum`, the collective over the in-process mesh
  (``core/compat.ShardMesh``): each shard's tensor is cut into blocks of
  ``BLOCK`` along the last axis, one scale a block shared by every shard
  (the ``pmax`` of the local absmaxes / 127), the int8 codes are summed in
  int32 (``psum``) and dequantized once; the result is on every shard.
* :func:`ef_compress`, the error-feedback round trip the train step runs:
  the quantization residual is carried in the train state and added back
  the next step, so the compression bias does not accumulate (Karimireddy
  et al. 2019).
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import BLOCK, dequantize_block_int8, quantize_block_int8, row_slices


def compressed_psum(xs, mesh) -> list:
    """Quantize-then-sum over the mesh's shards: ``xs`` one tensor a shard
    (one shape), -> the sum, in ``xs``' dtype, on every shard's device."""
    shape = xs[0].shape
    pad = (-shape[-1]) % BLOCK
    xbs = [torch.nn.functional.pad(x.float(), (0, pad)).reshape(shape[:-1] + (-1, BLOCK)) for x in xs]
    scales = mesh.pmax([xb.abs().amax(dim=-1, keepdim=True) for xb in xbs])
    scales = [torch.clamp(s / 127.0, min=1e-12) for s in scales]
    codes = mesh.psum([torch.clamp(torch.round(xb / s), -127, 127).to(torch.int32)
                       for xb, s in zip(xbs, scales)])
    return [(c.float() * s).reshape(shape[:-1] + (-1,))[..., :shape[-1]].to(x.dtype)
            for c, s, x in zip(codes, scales, xs)]


def _map(fn, *trees):
    first = trees[0]
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(first[k], dict) else fn(*(t[k] for t in trees))
            for k in first}


def ef_compress(grads: dict, residuals: dict):
    """Error-feedback int8 round trip: -> (the dequantized grads in their
    dtypes, the new float32 residuals, written into ``residuals``, which
    has the grads' tree).  A stacked leaf is taken in slices of dim 0 (the
    blocks run along the last axis, so the values are the whole leaf's)."""
    def one(g, r):
        out = torch.empty_like(g)
        for sl in row_slices(g):
            g32 = g[sl].float() + r[sl]
            deq = dequantize_block_int8(quantize_block_int8(g32), g32.shape)
            out[sl] = deq.to(g.dtype)
            r[sl] = g32 - deq
        return out, r

    pairs = _map(one, grads, residuals)
    return _map_pairs(pairs, 0), _map_pairs(pairs, 1)


def _map_pairs(tree, i):
    return {k: _map_pairs(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def init_residuals(params: dict) -> dict:
    return {k: init_residuals(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()}
