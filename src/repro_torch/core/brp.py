"""Bucketed Random Projection baseline (Spark's BRP LSH; paper section V.1).

Port of ``repro/core/brp.py``.  Each trajectory's type-level count vector
(bag of types) is projected onto random unit vectors; the bucket index
floor(proj / bucket_length) is the hash key.  Like MinHash this discards
visiting order entirely and, with coarse buckets, even most frequency
information: the paper observes BRP "missing almost all the correct
communities" (Fig. 10).

The projection is a float32 matrix product, as in the reference, and the
bucket edges depend on its summation order: :func:`brp_bucket_keys` raises
when the device would run a float32 matmul in reduced precision (TF32 or
bf16; PyTorch's default is full float32), and the tests hold the keys equal
on their worlds.  The keys feed the same sort-merge join as SSH/MinHash.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssh import ssh_candidates
from repro_torch.core.types import CandidatePairs

_MERSENNE = (1 << 31) - 1


def projections(num_types: int, num_proj: int, seed: int) -> np.ndarray:
    """float32 [num_types, num_proj] random unit columns, drawn with numpy's
    ``default_rng(seed)`` and normalised in float32, as the reference does."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(num_types, num_proj)).astype(np.float32)
    r /= np.linalg.norm(r, axis=0, keepdims=True)
    return r


def type_counts(type_codes: torch.Tensor, lengths: torch.Tensor, num_types: int) -> torch.Tensor:
    """float32 [N, Q] counts of each type over a row's valid positions.

    The reference sums a one-hot of ``where(valid, codes, Q)`` over
    positions and drops the Q column; a scatter-add of ones gives the same
    small integers without the [N, L, Q + 1] one-hot (a code outside
    [0, Q) has an all-zero one-hot row there, so it counts nowhere here)."""
    n, L = type_codes.shape
    valid = torch.arange(L, device=type_codes.device)[None, :] < lengths[:, None]
    valid &= (type_codes >= 0) & (type_codes < num_types)
    idx = torch.where(valid, type_codes, num_types).long()
    counts = torch.zeros((n, num_types + 1), dtype=torch.float32, device=type_codes.device)
    counts.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    return counts[:, :num_types]


def reduced_fp32_matmul(device: torch.device) -> str | None:
    """The reduced precision a float32 matmul runs in on ``device`` ("tf32",
    "bf16"), or None when it runs in full float32."""
    if device.type == "cuda":
        matmul = torch.backends.cuda.matmul
        if not hasattr(matmul, "fp32_precision"):     # PyTorch < 2.9
            return "tf32" if matmul.allow_tf32 else None
    else:
        matmul = getattr(torch.backends.mkldnn, "matmul", None)
    prec = getattr(matmul, "fp32_precision", "ieee")
    return None if prec in ("ieee", "none") else prec


def brp_bucket_keys(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_types: int,
    num_proj: int = 4,
    bucket_length: float = 2.0,
    seed: int = 0,
) -> torch.Tensor:
    """int32 [N, 1] AND-composed bucket keys of the type-count vectors."""
    reduced = reduced_fp32_matmul(type_codes.device)
    if reduced is not None:
        raise RuntimeError(
            f"brp_bucket_keys needs full float32 matmul, but {type_codes.device.type} "
            f"runs it in {reduced}: the bucket keys would differ from the reference's "
            "(set torch.backends.*.matmul.fp32_precision = 'ieee')"
        )
    counts = type_counts(type_codes, lengths, num_types)
    r = torch.as_tensor(projections(num_types, num_proj, seed), device=counts.device)
    proj = counts @ r                                     # [N, num_proj] float32
    # divide by a float32 tensor: a Python-scalar divisor may be taken as
    # a multiply by its reciprocal, which rounds differently
    bucket = torch.floor(proj / torch.full_like(proj, bucket_length)).to(torch.int32)
    # AND-composition (Spark semantics): one composite key per hash table —
    # a candidate must fall in the same bucket for EVERY projection; the
    # key wraps in int32 before the floor-mod, as in the reference
    space = 1 << 16
    bucket = bucket.clamp(-(space // 2), space // 2 - 1) + space // 2
    key = torch.zeros((bucket.shape[0],), dtype=torch.int32, device=bucket.device)
    for i in range(num_proj):
        key = (key * 1_000_003 + bucket[:, i]) % _MERSENNE
    return key.abs()[:, None]


def brp_candidates(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_types: int,
    num_proj: int = 4,
    bucket_length: float = 2.0,
    pair_capacity: int,
    seed: int = 0,
) -> CandidatePairs:
    keys = brp_bucket_keys(
        type_codes, lengths, num_types=num_types, num_proj=num_proj,
        bucket_length=bucket_length, seed=seed,
    )
    return ssh_candidates(keys, pair_capacity=pair_capacity)
