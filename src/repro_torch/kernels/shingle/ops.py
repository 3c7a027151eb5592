"""Public op: shingle keys from the Hopper kernel + the dedup around it.

Port of ``repro/kernels/shingle/ops.py``.  The kernel produces the raw
C(L, k) combination keys; the distinct-per-row set semantics (the paper
joins on DISTINCT shingles) are restored here with a row sort + duplicate
masking + sort, as in ``core/shingling.py``.  Neither engine calls this op:
the SSH backend keys through ``core/shingling.shingles_from_types``.
"""
from __future__ import annotations

import torch

from repro_torch.core.shingling import num_shingles
from repro_torch.core.types import PAD_KEY
from repro_torch.kernels.shingle.kernel import shingle_kernel


def shingle_keys(
    types: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    num_types: int,
    dedup: bool = True,
) -> torch.Tensor:
    """int32 [N, L] types + [N] lengths -> int32 [N, S_pad] keys, with
    ``S_pad = ceil(C(L, k) / 128) * 128`` (the reference's lane-aligned
    width), distinct and ascending per row when ``dedup``."""
    L = types.shape[1]
    s_pad = -(-num_shingles(L, k) // 128) * 128
    keys = shingle_kernel(types, lengths, k=k, num_types=num_types, s_pad=s_pad)
    if dedup:
        keys = torch.sort(keys, dim=-1).values
        dup = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        dup[:, 1:] = keys[:, 1:] == keys[:, :-1]
        keys = torch.sort(torch.where(dup, PAD_KEY, keys), dim=-1).values
    return keys
