"""Public op: minhash signatures through the Hopper kernel.

Port of ``repro/kernels/minhash/ops.py``.  The TPU op padded the batch to a
multiple of its row block; the CUDA launch masks its ragged edge itself, so
the op only builds the ``(a, b)`` table and calls the kernel wrapper.  On a
CUDA tensor it launches ``kernels/csrc/minhash.cu``; on a CPU tensor the
wrapper runs the plain version.  The engine's MinHash backend keys through
this op.
"""
from __future__ import annotations

import torch

from repro_torch.core.minhash import hash_table
from repro_torch.kernels.minhash.kernel import minhash_kernel


def minhash_signatures(
    types: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_perm: int = 16,
    seed: int = 0,
) -> torch.Tensor:
    """int32 [N, L] + [N] -> int32 [N, num_perm] minhash signatures."""
    return minhash_kernel(types, lengths, hash_table(num_perm, seed, types.device))
