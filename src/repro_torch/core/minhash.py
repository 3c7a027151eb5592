"""MinHashLSH baseline (Spark's built-in hash, reproduced; paper section V.1).

Port of ``repro/core/minhash.py``.  Each trajectory is encoded at the type
level into a binary presence set (order and repetition are discarded: the
information loss that costs MinHash its accuracy in Figs. 10/12), minhash
signatures are computed with universal hashing h_i(x) = (a_i * x + b_i) mod
p, and banding groups trajectories whose band signatures collide.  The
banded keys feed the same sort-merge join as SSH (core/ssh.py).

The reference evaluates the hash in int32 with a 16-bit limb split whose
products and sums wrap: its signatures are NOT the exact (a*x + b) mod
(2^31 - 1), and most of them are negative.  The port replays those int32
operations one for one (``kernels/minhash/kernel.py``'s plain version and
``kernels/csrc/minhash.cu``), so its signatures, band keys and candidates
are the reference's.  An exact hash would change the candidates.

:func:`minhash_signatures` (and with it :func:`minhash_candidates` and the
engine's MinHash backend) goes through ``kernels/minhash/ops``: the Hopper
kernel on a CUDA tensor, the plain version on a CPU one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssh import ssh_candidates
from repro_torch.core.types import CandidatePairs

_MERSENNE = (1 << 31) - 1


def _hash_params(num_perm: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The (a, b) of each permutation: int64 [num_perm] each, drawn from
    numpy's ``default_rng(seed)`` as the reference draws them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, size=num_perm, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, size=num_perm, dtype=np.int64)
    return a, b


def hash_table(num_perm: int, seed: int, device) -> torch.Tensor:
    """int32 [num_perm, 2] table of (a, b), the kernel's ``ab`` operand."""
    a, b = _hash_params(num_perm, seed)
    return torch.as_tensor(np.stack([a, b], axis=1).astype(np.int32), device=device)


def minhash_signatures(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_perm: int = 16,
    seed: int = 0,
) -> torch.Tensor:
    """Minhash signatures of the type-level presence sets.

    type_codes int32 [N, L] -> int32 [N, num_perm].  The one signature entry
    point: ``kernels/minhash/ops.minhash_signatures``, which launches the
    Hopper kernel on a CUDA tensor and runs the plain version on a CPU one.
    """
    # imported here: the kernels package imports ``repro_torch.core``
    from repro_torch.kernels.minhash.ops import minhash_signatures as op

    return op(type_codes, lengths, num_perm=num_perm, seed=seed)


def minhash_band_keys(
    signatures: torch.Tensor, *, bands: int, key_space: int | None = None
) -> torch.Tensor:
    """LSH banding: hash each band of the signature into one int32 key.

    Bands are salted so keys from different bands never collide; the output
    int32 [N, bands] plugs directly into ssh_candidates' sort-merge join.
    ``key * 1_000_003 + sig`` wraps in int32 before the floor-mod, as in
    the reference.
    """
    n, num_perm = signatures.shape
    if num_perm % bands:
        raise ValueError(f"num_perm = {num_perm} must be divisible by bands = {bands}")
    if key_space is None:
        key_space = (2**31 - 2) // bands  # salted keys stay within int32
    # the salt keeps band-b keys in [b*key_space, (b+1)*key_space) c [0, 2^31-2]
    if bands * key_space >= 2**31:
        raise ValueError(f"bands * key_space = {bands} * {key_space} overflows int32")
    rows = num_perm // bands
    sig = signatures.to(torch.int32).reshape(n, bands, rows)
    key = torch.zeros((n, bands), dtype=torch.int32, device=signatures.device)
    for r in range(rows):
        key = (key * 1_000_003 + sig[:, :, r]) % key_space
    salt = torch.arange(bands, dtype=torch.int32, device=signatures.device)[None, :] * key_space
    return key.abs() + salt


def minhash_candidates(
    type_codes: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_perm: int = 16,
    bands: int = 4,
    pair_capacity: int,
    seed: int = 0,
) -> CandidatePairs:
    sig = minhash_signatures(type_codes, lengths, num_perm=num_perm, seed=seed)
    keys = minhash_band_keys(sig, bands=bands)
    return ssh_candidates(keys, pair_capacity=pair_capacity)
