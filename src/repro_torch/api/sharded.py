"""Host helpers of the JAX package's sharded execution that one device needs.

Port of ``_positive_hash_np`` and ``_pow2`` from ``repro/api/sharded.py``:
the streaming and serving slices size their buffers with them.  The
sharded pipelines themselves (``n_shards > 1``) are not ported yet.
"""
from __future__ import annotations

import numpy as np

_MIX = np.int32(np.uint32(2654435761 % (1 << 31)))  # Knuth multiplicative mix


def _positive_hash_np(x: np.ndarray) -> np.ndarray:
    """The JAX package's key-to-shard hash with exact int32 wraparound, so
    capacity planning sees the shard destinations the device join would."""
    x = np.asarray(x).astype(np.int32)
    with np.errstate(over="ignore"):
        h = (x * _MIX) ^ (x >> 13)
    return np.abs(h)


def _pow2(x: int, floor_pow2: int = 4) -> int:
    """The smallest power of two >= ``x`` and >= ``2**floor_pow2``."""
    return 1 << max(floor_pow2, int(np.ceil(np.log2(max(int(x), 1)))))
