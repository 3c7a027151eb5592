"""Centralized baseline (paper section V.1): exact all-pairs MSS.

Port of ``repro/core/centralized.py``.  Scores every C(N,2) pair — no
hashing, no partitioning.  This is the ground truth of the QA1/QA2 accuracy
metrics and of the paper's speedup claim.  It runs on one device (the
encoded batch's), in fixed-size chunks of pairs so memory stays bounded
(the paper's centralized approach hits memory explosion at 60k
trajectories; the chunking bounds memory but not time).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.similarity import default_betas, score_pairs, wavefront_dtype_from_env
from repro_torch.core.types import EncodedBatch


def all_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def centralized_similar_pairs(
    encoded: EncodedBatch,
    *,
    rho: float,
    betas: torch.Tensor | None = None,
    chunk: int = 1 << 16,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact similar-pair set: returns numpy (left, right, mss) with
    float32 mss > rho, in row-major pair order."""
    dev = encoded.codes.device
    n = encoded.codes.shape[0]
    if betas is None:
        betas = default_betas(encoded.num_levels, device=dev)
    li, ri = all_pairs(n)
    out_l, out_r, out_s = [], [], []
    for s in range(0, li.shape[0], chunk):
        # pad the tail chunk to the chunk's shape, as the reference does
        l = np.zeros((chunk,), np.int32)
        r = np.zeros((chunk,), np.int32)
        m = min(chunk, li.shape[0] - s)
        l[:m], r[:m] = li[s : s + m], ri[s : s + m]
        _, mss = score_pairs(
            encoded.codes, encoded.lengths,
            torch.as_tensor(l, device=dev), torch.as_tensor(r, device=dev), betas,
            wavefront_dtype=wavefront_dtype_from_env(),
        )
        mss = mss.cpu().numpy()[:m]
        keep = mss > rho
        out_l.append(li[s : s + m][keep])
        out_r.append(ri[s : s + m][keep])
        out_s.append(mss[keep])
    if not out_l:
        z = np.zeros((0,), np.int32)
        return z, z, np.zeros((0,), np.float32)
    return np.concatenate(out_l), np.concatenate(out_r), np.concatenate(out_s)
