"""The "User-defined" baseline (paper section V.1): same logic, black box.

Port of ``repro/core/udf.py``, copied: it is pure Python and NumPy.  The
paper's key systems finding is that wrapping the whole algorithm in a Spark
UDF (identical four phases, but opaque to the engine's optimizer) is
slower than the centralized version at scale.  The analogue here: the same
AnotherMe phases as per-row Python loops that no kernel ever sees.  It
produces the same results as AnotherMe (it is the same logic).
"""
from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np

from repro_torch.core.device import to_numpy
from repro_torch.core.encoding import SemanticForest


def udf_pipeline(
    places,
    lengths,
    forest: SemanticForest,
    *,
    k: int = 3,
    betas: np.ndarray | None = None,
    rho: float = 2.0,
) -> tuple[set[tuple[int, int]], dict[tuple[int, int], float]]:
    """Run all four phases row-at-a-time in pure Python. Returns
    (similar pair set, {pair: mss}).  ``places``/``lengths`` are arrays or
    tensors on any device."""
    places = to_numpy(places)
    lengths = to_numpy(lengths)
    maps = forest.level_maps()
    n_levels = len(maps)
    if betas is None:
        betas = np.full((n_levels,), 1.0 / n_levels)

    # phase (i): per-row semantic encoding
    encs = []
    for i in range(places.shape[0]):
        row = places[i, : lengths[i]]
        encs.append([tuple(int(m[p]) for p in row) for m in maps])

    # phase (ii): per-row shingling + hash-partition via a dict
    buckets: dict[tuple, list[int]] = defaultdict(list)
    for i, enc in enumerate(encs):
        types = enc[0]
        for combo in set(itertools.combinations(types, k)):
            buckets[combo].append(i)

    candidates: set[tuple[int, int]] = set()
    for members in buckets.values():
        for a, b in itertools.combinations(sorted(set(members)), 2):
            candidates.add((a, b))

    # phase (iii): per-pair multi-level LCS
    def lcs(a, b):
        la, lb = len(a), len(b)
        dp = [[0] * (lb + 1) for _ in range(la + 1)]
        for i in range(1, la + 1):
            for j in range(1, lb + 1):
                if a[i - 1] == b[j - 1]:
                    dp[i][j] = dp[i - 1][j - 1] + 1
                else:
                    dp[i][j] = max(dp[i - 1][j], dp[i][j - 1])
        return dp[la][lb]

    scores: dict[tuple[int, int], float] = {}
    similar: set[tuple[int, int]] = set()
    for a, b in candidates:
        mss = sum(
            float(betas[h]) * lcs(encs[a][h], encs[b][h]) for h in range(n_levels)
        )
        scores[(a, b)] = mss
        if mss > rho:
            similar.add((a, b))
    return similar, scores
