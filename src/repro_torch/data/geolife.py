"""GeoLife surrogate: GPS traces -> stay points -> semantic trajectories.

The real GeoLife dataset (17,621 trajectories, 182 users; Zheng et al.) is
not redistributable offline, so we generate a statistically-matched
surrogate and run the SAME preprocessing the paper describes (section V.1):

1. synthesize GPS traces as POI-anchored random walks: each user has a home/
   work anchor set drawn from a city POI grid, moves between POIs, and dwells
   at them (dwell > tau  => stay point);
2. stay-point detection (Li et al. 2008): a maximal window of fixes within
   ``dist_thresh`` meters spanning more than ``time_thresh`` seconds becomes
   a stay point at the window centroid;
3. map stay points to the nearest POI -> semantic place name.

The output is a TrajectoryBatch + SemanticForest shaped like GeoLife after
semantic conversion, preserving the properties that matter to AnotherMe:
heavy-tailed POI popularity, strong home/work recurrence (repetition!), and
user-specific behavioural motifs.

Port of ``repro/data/geolife.py``: the arrays are drawn with numpy's RNG in
the same order as the JAX package (the forest from its own generator, then
the POI grid, anchors, trajectories and, with ``fast=False``, the GPS round
trip), so both packages build the same world from a seed; only the final
arrays become tensors, on ``device`` (the card unless the caller names
another).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.encoding import SemanticForest, make_random_forest
from repro_torch.core.types import PAD_PLACE, TrajectoryBatch
from repro_torch.interop import batch_from_numpy

EARTH_M_PER_DEG = 111_320.0


def _stay_points(
    fixes_xy: np.ndarray,
    fixes_t: np.ndarray,
    *,
    dist_thresh: float = 200.0,
    time_thresh: float = 20 * 60.0,
) -> np.ndarray:
    """Li et al. stay-point detection on one trace. Returns centroids [M, 2]."""
    pts = []
    i, n = 0, len(fixes_t)
    while i < n:
        j = i + 1
        while j < n:
            d = np.linalg.norm(fixes_xy[j] - fixes_xy[i])
            if d > dist_thresh:
                break
            j += 1
        if fixes_t[min(j, n) - 1] - fixes_t[i] > time_thresh and j - i >= 2:
            pts.append(fixes_xy[i:j].mean(axis=0))
            i = j
        else:
            i += 1
    return np.asarray(pts).reshape(-1, 2)


def geolife_surrogate(
    *,
    num_users: int = 182,
    num_traj: int = 17_621,
    num_pois: int = 800,
    num_types: int = 30,
    classes_per_type: int = 10,
    max_len_pad: int = 16,
    seed: int = 0,
    fast: bool = True,
    device=None,
) -> tuple[TrajectoryBatch, SemanticForest]:
    """Generate the surrogate.  ``fast=True`` (default) synthesizes stay
    points directly from the behavioural model; ``fast=False`` additionally
    round-trips every trajectory through raw GPS fixes + stay-point
    detection (used by tests to validate the detector).  The batch's
    tensors lie on ``device`` (None: the card)."""
    rng = np.random.default_rng(seed)
    forest = make_random_forest(num_types, classes_per_type, num_pois, seed=seed)

    # city POI grid with Zipf popularity
    poi_xy = rng.uniform(0, 20_000, size=(num_pois, 2))
    popularity = 1.0 / np.arange(1, num_pois + 1)
    popularity /= popularity.sum()

    # per-user anchors: home, work + a few favourites (behavioural motifs)
    homes = rng.integers(0, num_pois, size=num_users)
    works = rng.integers(0, num_pois, size=num_users)
    favs = rng.integers(0, num_pois, size=(num_users, 4))

    traj_user = rng.integers(0, num_users, size=num_traj).astype(np.int32)
    lengths = rng.integers(4, max_len_pad - 2, size=num_traj).astype(np.int32)
    places = np.full((num_traj, max_len_pad), PAD_PLACE, dtype=np.int32)

    for t in range(num_traj):
        u = traj_user[t]
        seq = [homes[u]]
        while len(seq) < lengths[t] - 1:
            r = rng.random()
            if r < 0.30:
                seq.append(works[u])
            elif r < 0.55:
                seq.append(favs[u, rng.integers(0, 4)])
            else:
                seq.append(rng.choice(num_pois, p=popularity))
            # dwell: repeat with prob 0.2 (stay of 2*tau)
            if rng.random() < 0.2 and len(seq) < lengths[t] - 1:
                seq.append(seq[-1])
        seq.append(homes[u])  # day ends at home
        lengths[t] = len(seq)
        places[t, : len(seq)] = seq

    if not fast:
        # validate the GPS round-trip on a sample: emit fixes along the
        # sequence with dwells, run stay-point detection, re-map to POIs
        sample = rng.choice(num_traj, size=min(64, num_traj), replace=False)
        for t in sample:
            seq = places[t, : lengths[t]]
            fixes, times = [], []
            clock = 0.0
            for p in seq:
                for _ in range(6):  # 6 fixes over a 30-min dwell
                    fixes.append(poi_xy[p] + rng.normal(scale=30.0, size=2))
                    times.append(clock)
                    clock += 300.0
                clock += 900.0  # travel gap
            sp = _stay_points(np.asarray(fixes), np.asarray(times))
            # nearest-POI mapping
            if len(sp):
                d = np.linalg.norm(sp[:, None, :] - poi_xy[None], axis=-1)
                mapped = d.argmin(axis=1).astype(np.int32)
                m = min(len(mapped), max_len_pad)
                # collapse immediate duplicates produced by long dwells is NOT
                # done: repetition encodes stay duration (paper section IV.1)
                places[t, :] = PAD_PLACE
                places[t, :m] = mapped[:m]
                lengths[t] = m

    return batch_from_numpy(places, lengths, traj_user, device=device), forest
