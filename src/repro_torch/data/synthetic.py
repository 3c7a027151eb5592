"""Synthetic trajectory generator matching the paper's setup (section V.1).

"The synthetic dataset contains up to 1 million trajectories.  The length of
each trajectory ... varies from 5 to 10 ... Each location ... randomly
selected from 10,000 places.  The number of synthetic place type is 30 and
the number of classes in each type is 10."  (300 types for the scalability
round.)

Stay-duration repetition (section IV.1: a stay of n*tau appears n times) is
modelled with ``repeat_prob``.  The arrays are drawn with numpy's RNG in the
same order as the JAX package, so both packages build the same world from a
seed; only the final arrays become tensors, on ``device`` (the card unless
the caller names another).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.encoding import SemanticForest, make_random_forest
from repro_torch.core.types import PAD_PLACE, TrajectoryBatch
from repro_torch.interop import batch_from_numpy


def synthetic_trajectories(
    num_traj: int,
    *,
    num_places: int = 10_000,
    min_len: int = 5,
    max_len: int = 10,
    repeat_prob: float = 0.15,
    seed: int = 0,
    max_len_pad: int | None = None,
    device=None,
) -> TrajectoryBatch:
    rng = np.random.default_rng(seed)
    L = max_len_pad or max_len
    lengths = rng.integers(min_len, max_len + 1, size=num_traj).astype(np.int32)
    places = rng.integers(0, num_places, size=(num_traj, L)).astype(np.int32)
    # stay-duration repetition: copy the previous place forward with prob p
    if repeat_prob > 0:
        rep = rng.random(size=(num_traj, L)) < repeat_prob
        rep[:, 0] = False
        for j in range(1, L):
            places[:, j] = np.where(rep[:, j], places[:, j - 1], places[:, j])
    mask = np.arange(L)[None, :] < lengths[:, None]
    places = np.where(mask, places, PAD_PLACE)
    return batch_from_numpy(places, lengths, device=device)


def synthetic_setup(
    num_traj: int,
    *,
    num_types: int = 30,
    classes_per_type: int = 10,
    num_places: int = 10_000,
    n_levels: int = 3,
    seed: int = 0,
    device=None,
    **traj_kwargs,
) -> tuple[TrajectoryBatch, SemanticForest]:
    """Paper section V.1 defaults: (trajectories, forest)."""
    forest = make_random_forest(
        num_types, classes_per_type, num_places, n_levels=n_levels, seed=seed
    )
    batch = synthetic_trajectories(
        num_traj, num_places=num_places, seed=seed + 1, device=device,
        **traj_kwargs,
    )
    return batch, forest
