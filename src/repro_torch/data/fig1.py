"""The paper's Fig. 1 example world, as data.

Carol lives in Sydney, Dave in Chicago; their trajectories never overlap
geographically, yet both are frequent flyers visiting
lodging -> airports -> company -> dining -> airports -> lodging.  The
pipeline must place them in the same community while keeping the
stay-at-home neighbour out.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.encoding import SemanticForest
from repro_torch.core.types import PAD_PLACE, TrajectoryBatch
from repro_torch.interop import batch_from_numpy

TYPES = ["lodging", "transportation", "business", "dining"]
CLASSES = ["apartment", "hotel", "airport", "station", "company",
           "fast_food", "fine_dinner"]
NAMES = ["Maris Apartment", "Windy Apartment", "Beach House",
         "Sydney Airport", "O'Hare Airport", "Tokyo Airport",
         "Paris-CDG", "Facebook Japan", "Microsoft France", "KFC Tokyo",
         "Restaurant Goude"]
CLASS_TO_TYPE = np.array([0, 0, 1, 1, 2, 3, 3], np.int32)
NAME_TO_CLASS = np.array([0, 0, 0, 2, 2, 2, 2, 4, 4, 5, 6], np.int32)

PEOPLE = {
    "Carol (Sydney)": ["Maris Apartment", "Sydney Airport", "O'Hare Airport",
                       "Tokyo Airport", "Facebook Japan", "KFC Tokyo",
                       "Tokyo Airport", "Sydney Airport", "Maris Apartment"],
    "Dave (Chicago)": ["Windy Apartment", "O'Hare Airport", "Paris-CDG",
                       "Microsoft France", "Restaurant Goude", "Paris-CDG",
                       "O'Hare Airport", "Windy Apartment"],
    "Homebody": ["Beach House", "KFC Tokyo", "Beach House", "KFC Tokyo",
                 "Beach House"],
}


def fig1_world(device=None) -> tuple[TrajectoryBatch, SemanticForest]:
    """(batch, forest) for the Fig. 1 scenario; row order follows PEOPLE."""
    forest = SemanticForest(
        parents=(CLASS_TO_TYPE, NAME_TO_CLASS),
        sizes=(len(TYPES), len(CLASSES), len(NAMES)),
    )
    name_id = {n: i for i, n in enumerate(NAMES)}
    L = max(len(t) for t in PEOPLE.values())
    rows, lens = [], []
    for traj in PEOPLE.values():
        ids = [name_id[p] for p in traj]
        rows.append(ids + [PAD_PLACE] * (L - len(ids)))
        lens.append(len(ids))
    batch = batch_from_numpy(
        np.asarray(rows, np.int32), np.asarray(lens, np.int32), device=device
    )
    return batch, forest
