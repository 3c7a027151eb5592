"""Core data types for the AnotherMe semantic-trajectory engine (PyTorch).

Plain dataclasses of tensors; every tensor of one structure lives on one
device.  Padding conventions (identical to the JAX package, so buffers
compare element for element):

* trajectories: place ids are int32 >= 0; padding slot = ``PAD_PLACE`` (-1).
* shingle keys: valid keys are int32 in [0, Q**k); padding = ``PAD_KEY``
  (INT32_MAX) so that an ascending sort pushes padding to the end and padding
  never joins with a real key.
* pair slots: invalid pair = (PAD_ID, PAD_ID) with PAD_ID = INT32_MAX.
"""
from __future__ import annotations

import dataclasses

import torch

PAD_PLACE = -1
PAD_KEY = 2**31 - 1
PAD_ID = 2**31 - 1


@dataclasses.dataclass
class TrajectoryBatch:
    """A batch of semantic trajectories (Definition 1 of the paper).

    places:  int32 [N, L_max]  place (name-level) ids, PAD_PLACE-padded.
             Repeated places encode stay duration (paper section IV.1).
    lengths: int32 [N]         true number of places per trajectory.
    user_id: int32 [N]         owning user (trajectory id == row index).
    """

    places: torch.Tensor
    lengths: torch.Tensor
    user_id: torch.Tensor

    @property
    def num_trajectories(self) -> int:
        return self.places.shape[0]

    @property
    def max_len(self) -> int:
        return self.places.shape[1]

    @property
    def device(self) -> torch.device:
        return self.places.device

    def valid_mask(self) -> torch.Tensor:
        pos = torch.arange(self.max_len, dtype=torch.int32, device=self.device)
        return pos[None, :] < self.lengths[:, None]


@dataclasses.dataclass
class EncodedBatch:
    """Multi-level semantic encodings of a TrajectoryBatch.

    codes:   int32 [N, n_levels, L_max]  per-place code at each level.
             Level 0 is the COARSEST ("type"), level n-1 the finest ("name").
             Padded positions carry PAD_CODE_A (see encoding.py).
    lengths: int32 [N].
    """

    codes: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_levels(self) -> int:
        return self.codes.shape[1]


@dataclasses.dataclass
class CandidatePairs:
    """Output of the SSH join: candidate similar pairs, exactly-once.

    left/right: int32 [P_cap]  trajectory ids, PAD_ID in unused slots.
    count:      int32 []       number of valid pairs.
    overflow:   int32 []       pairs dropped because P_cap was too small
                               (the host retries with doubled capacity).
    """

    left: torch.Tensor
    right: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor

    def valid_mask(self) -> torch.Tensor:
        return self.left != PAD_ID


@dataclasses.dataclass
class ScoredPairs:
    """Candidate pairs with multi-level similarity scores (Definition 4)."""

    left: torch.Tensor
    right: torch.Tensor
    level_lcs: torch.Tensor  # int32 [P_cap, n_levels]  |M_h| per level
    mss: torch.Tensor        # float32 [P_cap]          sum_h beta_h * |M_h|
    count: torch.Tensor
    overflow: torch.Tensor

    def valid_mask(self) -> torch.Tensor:
        return self.left != PAD_ID
