"""Phase (i): semantic encoding via the semantic forest (paper section IV.1).

The semantic forest organises places into ``n_levels`` granularities, finest
(place name) to coarsest (place type).  A place name id is mapped to its code
at every level through composed parent lookups, producing the paper's
``E_type.E_class.E_name`` encoding as an int32 tensor ``[N, n_levels, L]``.

The forest is represented densely with numpy: ``parents[l]`` maps a
level-(l+1) id to its level-l parent id (level 0 = coarsest).  It is built
with numpy's RNG exactly as the JAX package builds it, so both packages
rebuild the same world from a seed; only :func:`forest_tables` makes it a
tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device, to_numpy
from repro_torch.core.types import PAD_PLACE, EncodedBatch, TrajectoryBatch

# Padding sentinels for encoded codes.  Two *different* negative values for
# the two sides of a comparison guarantee padded positions never match
# (similarity.py relies on this).
PAD_CODE_A = -1
PAD_CODE_B = -2


@dataclasses.dataclass(frozen=True)
class SemanticForest:
    """A dense n-level semantic forest.

    parents[l][child_id] -> parent id at level l, for l in [0, n_levels-2];
    parents[l] maps level-(l+1) ids into level-l ids.
    sizes[l] = number of distinct codes at level l (coarsest first).
    """

    parents: tuple  # tuple of np.ndarray[int32]
    sizes: tuple    # tuple of int

    @property
    def num_levels(self) -> int:
        return len(self.sizes)

    @property
    def num_types(self) -> int:
        """Vocabulary size at the coarsest ("type") level — the SSH alphabet Q."""
        return self.sizes[0]

    @property
    def num_places(self) -> int:
        return self.sizes[-1]

    def level_maps(self) -> list[np.ndarray]:
        """For each level l, an array mapping place (name) id -> level-l code."""
        maps = [np.arange(self.sizes[-1], dtype=np.int32)]
        for l in range(self.num_levels - 2, -1, -1):
            maps.append(self.parents[l][maps[-1]])
        maps.reverse()  # coarsest first
        return maps


def make_random_forest(
    num_types: int,
    classes_per_type: int,
    num_places: int,
    *,
    n_levels: int = 3,
    seed: int = 0,
) -> SemanticForest:
    """Generate a random semantic forest matching the paper's synthetic setup
    (30 types x 10 classes, 10,000 place names; 300 types for scalability).

    For ``n_levels != 3`` the intermediate levels are built by repeated
    uniform fan-out so Fig. 15's 2..6-level hierarchies are reproducible.
    """
    rng = np.random.default_rng(seed)
    if n_levels == 2:
        sizes = [num_types, num_places]
    elif n_levels == 3:
        sizes = [num_types, num_types * classes_per_type, num_places]
    else:
        ratio = (num_places / num_types) ** (1.0 / (n_levels - 1))
        sizes = [max(1, int(round(num_types * ratio**i))) for i in range(n_levels)]
        sizes[0], sizes[-1] = num_types, num_places
        for i in range(1, n_levels):  # enforce monotone growth
            sizes[i] = max(sizes[i], sizes[i - 1])
    parents = []
    for l in range(len(sizes) - 1):
        # each level-(l+1) id gets a uniformly random level-l parent; every
        # parent keeps at least one child through round-robin seeding
        child_n, parent_n = sizes[l + 1], sizes[l]
        p = rng.integers(0, parent_n, size=child_n).astype(np.int32)
        p[:parent_n] = np.arange(parent_n, dtype=np.int32)
        rng.shuffle(p)
        parents.append(p)
    return SemanticForest(parents=tuple(parents), sizes=tuple(sizes))


def forest_tables(forest: SemanticForest, device=None) -> torch.Tensor:
    """Stack the level maps into one int32 [n_levels, num_places] tensor."""
    return torch.as_tensor(
        np.stack(forest.level_maps(), axis=0), device=resolve_device(device)
    )


def encode_codes(
    places: torch.Tensor, tables: torch.Tensor, *, pad_code: int = PAD_CODE_A
) -> torch.Tensor:
    """Raw-tensor encoding: place ids [N, L] -> int32 codes [N, n_levels, L]."""
    pad = places == PAD_PLACE
    safe = torch.where(pad, 0, places)
    codes = tables[:, safe].permute(1, 0, 2).to(torch.int32)  # [N, H, L]
    return torch.where(pad[:, None, :], pad_code, codes).contiguous()


def encode_types(
    places: torch.Tensor, tables: torch.Tensor, *, pad_code: int = PAD_CODE_A
) -> torch.Tensor:
    """Coarsest-level ("type") codes only: place ids [N, L] -> int32 [N, L]."""
    pad = places == PAD_PLACE
    types = tables[0, torch.where(pad, 0, places)].to(torch.int32)
    return torch.where(pad, pad_code, types)


def encode_batch(
    batch: TrajectoryBatch, tables: torch.Tensor, *, pad_code: int = PAD_CODE_A
) -> EncodedBatch:
    """Map each place id through every forest level: [N, L] -> [N, n_levels, L].

    Padded positions become ``pad_code``.
    """
    codes = encode_codes(batch.places, tables, pad_code=pad_code)
    return EncodedBatch(codes=codes, lengths=batch.lengths)


def type_codes(encoded: EncodedBatch) -> torch.Tensor:
    """The coarsest-level view used by SSH: int32 [N, L]."""
    return encoded.codes[:, 0, :]


def encode_places(place_ids: Sequence[int], tables) -> list[str]:
    """Human-readable dotted encodings ("E_type.E_class.E_name") for demos;
    ``tables`` is the [n_levels, num_places] forest table, a tensor on any
    device or an array."""
    out = []
    tables = to_numpy(tables)
    for p in place_ids:
        out.append(".".join(str(int(tables[l, p])) for l in range(tables.shape[0])))
    return out
