"""Model inputs of every architecture: shapes, specs and random tensors.

Port of ``repro/launch/inputs.py``.  ``input_specs`` gives ``ShapeDtype``
stand-ins (nothing is allocated; with a mesh, each carries its placement:
the batch over the dp axes, as ``input_shardings`` gives it);
``make_inputs`` materialises random tensors of the same shapes from the
reference's numpy draws, so that tokens and labels equal the reference's
and the bfloat16 features and patches are its bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.compat import Placement
from repro_torch.models.layers import COMPUTE_DTYPE, dp_axes, resolve_spec
from repro_torch.models.model import ShapeDtype


def train_input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)}: ``tokens``/``labels`` [B, S] int32, the audio
    frontend's ``features`` [B, S, d] in place of tokens, the vision
    frontend's ``vis_embed`` [B, vis_tokens, d] beside S - vis_tokens
    tokens."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        return {
            "features": ((B, S, cfg.d_model), COMPUTE_DTYPE),
            "labels": ((B, S), torch.int32),
        }
    if cfg.frontend == "vision":
        st = S - cfg.vis_tokens
        return {
            "tokens": ((B, st), torch.int32),
            "vis_embed": ((B, cfg.vis_tokens, cfg.d_model), COMPUTE_DTYPE),
            "labels": ((B, st), torch.int32),
        }
    return {
        "tokens": ((B, S), torch.int32),
        "labels": ((B, S), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> dict:
    """{name: ShapeDtype(shape, dtype)}, with each input's placement on
    ``mesh`` when one is given."""
    places = input_shardings(cfg, shape, mesh) if mesh is not None else {}
    return {name: ShapeDtype(shp, dt, places.get(name))
            for name, (shp, dt) in train_input_shapes(cfg, shape).items()}


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """{name: ``core.compat.Placement``}: dim 0 (the batch) over the dp
    axes when divisible, the rest whole."""
    return {name: Placement(mesh, resolve_spec(mesh, shp, (dp_axes(mesh),) + (None,) * (len(shp) - 1)))
            for name, (shp, _) in train_input_shapes(cfg, shape).items()}


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, device=None) -> dict:
    """Random tensors on ``device`` (None: the card): token ids uniform
    over the vocabulary, features and patches normal(0, 0.5) drawn in
    float32 and rounded to bfloat16, in the reference's draw order."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in train_input_shapes(cfg, shape).items():
        if name in ("tokens", "labels"):
            a = rng.integers(0, cfg.vocab_size, size=shp)
        else:
            a = rng.normal(scale=0.5, size=shp).astype(np.float32)
        out[name] = torch.as_tensor(a).to(device=device, dtype=dt)
    return out
