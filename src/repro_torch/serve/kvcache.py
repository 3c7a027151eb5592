"""KV / state caches for serving, with the reference's placements.

Port of ``repro/serve/kvcache.py``.  Cache layouts per family (leading
[L] = per layer, stacked):

  gqa    : k, v          [L, B, Smax, KH, hd]   (bf16)
  mla    : c_kv          [L, B, Smax, kv_lora]  (the normed latent)
           k_rope        [L, B, Smax, dr]       (the rotated shared key)
  ssm    : conv_x [L,B,W-1,din], conv_bc [L,B,W-1,2GN], ssm [L,B,H,P,N] f32
  hybrid : ssm caches + shared-attn sk/sv [n_inv, B, Smax, KH, hd]

and ``pos``, a 0-d int32 tensor: the number of positions filled.

Placement (:func:`cache_shardings`, the reference's rule table): the
sequence dim over ``model``, the batch over ``(pod, data)`` when
divisible (names the mesh lacks are dropped); the hybrid's shared KV at
batch 1 puts its KV heads over ``data`` instead.  The serving steps run
the cache on one device; the placements give each rank's block (the
dry-run reads per-rank bytes from them on a ``meta`` mesh).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import Placement
from repro_torch.core.device import resolve_device
from repro_torch.models.layers import COMPUTE_DTYPE, resolve_spec
from repro_torch.models.model import ShapeDtype

DP = ("pod", "data")  # the resolver drops the names a mesh lacks


def attn_axes(batch: int) -> tuple:
    """A [L, B, Smax, KH, hd] KV cache's axes: batch over the dp axes,
    the sequence over ``model``."""
    return (None, DP, "model", None, None)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{name: (shape, dtype)}."""
    return {name: (shp, dt) for name, (shp, dt, _) in _cache_layout(cfg, batch, max_len).items()}


def cache_axes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{name: the partition axes of each dim}, the reference's table."""
    return {name: axes for name, (_, _, axes) in _cache_layout(cfg, batch, max_len).items()}


def _cache_layout(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    nl = cfg.num_layers
    out: dict = {"pos": ((), torch.int32, ())}
    if cfg.family in ("ssm", "hybrid"):
        din = cfg.ssm_d_inner
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        W, G = cfg.ssm_conv, cfg.ssm_groups
        out["conv_x"] = ((nl, batch, W - 1, din), COMPUTE_DTYPE, (None, DP, None, "model"))
        out["conv_bc"] = ((nl, batch, W - 1, 2 * G * N), COMPUTE_DTYPE, (None, DP, None, None))
        out["ssm"] = ((nl, batch, H, P, N), torch.float32, (None, DP, "model", None, None))
    if cfg.family == "hybrid":
        n_inv = cfg.num_layers // cfg.shared_attn_every
        out["sk"] = out["sv"] = ((n_inv, batch, max_len, cfg.num_kv_heads, cfg.head_dim), COMPUTE_DTYPE,
                                 (None, DP, "model", "data" if batch == 1 else None, None))
    elif cfg.attn == "mla":
        out["c_kv"] = ((nl, batch, max_len, cfg.kv_lora_rank), COMPUTE_DTYPE, (None, DP, "model", None))
        out["k_rope"] = ((nl, batch, max_len, cfg.qk_rope_head_dim), COMPUTE_DTYPE,
                         (None, DP, "model", None))
    elif cfg.attn == "gqa" and cfg.family != "ssm":
        out["k"] = out["v"] = ((nl, batch, max_len, cfg.num_kv_heads, cfg.head_dim), COMPUTE_DTYPE,
                               attn_axes(batch))
    return out


def cache_shardings(cfg: ModelConfig, batch: int, max_len: int, mesh) -> dict:
    """{name: ``core.compat.Placement``} of each cache entry on ``mesh``."""
    return {name: Placement(mesh, resolve_spec(mesh, shp, axes))
            for name, (shp, _, axes) in _cache_layout(cfg, batch, max_len).items()}


def cache_shape_structs(cfg: ModelConfig, batch: int, max_len: int, mesh=None) -> dict:
    """{name: ``ShapeDtype``}, with each entry's placement when a mesh is
    given (nothing is allocated)."""
    places = cache_shardings(cfg, batch, max_len, mesh) if mesh is not None else {}
    return {name: ShapeDtype(shp, dt, places.get(name))
            for name, (shp, dt) in cache_shapes(cfg, batch, max_len).items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(shp, dtype=dt, device=device)
            for name, (shp, dt) in cache_shapes(cfg, batch, max_len).items()}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return sum(dt.itemsize * math.prod(shp)
               for shp, dt in cache_shapes(cfg, batch, max_len).values())
