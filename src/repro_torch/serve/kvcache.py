"""KV / state caches for serving.

Port of ``repro/serve/kvcache.py`` for one device (no shardings).  Cache
layouts per family (leading [L] = per layer, stacked):

  gqa    : k, v          [L, B, Smax, KH, hd]   (bf16)
  mla    : c_kv          [L, B, Smax, kv_lora]  (the normed latent)
           k_rope        [L, B, Smax, dr]       (the rotated shared key)
  ssm    : conv_x [L,B,W-1,din], conv_bc [L,B,W-1,2GN], ssm [L,B,H,P,N] f32
  hybrid : ssm caches + shared-attn sk/sv [n_inv, B, Smax, KH, hd]

and ``pos``, a 0-d int32 tensor: the number of positions filled.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.layers import COMPUTE_DTYPE


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{name: (shape, dtype)}."""
    nl = cfg.num_layers
    out: dict = {"pos": ((), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        din = cfg.ssm_d_inner
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        W, G = cfg.ssm_conv, cfg.ssm_groups
        out["conv_x"] = ((nl, batch, W - 1, din), COMPUTE_DTYPE)
        out["conv_bc"] = ((nl, batch, W - 1, 2 * G * N), COMPUTE_DTYPE)
        out["ssm"] = ((nl, batch, H, P, N), torch.float32)
    if cfg.family == "hybrid":
        n_inv = cfg.num_layers // cfg.shared_attn_every
        kv = ((n_inv, batch, max_len, cfg.num_kv_heads, cfg.head_dim), COMPUTE_DTYPE)
        out["sk"] = out["sv"] = kv
    elif cfg.attn == "mla":
        out["c_kv"] = ((nl, batch, max_len, cfg.kv_lora_rank), COMPUTE_DTYPE)
        out["k_rope"] = ((nl, batch, max_len, cfg.qk_rope_head_dim), COMPUTE_DTYPE)
    elif cfg.attn == "gqa" and cfg.family != "ssm":
        kv = ((nl, batch, max_len, cfg.num_kv_heads, cfg.head_dim), COMPUTE_DTYPE)
        out["k"] = out["v"] = kv
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    device = resolve_device(device)
    return {name: torch.zeros(shp, dtype=dt, device=device)
            for name, (shp, dt) in cache_shapes(cfg, batch, max_len).items()}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return sum(dt.itemsize * math.prod(shp)
               for shp, dt in cache_shapes(cfg, batch, max_len).values())
