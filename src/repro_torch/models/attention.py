"""Attention blocks: GQA (Llama/Qwen/Granite style) prefill and decode.

Port of ``repro/models/attention.py`` for one device.  The prefill path
goes through ``layers.chunked_attention`` (the flash-attention kernel on the
card); decode is plain tensor arithmetic over the cache, as in the
reference.  MLA (``attn="mla"``) is not ported and raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.api.errors import NotPortedError
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import chunked_attention, rope


def _qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """q/k/v projections, fused ``wqkv`` or split ``wq``/``wk``/``wv``, with
    the optional biases."""
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in p:
        qkv = x @ p["wqkv"].to(x.dtype)
        if cfg.qkv_bias:
            qkv = qkv + p["bqkv"].to(x.dtype)
        return torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def gqa_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor):
    """Projected and rotated (q [B,S,H,D], k [B,S,KH,D], v [B,S,KH,D])."""
    B, S, _ = x.shape
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv_proj(x, p, cfg)
    q = rope(q.reshape(B, S, H, D), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KH, D), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KH, D)


def gqa_attention(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor,
                  *, return_kv: bool = False):
    """x [B,S,d] -> [B,S,d] (and the rotated k, v for a cache when
    ``return_kv``).  p: ``wqkv`` or ``wq``/``wk``/``wv``, ``wo``, biases."""
    B, S, _ = x.shape
    q, k, v = gqa_qkv(x, p, cfg, positions)
    out = chunked_attention(q, k, v, causal=cfg.causal).reshape(B, S, -1)
    out = out @ p["wo"].to(x.dtype)
    return (out, k, v) if return_kv else out


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor):
    if cfg.attn == "mla":
        raise NotPortedError("MLA attention (attn='mla')")
    return gqa_attention(x, p, cfg, positions)


def gqa_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: torch.Tensor):
    """One new token against the cache.  x [B,1,d]; k/v_cache
    [B,Smax,KH,D]; pos a 0-d integer tensor (the new token's position).
    Returns (out [B,1,d], k_cache, v_cache).

    Unlike the reference's functional update, the new k, v are written into
    ``k_cache``/``v_cache`` in place (at full width a copy of the cache per
    layer and token would cost more than the step) and the same tensors
    are returned.
    """
    B = x.shape[0]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    posv = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _qkv_proj(x[:, :1], p, cfg)
    q = rope(q.reshape(B, 1, H, D), posv, cfg.rope_theta)
    k = rope(k.reshape(B, 1, KH, D), posv, cfg.rope_theta)
    at = pos.reshape(1).long()
    k_cache.index_copy_(1, at, k)
    v_cache.index_copy_(1, at, v.reshape(B, 1, KH, D))

    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bhrd,bshd->bhrs", qg.float(), k_cache.float()) / math.sqrt(D)
    mask = torch.arange(k_cache.shape[1], device=x.device) <= pos
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrs,bshd->bhrd", w, v_cache.float())
    o = o.reshape(B, 1, H * D).to(x.dtype)
    return o @ p["wo"].to(x.dtype), k_cache, v_cache
