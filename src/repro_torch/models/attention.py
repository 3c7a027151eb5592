"""Attention blocks: GQA (Llama/Qwen/Granite style) and MLA (DeepSeek-V2 /
MiniCPM3 style), prefill and decode.

Port of ``repro/models/attention.py`` for one device.  The prefill paths
go through ``layers.chunked_attention`` (the flash-attention kernel on the
card); decode is plain tensor arithmetic over the cache, as in the
reference.  MLA materialises ``q_full``, ``k_full`` (the shared rope key
broadcast to every head) and v zero-padded to the q/k head dim, as the
reference does, so the kernel sees one head dim ``dn + dr``; its decode
scores the cached latent directly (matrix absorption, in float32).  Each
of the four entry points (prefill and decode, GQA and MLA) is an
``attention`` span (``core/trace.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.models.layers import chunked_attention, rmsnorm, rope


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
    with trace.span("attention"):
        B, S, _ = x.shape
        q, k, v = gqa_qkv(x, p, cfg, positions)
        out = chunked_attention(q, k, v, causal=cfg.causal).reshape(B, S, -1)
        out = out @ p["wo"].to(x.dtype)
        return (out, k, v) if return_kv else out


def _mla_q(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """MLA queries, through the low-rank ``wq_a``/``q_norm``/``wq_b``
    bottleneck when the config has one, else ``wq``: [..., H * (dn + dr)]."""
    if cfg.q_lora_rank:
        cq = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
        return cq @ p["wq_b"].to(x.dtype)
    return x @ p["wq"].to(x.dtype)


def mla_attention(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor,
                  *, return_kv: bool = False):
    """Multi-head Latent Attention (DeepSeek-V2 eq. 1-11): x [B,S,d] ->
    [B,S,d], and with ``return_kv`` also the cache's entries, the normed
    latent ``c_kv`` [B,S,kv_lora_rank] and the rotated shared key
    ``k_rope`` [B,S,dr] (the reference's ``serve_step._mla_with_kv``)."""
    with trace.span("attention"):
        B, S, _ = x.shape
        H = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank

        q = _mla_q(x, p, cfg).reshape(B, S, H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope, positions, cfg.rope_theta)

        # compressed KV latent + shared rope key
        ckv = x @ p["wkv_a"].to(x.dtype)
        c_kv = rmsnorm(ckv[..., :r], p["kv_norm"], cfg.norm_eps)
        k_rope = rope(ckv[..., r:][:, :, None, :], positions, cfg.rope_theta)  # [B,S,1,dr]
        k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(B, S, H, dn)
        v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(B, S, H, dv)

        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
        # v padded up to the q/k head dim so that the kernel sees one D
        v_pad = F.pad(v, (0, dn + dr - dv)) if dv < dn + dr else v
        out = chunked_attention(q_full, k_full, v_pad, causal=cfg.causal)[..., :dv]
        out = out.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)
        return (out, c_kv, k_rope[:, :, 0]) if return_kv else out


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig, positions: torch.Tensor):
    if cfg.attn == "mla":
        return mla_attention(x, p, cfg, positions)
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
    with trace.span("attention"):
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


def mla_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, pos: torch.Tensor):
    """MLA decode with matrix absorption (DeepSeek-V2 appendix): the scores
    are taken against the cached latent directly, ``W_uk`` absorbed into
    the query and ``W_uv`` into the output, in float32.  x [B,1,d];
    ckv_cache [B,Smax,kv_lora_rank]; krope_cache [B,Smax,dr]; pos a 0-d
    integer tensor.  Returns (out [B,1,d], ckv_cache, krope_cache), the new
    token's entries written into the caches in place (as ``gqa_decode``)."""
    with trace.span("attention"):
        B = x.shape[0]
        H = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        posv = pos.reshape(1, 1).expand(B, 1)
        xt = x[:, 0]

        q = _mla_q(xt, p, cfg).reshape(B, H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = rope(q_rope[:, None], posv, cfg.rope_theta)[:, 0]

        ckv = xt @ p["wkv_a"].to(x.dtype)
        c_new = rmsnorm(ckv[..., :r], p["kv_norm"], cfg.norm_eps)
        kr_new = rope(ckv[..., r:][:, None, None, :], posv, cfg.rope_theta)[:, :, 0]  # [B,1,dr]
        at = pos.reshape(1).long()
        ckv_cache.index_copy_(1, at, c_new[:, None, :])
        krope_cache.index_copy_(1, at, kr_new)

        wk_b = p["wk_b"].float().reshape(r, H, dn)
        wv_b = p["wv_b"].float().reshape(r, H, dv)
        ckv_f = ckv_cache.float()
        q_c = torch.einsum("bhd,rhd->bhr", q_nope.float(), wk_b)  # W_uk absorbed into q
        s = torch.einsum("bhr,bsr->bhs", q_c, ckv_f)
        s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), krope_cache.float())
        s = s / math.sqrt(dn + dr)
        mask = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
        s = torch.where(mask, s, -1e30)
        w = torch.softmax(s, dim=-1)
        o_c = torch.einsum("bhs,bsr->bhr", w, ckv_f)
        o = torch.einsum("bhr,rhd->bhd", o_c, wv_b).reshape(B, 1, H * dv)
        return o.to(x.dtype) @ p["wo"].to(x.dtype), ckv_cache, krope_cache

