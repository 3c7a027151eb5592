"""Serving steps: cache-building prefill and batched greedy decode.

Port of ``repro/serve/serve_step.py``.  ``prefill_with_cache``
runs a prompt through the model and fills the cache (flash attention and the
SSD intra-chunk kernel on the card); ``make_decode_step`` builds the step
that takes one new token per sequence against the cache.  The reference's
``lax.scan`` over stacked layers (or hybrid groups) is a Python loop over
the layers here, its ``_attn_with_kv`` and ``_mla_with_kv`` are
``models.attention.gqa_attention`` and ``mla_attention`` with
``return_kv=True``, and its ``_ffn_decode`` is ``models.model.ffn_block``
(a SwiGLU MLP, or the MoE block).  Every family runs: dense, MoE, ssm and
hybrid, with GQA caches or MLA's latent ``c_kv``/``k_rope`` caches.

The cache is updated in place: ``prefill_with_cache`` returns a new cache,
and each decode step writes the new token's entries into the cache it is
given and returns that dict with ``pos`` advanced.  A decode step runs the
MoE block on one token a sequence, so its capacity is
``int(B*K/E * capacity_factor) + 1`` and colliding assignments drop, as in
the reference (``models/moe.py``).  The serving paths take token prompts:
a config with a modality frontend is served with ``frontend="none"``, as
the reference's serving CLI does.  Both take an optional mesh, as the
reference's do: the MoE layers then run expert-parallel over it
(``models/moe.py``: each data shard of the batch routed at its own
capacity, each model rank its E/tp experts), the rest of the step and the
cache on the tokens' device.  Each iteration of either step's layer loop
is a ``layer`` span (``core/trace.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_attention, gqa_decode, mla_attention, mla_decode
from repro_torch.models.mamba import mamba_decode_step, mamba_prefill
from repro_torch.models.model import ffn_block, layer_params, lm_logits, shared_after
from repro_torch.serve.kvcache import init_cache

_SSM_STATE = ("conv_x", "conv_bc", "ssm")


def make_decode_step(cfg: ModelConfig, mesh=None):
    """Returns ``decode_step(params, cache, tokens [B,1]) -> (logits
    [B,1,V_pad] float32, cache)``; the cache is updated in place."""

    def decode_step(params, cache, tokens):
        pos = cache["pos"]
        x = params["embed"].to(L.COMPUTE_DTYPE)[tokens]  # [B,1,d]
        shared = params.get("shared")
        for i in range(cfg.num_layers):
            with trace.span("layer"):
                lp = layer_params(params["blocks"], i)
                h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
                if cfg.family in ("ssm", "hybrid"):
                    state = {k: cache[k][i] for k in _SSM_STATE}
                    y, new = mamba_decode_step(h, state, lp["mamba"], cfg)
                    x = x + y
                    for k in _SSM_STATE:
                        cache[k][i].copy_(new[k])
                    if shared_after(cfg, i):
                        g = i // cfg.shared_attn_every
                        h = L.rmsnorm(x, shared["ln1"], cfg.norm_eps)
                        o, _, _ = gqa_decode(h, shared["attn"], cfg, cache["sk"][g], cache["sv"][g], pos)
                        x, _ = ffn_block(x + o, shared, cfg, mesh)
                else:
                    if cfg.attn == "mla":
                        o, _, _ = mla_decode(h, lp["attn"], cfg, cache["c_kv"][i], cache["k_rope"][i], pos)
                    else:
                        o, _, _ = gqa_decode(h, lp["attn"], cfg, cache["k"][i], cache["v"][i], pos)
                    x, _ = ffn_block(x + o, lp, cfg, mesh)
        cache["pos"] = pos + 1
        return lm_logits(x, params, cfg), cache

    return decode_step


def prefill_with_cache(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *, mesh=None):
    """Run the prompt ``tokens`` [B, S] through the model, returning
    (last-token logits [B,1,V_pad] float32, a cache on the tokens' device
    positioned at S) so that greedy decode continues where a plain forward
    pass would.  S may not exceed ``max_len``."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds the cache's max_len {max_len}")
    x = params["embed"].to(L.COMPUTE_DTYPE)[tokens]
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, x.device)
    shared = params.get("shared")
    for i in range(cfg.num_layers):
        with trace.span("layer"):
            lp = layer_params(params["blocks"], i)
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            if cfg.family in ("ssm", "hybrid"):
                y, st = mamba_prefill(h, lp["mamba"], cfg)
                x = x + y
                for k in _SSM_STATE:
                    cache[k][i].copy_(st[k])
                if shared_after(cfg, i):
                    inv = i // cfg.shared_attn_every
                    h = L.rmsnorm(x, shared["ln1"], cfg.norm_eps)
                    o, kf, vf = gqa_attention(h, shared["attn"], cfg, positions, return_kv=True)
                    cache["sk"][inv, :, :S].copy_(kf)
                    cache["sv"][inv, :, :S].copy_(vf)
                    x, _ = ffn_block(x + o, shared, cfg, mesh)
            elif cfg.attn == "mla":
                o, ck, kr = mla_attention(h, lp["attn"], cfg, positions, return_kv=True)
                cache["c_kv"][i, :, :S].copy_(ck)
                cache["k_rope"][i, :, :S].copy_(kr)
                x, _ = ffn_block(x + o, lp, cfg, mesh)
            else:
                o, kf, vf = gqa_attention(h, lp["attn"], cfg, positions, return_kv=True)
                cache["k"][i, :, :S].copy_(kf)
                cache["v"][i, :, :S].copy_(vf)
                x, _ = ffn_block(x + o, lp, cfg, mesh)
    cache["pos"].fill_(S)
    return lm_logits(x[:, -1:], params, cfg), cache
