"""Model assembly: parameter specs, init and forward for the LM scaffold.

Port of ``repro/models/model.py`` for one device.  Parameters are nested
dicts of tensors in the reference's tree: per-layer tensors stacked on a
leading ``[L]`` axis under ``blocks`` (the hybrid's parameter-shared
attention+MLP block under ``shared``), so a JAX parameter tree maps onto
the port leaf for leaf (``interop.lm_params_from_numpy``).  Layers run in a
Python loop over the stacked slices.

Every leaf is declared once as a ``PS(shape, init, scale)`` spec (the
reference's sharding axes have no counterpart here).  The spec tree is data
for every registered architecture, so :func:`param_count` and
:func:`param_shape_structs` cover all ten; the forward pass runs the dense,
ssm and hybrid families and raises ``NotPortedError`` for MoE layers, MLA
attention and the audio/vision frontends.

Vocab padding: the embedding and lm_head vocab dims are padded to a
multiple of 512 (for vocabularies of 8,192 and more), and padded logits
are set to -1e30, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.api.errors import NotPortedError
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention import attention_block
from repro_torch.models.mamba import mamba_block

VOCAB_PAD = 512


@dataclasses.dataclass(frozen=True)
class PS:
    """Parameter spec: shape + init recipe."""
    shape: tuple
    init: str = "normal"
    scale: float = 0.02


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def padded_vocab(cfg: ModelConfig) -> int:
    if cfg.vocab_size < 8192:
        return cfg.vocab_size  # tiny head (hubert): no padding
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotPortedError`` for what the port's forward and serving
    paths do not run: MoE layers, MLA attention, modality frontends."""
    if cfg.family == "moe":
        raise NotPortedError("MoE layers (models/moe.py)")
    if cfg.attn == "mla":
        raise NotPortedError("MLA attention (attn='mla')")
    if cfg.frontend != "none":
        raise NotPortedError(f"the {cfg.frontend} frontend")


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------
def _attn_specs(cfg: ModelConfig, nl: int) -> dict:
    d = cfg.d_model
    wo_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    if cfg.attn == "mla":
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        H = cfg.num_heads
        s: dict[str, PS] = {
            "wkv_a": PS((nl, d, cfg.kv_lora_rank + dr)),
            "kv_norm": PS((nl, cfg.kv_lora_rank), "zeros"),
            "wk_b": PS((nl, cfg.kv_lora_rank, H * dn)),
            "wv_b": PS((nl, cfg.kv_lora_rank, H * dv)),
            "wo": PS((nl, H * dv, d), scale=wo_scale),
        }
        if cfg.q_lora_rank:
            s["wq_a"] = PS((nl, d, cfg.q_lora_rank))
            s["q_norm"] = PS((nl, cfg.q_lora_rank), "zeros")
            s["wq_b"] = PS((nl, cfg.q_lora_rank, H * (dn + dr)))
        else:
            s["wq"] = PS((nl, d, H * (dn + dr)))
        return s
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo = PS((nl, H * hd, d), scale=wo_scale)
    if cfg.fused_qkv:
        s = {"wqkv": PS((nl, d, (H + 2 * KH) * hd)), "wo": wo}
        if cfg.qkv_bias:
            s["bqkv"] = PS((nl, (H + 2 * KH) * hd), "zeros")
        return s
    s = {
        "wq": PS((nl, d, H * hd)),
        "wk": PS((nl, d, KH * hd)),
        "wv": PS((nl, d, KH * hd)),
        "wo": wo,
    }
    if cfg.qkv_bias:
        s["bq"] = PS((nl, H * hd), "zeros")
        s["bk"] = PS((nl, KH * hd), "zeros")
        s["bv"] = PS((nl, KH * hd), "zeros")
    return s


def _mlp_specs(d: int, ff: int, nl: int, cfg: ModelConfig) -> dict:
    down = PS((nl, ff, d), scale=0.02 / math.sqrt(2 * cfg.num_layers))
    if cfg.fused_gate_up:
        return {"w_gateup": PS((nl, d, 2, ff)), "w_down": down}
    return {"w_gate": PS((nl, d, ff)), "w_up": PS((nl, d, ff)), "w_down": down}


def _moe_specs(cfg: ModelConfig, nl: int) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    down_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    s = {
        "router": PS((nl, d, E)),
        "w_gate": PS((nl, E, d, f)),
        "w_up": PS((nl, E, d, f)),
        "w_down": PS((nl, E, f, d), scale=down_scale),
    }
    if cfg.num_shared_experts:
        sf = f * cfg.num_shared_experts
        if cfg.fused_gate_up:
            s["shared_w_gateup"] = PS((nl, d, 2, sf))
        else:
            s["shared_w_gate"] = PS((nl, d, sf))
            s["shared_w_up"] = PS((nl, d, sf))
        s["shared_w_down"] = PS((nl, sf, d), scale=down_scale)
    return s


def _mamba_specs(cfg: ModelConfig, nl: int) -> dict:
    d, din = cfg.d_model, cfg.ssm_d_inner
    H, G, N, W = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    return {
        "w_zx": PS((nl, d, 2 * din)),
        "w_bc": PS((nl, d, 2 * G * N)),
        "w_dt": PS((nl, d, H)),
        "dt_bias": PS((nl, H), "dt_bias"),
        "A_log": PS((nl, H), "A_log"),
        "D": PS((nl, H), "ones_raw"),
        "conv_x": PS((nl, W, din), scale=0.2),
        "conv_bc": PS((nl, W, 2 * G * N), scale=0.2),
        "norm": PS((nl, din), "zeros"),
        "w_out": PS((nl, din, d), scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _unstack(group: dict) -> dict:
    """Specs built with one stacked layer, without that leading dim."""
    return {k: PS(v.shape[1:], v.init, v.scale) for k, v in group.items()}


def build_param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree.  The hybrid's shared block is built
    unstacked here, so the reference's ``_fix_shared`` pass (which strips
    a leading dim of 1 that no registered config leaves) has nothing to
    do; the parameter-tree tests hold the two trees equal."""
    d, nl = cfg.d_model, cfg.num_layers
    vp = padded_vocab(cfg)
    specs: dict[str, Any] = {}
    if cfg.frontend != "audio":
        specs["embed"] = PS((vp, d), scale=1.0)
    blocks: dict[str, Any] = {"ln1": PS((nl, d), "zeros")}
    if cfg.family == "ssm":
        blocks["mamba"] = _mamba_specs(cfg, nl)
    elif cfg.family == "hybrid":
        blocks["mamba"] = _mamba_specs(cfg, nl)
        specs["shared"] = {
            "ln1": PS((d,), "zeros"),
            "attn": _unstack(_attn_specs(cfg, 1)),
            "ln2": PS((d,), "zeros"),
            "mlp": _unstack(_mlp_specs(d, cfg.d_ff, 1, cfg)),
        }
    else:
        blocks["attn"] = _attn_specs(cfg, nl)
        blocks["ln2"] = PS((nl, d), "zeros")
        if cfg.family == "moe":
            blocks["moe"] = _moe_specs(cfg, nl)
        else:
            blocks["mlp"] = _mlp_specs(d, cfg.d_ff, nl, cfg)
    specs["blocks"] = blocks
    specs["final_norm"] = PS((d,), "zeros")
    specs["lm_head"] = PS((d, vp))
    return specs


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _map_specs(fn, specs: dict) -> dict:
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v) for k, v in specs.items()}


def _leaf_dtype(s: PS, dtype: torch.dtype) -> torch.dtype:
    # SSD dynamics + norms stay float32 for numerical safety
    return torch.float32 if s.init in ("A_log", "dt_bias", "ones_raw", "zeros") else dtype


def param_shape_structs(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The parameter tree as ``ShapeDtype(shape, dtype)`` leaves (nothing
    is allocated)."""
    return _map_specs(lambda s: ShapeDtype(tuple(s.shape), _leaf_dtype(s, dtype)),
                      build_param_specs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(build_param_specs(cfg)))


def init_params(cfg: ModelConfig, generator, device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random parameters with the reference's recipes: normal draws times
    each spec's scale (embedding 1.0, ``wo``/``w_down``/``w_out``
    0.02/sqrt(2L), the rest 0.02; mamba convs 0.2), ``A_log`` = log U(1, 16),
    ``dt_bias`` = softplus^-1 of U(1e-3, 1e-1), ``D`` = 1, norms 0; SSD
    dynamics and norms in float32, the rest in ``dtype``.

    ``generator`` is a ``torch.Generator`` on ``device``, or an int seed.
    The draws differ from the reference's (``jax.random``), so tests that
    compare the two packages carry the reference's parameters over with
    ``interop.lm_params_from_numpy``.  Stacked leaves are drawn one layer
    at a time, so no float32 copy of a whole stacked leaf is ever held.
    """
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    f32 = dict(generator=generator, dtype=torch.float32, device=device)

    def draw(s: PS, shape, dt):
        if s.init == "A_log":
            return torch.log(torch.rand(shape, **f32) * 15.0 + 1.0).to(dt)
        if s.init == "dt_bias":
            u = torch.rand(shape, **f32) * (1e-1 - 1e-3) + 1e-3
            return (u + torch.log(-torch.expm1(-u))).to(dt)  # softplus^-1
        return L.normal_init(shape, dt, s.scale, generator=generator, device=device)

    def init_leaf(s: PS, stacked: bool):
        dt = _leaf_dtype(s, dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones_raw":
            return torch.ones(s.shape, dtype=dt, device=device)
        if not stacked:
            return draw(s, s.shape, dt)
        out = torch.empty(s.shape, dtype=dt, device=device)
        for i in range(s.shape[0]):
            out[i] = draw(s, s.shape[1:], dt)
        return out

    specs = build_param_specs(cfg)
    return {k: _map_specs(lambda s: init_leaf(s, k == "blocks"), v) if isinstance(v, dict)
            else init_leaf(v, False) for k, v in specs.items()}


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``blocks`` tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def ffn_block(x, p, cfg: ModelConfig):
    """The post-attention half of a dense layer or of the hybrid's shared
    block: ``x + swiglu(rmsnorm(x, ln2))`` (the reference's ``_ffn_decode``
    for a dense config; its MoE branch is not ported)."""
    return x + L.swiglu_mlp(L.rmsnorm(x, p["ln2"], cfg.norm_eps), p["mlp"])


def apply_shared_block(x, sp, cfg: ModelConfig, positions):
    """The hybrid's parameter-shared attention+MLP block."""
    h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
    return ffn_block(x + attention_block(h, sp["attn"], cfg, positions), sp, cfg)


def shared_after(cfg: ModelConfig, i: int) -> bool:
    """The hybrid applies its shared block after every ``shared_attn_every``
    mamba layers (after layers every-1, 2 every-1, ...)."""
    every = cfg.shared_attn_every
    return cfg.family == "hybrid" and i % every == every - 1


def lm_logits(x, params, cfg: ModelConfig):
    """Final norm and lm_head in float32, padded vocab set to -1e30."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    logits[..., cfg.vocab_size:] = L.NEG_INF
    return logits


def forward(params: dict, inputs: dict, cfg: ModelConfig, *, last_only: bool = False):
    """-> (logits [B, S, V_pad] float32, aux loss 0).  ``inputs["tokens"]``
    [B, S]; ``last_only`` computes the final position's logits only (the
    serving-prefill shape).  Activations run in ``layers.COMPUTE_DTYPE``."""
    check_ported(cfg)
    tokens = inputs["tokens"]
    x = params["embed"].to(L.COMPUTE_DTYPE)[tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    shared = params.get("shared")
    for i in range(cfg.num_layers):
        lp = layer_params(params["blocks"], i)
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cfg.family in ("ssm", "hybrid"):
            x = x + mamba_block(h, lp["mamba"], cfg)
            if shared_after(cfg, i):
                x = apply_shared_block(x, shared, cfg, positions)
        else:
            x = ffn_block(x + attention_block(h, lp["attn"], cfg, positions), lp, cfg)
    if last_only:
        x = x[:, -1:, :]
    return lm_logits(x, params, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
