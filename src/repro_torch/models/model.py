"""Model assembly: parameter specs, init, forward and loss for the LM scaffold.

Port of ``repro/models/model.py``.  Parameters are nested dicts of
tensors in the reference's tree: per-layer tensors stacked on a leading
``[L]`` axis under ``blocks`` (the hybrid's parameter-shared attention+MLP
block under ``shared``), so a JAX parameter tree maps onto the port leaf
for leaf (``interop.lm_params_from_numpy``).  Layers run in a Python loop
over the stacked slices, on the weights' device; with a mesh the MoE
layers run expert-parallel over it (:func:`forward`).

Every leaf is declared once as a ``PS(shape, axes, init, scale)`` spec, the
reference's partition axes included: ``param_shardings`` resolves them
against a mesh (``core.compat.Placement`` leaves).  The spec tree is data
for every registered architecture, and the forward pass runs all ten: the
dense, MoE, ssm and hybrid families, GQA and MLA attention, and the audio
(precomputed frame features in place of the embedding) and vision (patch
embeddings prepended to the embedded tokens) frontends.

Training runs :func:`loss_fn` with each layer (the hybrid: each group of
layers and its shared block) recomputed in the backward, as the
reference's ``jax.checkpoint`` of its scanned unit.

Vocab padding: the embedding and lm_head vocab dims are padded to a
multiple of 512 (for vocabularies of 8,192 and more), and padded logits
are set to -1e30, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.core.compat import Placement
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.attention import attention_block
from repro_torch.models.mamba import mamba_block

FSDP = "data"      # parameter/optimizer sharding axis (ZeRO-3 style)
TP = "model"       # tensor-parallel axis
AUX_LOSS_COEF = 0.01
VOCAB_PAD = 512


@dataclasses.dataclass(frozen=True)
class PS:
    """Parameter spec: shape + partition axes + init recipe."""
    shape: tuple
    axes: tuple
    init: str = "normal"
    scale: float = 0.02


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype (the counterpart of
    ``jax.ShapeDtypeStruct``), with its ``core.compat.Placement`` where a
    mesh was given."""
    shape: tuple
    dtype: torch.dtype
    placement: Any = None


def padded_vocab(cfg: ModelConfig) -> int:
    if cfg.vocab_size < 8192:
        return cfg.vocab_size  # tiny head (hubert): no padding
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


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
            "wkv_a": PS((nl, d, cfg.kv_lora_rank + dr), (None, FSDP, None)),
            "kv_norm": PS((nl, cfg.kv_lora_rank), (None, None), "zeros"),
            "wk_b": PS((nl, cfg.kv_lora_rank, H * dn), (None, FSDP, TP)),
            "wv_b": PS((nl, cfg.kv_lora_rank, H * dv), (None, FSDP, TP)),
            "wo": PS((nl, H * dv, d), (None, TP, FSDP), scale=wo_scale),
        }
        if cfg.q_lora_rank:
            s["wq_a"] = PS((nl, d, cfg.q_lora_rank), (None, FSDP, None))
            s["q_norm"] = PS((nl, cfg.q_lora_rank), (None, None), "zeros")
            s["wq_b"] = PS((nl, cfg.q_lora_rank, H * (dn + dr)), (None, FSDP, TP))
        else:
            s["wq"] = PS((nl, d, H * (dn + dr)), (None, FSDP, TP))
        return s
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo = PS((nl, H * hd, d), (None, TP, FSDP), scale=wo_scale)
    if cfg.fused_qkv:
        s = {"wqkv": PS((nl, d, (H + 2 * KH) * hd), (None, FSDP, TP)), "wo": wo}
        if cfg.qkv_bias:
            s["bqkv"] = PS((nl, (H + 2 * KH) * hd), (None, TP), "zeros")
        return s
    s = {
        "wq": PS((nl, d, H * hd), (None, FSDP, TP)),
        "wk": PS((nl, d, KH * hd), (None, FSDP, TP)),
        "wv": PS((nl, d, KH * hd), (None, FSDP, TP)),
        "wo": wo,
    }
    if cfg.qkv_bias:
        s["bq"] = PS((nl, H * hd), (None, TP), "zeros")
        s["bk"] = PS((nl, KH * hd), (None, TP), "zeros")
        s["bv"] = PS((nl, KH * hd), (None, TP), "zeros")
    return s


def _mlp_specs(d: int, ff: int, nl: int, cfg: ModelConfig) -> dict:
    down = PS((nl, ff, d), (None, TP, FSDP), scale=0.02 / math.sqrt(2 * cfg.num_layers))
    if cfg.fused_gate_up:
        return {"w_gateup": PS((nl, d, 2, ff), (None, FSDP, None, TP)), "w_down": down}
    return {"w_gate": PS((nl, d, ff), (None, FSDP, TP)),
            "w_up": PS((nl, d, ff), (None, FSDP, TP)), "w_down": down}


def _moe_specs(cfg: ModelConfig, nl: int) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    down_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    s = {
        "router": PS((nl, d, E), (None, FSDP, None)),
        "w_gate": PS((nl, E, d, f), (None, TP, FSDP, None)),
        "w_up": PS((nl, E, d, f), (None, TP, FSDP, None)),
        "w_down": PS((nl, E, f, d), (None, TP, None, FSDP), scale=down_scale),
    }
    if cfg.num_shared_experts:
        sf = f * cfg.num_shared_experts
        if cfg.fused_gate_up:
            s["shared_w_gateup"] = PS((nl, d, 2, sf), (None, FSDP, None, TP))
        else:
            s["shared_w_gate"] = PS((nl, d, sf), (None, FSDP, TP))
            s["shared_w_up"] = PS((nl, d, sf), (None, FSDP, TP))
        s["shared_w_down"] = PS((nl, sf, d), (None, TP, FSDP), scale=down_scale)
    return s


def _mamba_specs(cfg: ModelConfig, nl: int) -> dict:
    d, din = cfg.d_model, cfg.ssm_d_inner
    H, G, N, W = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    return {
        "w_zx": PS((nl, d, 2 * din), (None, FSDP, TP)),
        "w_bc": PS((nl, d, 2 * G * N), (None, FSDP, None)),
        "w_dt": PS((nl, d, H), (None, FSDP, TP)),
        "dt_bias": PS((nl, H), (None, TP), "dt_bias"),
        "A_log": PS((nl, H), (None, TP), "A_log"),
        "D": PS((nl, H), (None, TP), "ones_raw"),
        "conv_x": PS((nl, W, din), (None, None, TP), scale=0.2),
        "conv_bc": PS((nl, W, 2 * G * N), (None, None, None), scale=0.2),
        "norm": PS((nl, din), (None, TP), "zeros"),
        "w_out": PS((nl, din, d), (None, TP, FSDP), scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _unstack(group: dict) -> dict:
    """Specs built with one stacked layer, without that leading dim (and
    its axis)."""
    return {k: PS(v.shape[1:], v.axes[1:], v.init, v.scale) for k, v in group.items()}


def build_param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree, axes included.  The hybrid's shared block
    is built unstacked here, so the reference's ``_fix_shared`` pass (which
    strips a leading dim of 1 that no registered config leaves) has
    nothing to do; the parameter-tree tests hold the two trees equal."""
    d, nl = cfg.d_model, cfg.num_layers
    vp = padded_vocab(cfg)
    specs: dict[str, Any] = {}
    if cfg.frontend != "audio":
        specs["embed"] = PS((vp, d), (TP, FSDP), scale=1.0)
    blocks: dict[str, Any] = {"ln1": PS((nl, d), (None, None), "zeros")}
    if cfg.family == "ssm":
        blocks["mamba"] = _mamba_specs(cfg, nl)
    elif cfg.family == "hybrid":
        blocks["mamba"] = _mamba_specs(cfg, nl)
        specs["shared"] = {
            "ln1": PS((d,), (None,), "zeros"),
            "attn": _unstack(_attn_specs(cfg, 1)),
            "ln2": PS((d,), (None,), "zeros"),
            "mlp": _unstack(_mlp_specs(d, cfg.d_ff, 1, cfg)),
        }
    else:
        blocks["attn"] = _attn_specs(cfg, nl)
        blocks["ln2"] = PS((nl, d), (None, None), "zeros")
        if cfg.family == "moe":
            blocks["moe"] = _moe_specs(cfg, nl)
        else:
            blocks["mlp"] = _mlp_specs(d, cfg.d_ff, nl, cfg)
    specs["blocks"] = blocks
    specs["final_norm"] = PS((d,), (None,), "zeros")
    specs["lm_head"] = PS((d, vp), (FSDP, TP))
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


def param_shardings(cfg: ModelConfig, mesh) -> dict:
    """The parameter tree as ``core.compat.Placement`` leaves: each leaf's
    spec resolved against ``mesh`` (``layers.resolve_spec``: an axis the
    mesh lacks, or one that does not divide the dim, is dropped), whose
    ``place`` cuts the leaf into each rank's block on that rank's device
    and ``shard_shape`` gives the block's shape.  On a mesh of ``meta``
    devices nothing is allocated: the dry-run reads per-rank shapes and
    bytes from it."""
    return _map_specs(lambda s: Placement(mesh, L.resolve_spec(mesh, s.shape, s.axes)),
                      build_param_specs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(build_param_specs(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top-k + shared experts only)."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    E, k = cfg.num_experts, cfg.experts_per_token
    expert_p = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_layers
    return total - (E - k) * expert_p  # routed experts not hit


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
def ffn_block(x, p, cfg: ModelConfig, mesh=None):
    """The post-attention half of a layer (the reference's
    ``_ffn_decode``): ``x + ffn(rmsnorm(x, ln2))``, the FFN a SwiGLU MLP
    or, in an MoE layer, :func:`moe_block` (expert-parallel over ``mesh``
    when one is given).  Returns (x, the layer's aux loss, or None for an
    MLP).  An ``ffn`` span."""
    with trace.span("ffn"):
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            mo, aux = moe.moe_block(h, p["moe"], cfg, mesh)
            return x + mo, aux
        return x + L.swiglu_mlp(h, p["mlp"]), None


def apply_shared_block(x, sp, cfg: ModelConfig, positions, mesh=None):
    """The hybrid's parameter-shared attention+MLP block."""
    h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
    return ffn_block(x + attention_block(h, sp["attn"], cfg, positions), sp, cfg, mesh)[0]


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


def embed_inputs(params: dict, inputs: dict, cfg: ModelConfig) -> torch.Tensor:
    """The first layer's input [B, S, d] in ``layers.COMPUTE_DTYPE``: the
    embedded ``inputs["tokens"]``; for the audio frontend the frame
    features ``inputs["features"]`` [B, S, d] (no embedding); for the vision
    frontend the patch embeddings ``inputs["vis_embed"]`` [B, vis_tokens, d]
    followed by the embedded tokens."""
    if cfg.frontend == "audio":
        return inputs["features"].to(L.COMPUTE_DTYPE)
    x = params["embed"].to(L.COMPUTE_DTYPE)[inputs["tokens"]]
    if cfg.frontend == "vision":
        x = torch.cat([inputs["vis_embed"].to(L.COMPUTE_DTYPE), x], dim=1)
    return x


def _layer(x, aux, lp, i, shared, cfg: ModelConfig, positions, mesh):
    """Layer ``i`` (and the hybrid's shared block where it follows), a
    ``layer`` span: in training the backward's recompute opens it again."""
    with trace.span("layer"):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cfg.family in ("ssm", "hybrid"):
            x = x + mamba_block(h, lp["mamba"], cfg)
            if shared_after(cfg, i):
                x = apply_shared_block(x, shared, cfg, positions, mesh)
            return x, aux
        x, a = ffn_block(x + attention_block(h, lp["attn"], cfg, positions), lp, cfg, mesh)
        return x, aux if a is None else aux + a


def units(cfg: ModelConfig) -> list:
    """The layers of each unit that training recomputes as one (the
    reference's scanned unit): one layer; for the hybrid family a group of
    ``shared_attn_every`` mamba layers and the shared block after it, as
    ``_group_blocks`` groups them (layers past the last whole group, which
    no registered config has, are units of one)."""
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 1
    whole = cfg.num_layers - cfg.num_layers % every
    return [list(range(i, i + every)) for i in range(0, whole, every)] + \
        [[i] for i in range(whole, cfg.num_layers)]


# matmuls without batch dims: what ``REPRO_REMAT=dots`` keeps through the
# recompute (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _recompute_context():
    """The reference's ``REPRO_REMAT`` policy: ``"nothing"`` (the default)
    saves nothing of a unit for its backward, ``"dots"`` saves the outputs
    of its matmuls without batch dims."""
    remat = os.environ.get("REPRO_REMAT", "nothing")
    if remat == "nothing":
        return noop_context_fn
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"REPRO_REMAT must be 'nothing' or 'dots', got {remat!r}")


def _count_once(fn):
    """``fn`` for ``checkpoint``: its first call is the forward; a later
    call is the backward's recompute, whose MoE drops were counted
    already."""
    ran = []

    def run(*args):
        if not ran:
            ran.append(True)
            return fn(*args)
        with moe.drops_not_counted():
            return fn(*args)

    return run


def forward(params: dict, inputs: dict, cfg: ModelConfig, mesh=None, *, last_only: bool = False):
    """-> (logits [B, S, V_pad] float32, aux loss float32: the MoE layers'
    load-balance losses summed, 0 without MoE).  With a ``mesh`` the MoE
    layers run expert-parallel over it (``models/moe.py``; the batch split
    over its dp axes, each data shard's capacity its own, the aux data
    shard 0's); every other layer keeps its one-device arithmetic on the
    whole batch, which is each data shard's row for row.  ``inputs`` as
    :func:`embed_inputs` reads them (``launch/inputs.py::make_inputs``
    makes them); positions run over the whole sequence, patches included.
    ``last_only`` computes the final position's logits only (the
    serving-prefill shape).  Activations run in ``layers.COMPUTE_DTYPE``.

    With grad enabled each unit (:func:`units`) runs under
    ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
    reference's ``jax.checkpoint`` of its scanned unit: its activations are
    recomputed in the backward, kernels included, as ``REPRO_REMAT`` says.
    The stacked leaves are split with ``torch.unbind``, so each one's
    gradient is assembled once.  Without grad the layers run one after
    another, nothing else."""
    x = embed_inputs(params, inputs, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    if torch.is_grad_enabled():
        per_layer = _unbind_layers(params["blocks"], cfg.num_layers)
        context_fn = _recompute_context()
        for unit in units(cfg):
            def run(x, aux, unit=unit):
                for i in unit:
                    x, aux = _layer(x, aux, per_layer[i], i, shared, cfg, positions, mesh)
                return x, aux

            x, aux = checkpoint(_count_once(run), x, aux, use_reentrant=False,
                                context_fn=context_fn)
    else:
        for i in range(cfg.num_layers):
            x, aux = _layer(x, aux, layer_params(params["blocks"], i), i, shared, cfg, positions,
                            mesh)
    if last_only:
        x = x[:, -1:, :]
    return lm_logits(x, params, cfg), aux


def _unbind_layers(blocks: dict, n: int) -> list:
    """The stacked ``blocks`` tree as ``n`` per-layer trees, one
    ``torch.unbind`` a leaf."""
    out = [{} for _ in range(n)]

    def split(tree, dsts):
        for k, v in tree.items():
            if isinstance(v, dict):
                split(v, [d.setdefault(k, {}) for d in dsts])
            else:
                for d, t in zip(dsts, torch.unbind(v)):
                    d[k] = t

    split(blocks, out)
    return out


def loss_fn(params: dict, inputs: dict, cfg: ModelConfig, mesh=None):
    """Mean cross-entropy over ``labels >= 0`` plus ``AUX_LOSS_COEF`` times
    the MoE aux loss (:func:`forward`'s, over ``mesh`` when given).
    Returns ``(loss, {"ce", "aux", "ntok"})``.  For the vision frontend
    the labels are padded with ``vis_tokens`` of -1 in front, for the
    patches."""
    logits, aux = forward(params, inputs, cfg, mesh)
    labels = inputs["labels"].long()
    if cfg.frontend == "vision":
        pad = torch.full((labels.shape[0], cfg.vis_tokens), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(mask, lse - gold, 0.0)
    ntok = torch.clamp(mask.sum(), min=1)
    loss = ce.sum() / ntok
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux, "ntok": ntok}
