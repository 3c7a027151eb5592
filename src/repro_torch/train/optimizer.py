"""AdamW with optional 8-bit (block-quantized) moments.

Port of ``repro/train/optimizer.py`` for one device.  The state keeps the
reference's tree, ``{"step": int32 0-d, "moments": {leaf: {"m", "v"}}}``,
with the moments float32, or in 8-bit mode each an int8 ``{"q", "scale"}``
pair (codes over blocks of ``BLOCK`` along the last axis, absmax scales in
float32; 8-bit Adam, Dettmers 2021), so checkpoints interchange with the
reference's.  ``torch.round`` rounds half to even as ``jnp.round`` does,
so the same float32 input gives the same codes.

:func:`adamw_update` writes the new parameters and moments into the given
tensors under ``torch.no_grad`` (the counterpart of the reference's
donated buffers) and returns them, as the reference returns new ones.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import trace

BLOCK = 256
# elements of a leaf updated at once: bounds the float32 temporaries of a
# stacked leaf (the update is elementwise and the int8 blocks run along the
# last axis, so slicing dim 0 changes no value)
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 (float32 moments) or 8 (block-int8)
    warmup_steps: int = 100


# ---------------------------------------------------------------------------
# block int8 quantization
# ---------------------------------------------------------------------------
def quantize_block_int8(x: torch.Tensor) -> dict:
    """Blocks of ``BLOCK`` along the last axis (zero-padded): int8 codes
    ``q`` [..., padded last] and float32 ``scale`` [..., blocks], the
    block's absmax / 127 (at least 1e-12)."""
    shape = x.shape
    pad = (-shape[-1]) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad))
    xb = xp.reshape(shape[:-1] + (-1, BLOCK))
    scale = torch.clamp(xb.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(xp.shape), "scale": scale[..., 0].float()}


def dequantize_block_int8(state: dict, shape) -> torch.Tensor:
    """The float32 values of ``quantize_block_int8``'s codes, ``shape``."""
    q = state["q"].float()
    x = q.reshape(tuple(shape[:-1]) + (-1, BLOCK)) * state["scale"][..., None]
    return x.reshape(q.shape)[..., :shape[-1]]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def leaves(tree) -> list:
    """A nested dict's leaves in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def _by_key(params: dict, *trees):
    """(param, the other trees' entries at its key) for every parameter
    leaf: trees are matched by key, whatever their insertion order."""
    for k, p in params.items():
        if isinstance(p, dict):
            yield from _by_key(p, *(t[k] for t in trees))
        else:
            yield (p, *(t[k] for t in trees))


def _zero_codes(p: torch.Tensor) -> dict:
    """``quantize_block_int8`` of zeros of ``p``'s shape (codes 0, scales
    1e-12), made without a float32 copy of the leaf."""
    blocks = -(-p.shape[-1] // BLOCK)
    return {"q": torch.zeros(p.shape[:-1] + (blocks * BLOCK,), dtype=torch.int8, device=p.device),
            "scale": torch.full(p.shape[:-1] + (blocks,), 1e-12, dtype=torch.float32, device=p.device)}


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    def init_leaf(p):
        if cfg.state_bits == 8:
            return {"m": _zero_codes(p), "v": _zero_codes(p)}
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    device = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "moments": _map(init_leaf, params)}


def _lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def row_slices(p: torch.Tensor):
    """Slices of dim 0 of at most ``SLICE_ELEMENTS`` elements (the whole
    leaf when it is small or 1-d)."""
    if p.ndim < 2 or p.numel() <= SLICE_ELEMENTS:
        return [slice(None)]
    rows = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: OptConfig):
    """-> (params, opt_state, metrics {"grad_norm", "lr"}): the reference's
    update (global-norm clipping, bias-corrected moments, decoupled weight
    decay, warmup), computed in float32 and written in place; an
    ``adamw_update`` span."""
    with trace.span("adamw_update"):
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = _lr_schedule(cfg, step)
        b1, b2 = cfg.beta1, cfg.beta2
        stepf = step.float()
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf

        def upd(p, g, m, v):
            g = g.float() * clip
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.float()
            p.copy_((pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype))
            return m, v

        for p, g, mom in _by_key(params, grads, opt_state["moments"]):
            for sl in row_slices(p):
                ps = p[sl]
                if cfg.state_bits != 8:
                    mom["m"][sl], mom["v"][sl] = upd(ps, g[sl], mom["m"][sl], mom["v"][sl])
                    continue
                m, v = upd(ps, g[sl], *(dequantize_block_int8(
                    {"q": mom[k]["q"][sl], "scale": mom[k]["scale"][sl]}, ps.shape) for k in ("m", "v")))
                for k, new in (("m", m), ("v", v)):
                    qs = quantize_block_int8(new)
                    mom[k]["q"][sl], mom[k]["scale"][sl] = qs["q"], qs["scale"]
        opt_state["step"] = step
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}
