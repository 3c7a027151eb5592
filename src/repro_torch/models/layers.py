"""Shared model layers: norms, RoPE, attention entry point, MLP.

Port of ``repro/models/layers.py`` for one device (the sharding helpers
``shard``/``resolve_spec``/``dp_axes`` have no counterpart here).  Plain
functions on tensors; parameters are nested dicts of tensors (see
``models/model.py``).  Activations run in ``COMPUTE_DTYPE`` (bfloat16);
each parameter is cast to the activation's dtype at its use, and the norm,
softmax, RoPE and SiLU arithmetic runs in float32 and is cast back, as in
the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ops import flash_attention

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + w)`` (norm weights are zero-initialised):
    the forward of the reference's ``_rmsnorm_fwd``, in float32."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] (D even), positions [..., S] -> x rotated (the two
    halves of D, as in the reference), computed in float32."""
    d_half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(d_half, dtype=torch.float32, device=x.device) / d_half
    )
    ang = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, p: dict, prefix: str = "") -> torch.Tensor:
    """SwiGLU MLP from the fused ``w_gateup`` [d, 2, f] or the split
    ``w_gate``/``w_up`` [d, f], then ``w_down`` [f, d]."""
    if prefix + "w_gateup" in p:
        w = p[prefix + "w_gateup"].to(x.dtype)
        d, _, f = w.shape
        gu = (x @ w.reshape(d, 2 * f)).unflatten(-1, (2, f))
        h, u = gu[..., 0, :], gu[..., 1, :]
    else:
        h = x @ p[prefix + "w_gate"].to(x.dtype)
        u = x @ p[prefix + "w_up"].to(x.dtype)
    h = F.silu(h.float()).to(x.dtype) * u
    return h @ p[prefix + "w_down"].to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool) -> torch.Tensor:
    """Attention of the prefill and forward paths: q [B,Sq,H,D], k/v
    [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype.

    The function of the reference's ``chunked_attention`` (its only callers
    pass ``causal`` alone), through the flash-attention op: a Hopper kernel
    for CUDA tensors, the plain online-softmax version (p in float32, as
    the reference keeps it) for CPU tensors.  On the card, bfloat16 with a
    head dim that is a multiple of 16 up to 128 (every registered dense and
    hybrid config) runs on the tensor cores and rounds p to bfloat16 before
    ``p @ v``, as the reference's Pallas kernel does; float32, and other
    head dims, run on the CUDA cores with p in float32.  Sq and Skv need
    not divide any chunk length.
    """
    return flash_attention(q, k, v, causal=causal)


def normal_init(shape, dtype, scale: float, *, generator: torch.Generator,
                device) -> torch.Tensor:
    """Standard-normal draws in float32 times ``scale``, cast to ``dtype``."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return out.mul_(scale).to(dtype)
