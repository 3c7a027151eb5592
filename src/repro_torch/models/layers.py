"""Shared model layers: norms, RoPE, attention entry point, MLP.

Port of ``repro/models/layers.py``.  Plain functions on tensors;
parameters are nested dicts of tensors (see ``models/model.py``).  The
sharding helpers ``axis_size``, ``dp_axes`` and ``resolve_spec`` read a
mesh's ``shape`` and ``axis_names`` as the reference's do (a
``core.compat.ShardMesh``, or anything with those two attributes).  The
reference's ``shard`` (a ``with_sharding_constraint`` for XLA's
partitioner) has no counterpart: the port has no partitioner, and a
layer's placement is what its caller gives it (``models/moe.py`` under a
mesh; dense layers keep their one-device arithmetic).  Activations run in ``COMPUTE_DTYPE`` (bfloat16);
each parameter is cast to the activation's dtype at its use, and the norm,
softmax, RoPE and SiLU arithmetic runs in float32 and is cast back, as in
the reference.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.core.compat import P
from repro_torch.kernels.attention.ops import flash_attention

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------
def axis_size(mesh, ax) -> int:
    """The ranks along ``ax``: an axis name, a tuple of names (their
    product) or None (1)."""
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        return math.prod(mesh.shape[a] for a in ax)
    return mesh.shape[ax]


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: ``("pod", "data")`` on a multi-pod mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def resolve_spec(mesh, shape, axes) -> P:
    """The partition spec of a tensor of ``shape`` whose dims want
    ``axes`` (each None, a name or a tuple of names): a name absent from
    the mesh is dropped, and a dim not divisible by its axes' product is
    not split, per dim, as the reference's resolver does."""
    spec = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            spec.append(None)
            continue
        names = ax if isinstance(ax, (tuple, list)) else (ax,)
        names = tuple(a for a in names if a in mesh.axis_names)
        if not names:
            spec.append(None)
            continue
        if dim % axis_size(mesh, names) == 0:
            spec.append(names if len(names) > 1 else names[0])
        else:
            spec.append(None)
    return P(*spec)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + w)`` (norm weights are zero-initialised),
    in float32, differentiated by autograd through its ops: the
    reference's ``REPRO_RMSNORM=ref`` baseline, with the same values as
    :func:`rmsnorm_fused`."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _rmsnorm_fwd(x, w, eps):
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * (1.0 + w.float())).to(x.dtype), rstd


def _rmsnorm_bwd(x, w, rstd, g):
    xf = x.float()
    xhat = xf * rstd
    gw = g.float() * (1.0 + w.float())
    mean_gx = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (gw - xhat * mean_gx)
    dw = (g.float() * xhat).sum(dim=tuple(range(x.ndim - 1)))
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNormFused(torch.autograd.Function):
    """The reference's ``rmsnorm_fused`` custom VJP: float32 math stays
    inside the op, and both cotangents leave in the storage dtypes."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = _rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd(x, w, rstd, g)
        return dx, dw, None


def rmsnorm_fused(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the hand-written backward (``_rmsnorm_bwd``)."""
    return _RMSNormFused.apply(x, w, eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's dispatcher: ``REPRO_RMSNORM=ref`` selects the
    plain-autodiff :func:`rmsnorm_ref`; the default is :func:`rmsnorm_fused`.
    Both forwards compute the same values, each in an ``rmsnorm`` span."""
    with trace.span("rmsnorm"):
        if os.environ.get("REPRO_RMSNORM", "fused") == "ref":
            return rmsnorm_ref(x, w, eps)
        return rmsnorm_fused(x, w, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] (D even), positions [..., S] -> x rotated (the two
    halves of D, as in the reference), computed in float32; a ``rope``
    span."""
    with trace.span("rope"):
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
    head dim that is a multiple of 16 up to 256 (every registered config,
    MLA's 192 among them) runs on the tensor cores and rounds p to bfloat16
    before ``p @ v``, as the reference's Pallas kernel does; float32, and
    other head dims, run on the CUDA cores with p in float32.  Sq and Skv
    need not divide any chunk length.
    """
    return flash_attention(q, k, v, causal=causal)


def normal_init(shape, dtype, scale: float, *, generator: torch.Generator,
                device) -> torch.Tensor:
    """Standard-normal draws in float32 times ``scale``, cast to ``dtype``."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return out.mul_(scale).to(dtype)
