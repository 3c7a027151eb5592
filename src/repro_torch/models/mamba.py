"""Mamba-2 (SSD) mixer: the chunked prefill path and the one-token decode
recurrence [arXiv:2405.21060].

Port of ``repro/models/mamba.py`` for one device.  The SSD core goes
through ``kernels/ssd/ops.ssd_chunked`` (the reference's ``_ssd_chunked``
semantics; the intra-chunk kernel on the card), everything around it is
torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models.layers import rmsnorm


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of width W: u [B,S,C], w [W,C] -> [B,S,C]."""
    W, S = w.shape[0], u.shape[1]
    u_pad = F.pad(u, (0, 0, W - 1, 0))
    out = u_pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + u_pad[:, i:i + S, :] * w[i]
    return out


def _silu_as(u: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(u.float()).to(dtype)


def _mixer(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """in-proj (z, x, B, C, dt) -> causal conv -> SSD -> gated RMSNorm ->
    out-proj.  Returns (out [B,S,d], pre-conv x channels, pre-conv B/C
    channels, final SSM state [B,H,P,N])."""
    Bz, S, _ = x.shape
    din = cfg.ssm_d_inner
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state

    zx = x @ p["w_zx"].to(x.dtype)
    z, xin_raw = zx[..., :din], zx[..., din:]
    bc_raw = x @ p["w_bc"].to(x.dtype)
    dt_raw = x @ p["w_dt"].to(x.dtype)

    xin = _silu_as(_causal_conv(xin_raw, p["conv_x"].to(x.dtype)), x.dtype)
    bc = _silu_as(_causal_conv(bc_raw, p["conv_bc"].to(x.dtype)), x.dtype)
    B_ = bc[..., :G * N].reshape(Bz, S, G, N)
    C_ = bc[..., G * N:].reshape(Bz, S, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, final_state = ssd_chunked(
        xin.reshape(Bz, S, H, P), dt, A, B_, C_, p["D"].float(),
        chunk=cfg.ssm_chunk, bf16_intra=cfg.ssm_bf16_intra,
    )
    y = y.reshape(Bz, S, din)
    y = y * _silu_as(z, y.dtype)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype), xin_raw, bc_raw, final_state


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The full Mamba-2 mixer: x [B,S,d] -> [B,S,d]."""
    return _mixer(x, p, cfg)[0]


def mamba_prefill(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """As :func:`mamba_block`, and the serving state after the prompt:
    ``conv_x``/``conv_bc`` (the last W-1 pre-conv inputs, left-padded with
    zeros when S < W-1) and ``ssm`` (the final SSD state, float32)."""
    out, xin_raw, bc_raw, final_state = _mixer(x, p, cfg)
    W, S = cfg.ssm_conv, x.shape[1]

    def hist(u):
        return F.pad(u, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):, :]

    return out, {"conv_x": hist(xin_raw), "conv_bc": hist(bc_raw), "ssm": final_state}


def mamba_decode_step(x: torch.Tensor, state: dict, p: dict, cfg: ModelConfig):
    """The one-token recurrence.  x [B,1,d]; state: conv_x [B,W-1,din],
    conv_bc [B,W-1,2GN], ssm [B,H,P,N] (float32).  Returns (y [B,1,d], the
    new state) as new tensors."""
    Bz = x.shape[0]
    din = cfg.ssm_d_inner
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    xt = x[:, 0, :]

    zx = xt @ p["w_zx"].to(xt.dtype)
    z, xin = zx[..., :din], zx[..., din:]
    bc = xt @ p["w_bc"].to(xt.dtype)
    dt_raw = xt @ p["w_dt"].to(xt.dtype)

    def conv_step(u, hist, w):  # u [B,C], hist [B,W-1,C], w [W,C]
        full = torch.cat([hist, u[:, None, :]], dim=1)  # [B,W,C]
        return torch.einsum("bwc,wc->bc", full, w), full[:, 1:, :]

    xin_c, conv_x_new = conv_step(xin, state["conv_x"], p["conv_x"].to(xt.dtype))
    bc_c, conv_bc_new = conv_step(bc, state["conv_bc"], p["conv_bc"].to(xt.dtype))
    xin_c = F.silu(xin_c.float())
    bc_c = F.silu(bc_c.float())
    B_ = bc_c[..., :G * N].reshape(Bz, G, N).repeat_interleave(H // G, dim=1)
    C_ = bc_c[..., G * N:].reshape(Bz, G, N).repeat_interleave(H // G, dim=1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)

    xh = xin_c.reshape(Bz, H, P)
    ssm = state["ssm"] * dA[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, B_)
    y = torch.einsum("bhpn,bhn->bhp", ssm, C_)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(Bz, din) * F.silu(z.float())
    y = rmsnorm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out[:, None, :], {"conv_x": conv_x_new, "conv_bc": conv_bc_new, "ssm": ssm}
