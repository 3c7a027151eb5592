"""Plain oracle: full-softmax attention with GQA and causal masking (the
port of ``repro/kernels/attention/ref.py``), never through the kernel."""
from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] -> [B,Sq,H,D] (float32 softmax)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.tril(torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
