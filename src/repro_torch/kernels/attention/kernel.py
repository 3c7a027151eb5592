"""Flash attention (forward): the Hopper kernel and its plain version.

Port of ``repro/kernels/attention/kernel.py::flash_attention_pallas``, the
kernel the JAX package wrote to slot in behind
``repro/models/layers.py::chunked_attention``.  The function is
``chunked_attention``'s: q ``[B, Sq, H, D]``, k/v ``[B, Skv, KH, D]`` (GQA,
query head ``h`` reads kv head ``h // (H // KH)``), scores in float32
scaled by ``1/sqrt(D)``, the causal mask ``q_pos >= k_pos`` filled with
``-1e30``, an online softmax over kv blocks with the ``max(l, 1e-30)``
guard, ``p @ v`` in float32 (the Pallas body rounds ``p`` to ``v.dtype``
first; ``chunked_attention`` does not, and neither does this), and the
output rounded once to ``q.dtype``.

:func:`flash_attention_kernel` launches ``kernels/csrc/flash_attention.cu``
for CUDA tensors and takes the plain version, :func:`flash_attention_plain`,
only for CPU tensors.  Every launch adds one to
``flash_attention_kernel.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.device import on_cuda
from repro_torch.kernels import _build

NEG_INF = -1e30
# chunked_attention's q and kv chunk lengths (the plain version's blocks)
Q_CHUNK = KV_CHUNK = 1024
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, ...]:
    """Validate the operands; returns (B, Sq, Skv, H, KH, D)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,H,D] and k, v [B,Skv,KH,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, KH, Dk = k.shape
    if Bk != B or Dk != D or KH == 0 or H % KH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "(batch, head_dim, or H not a multiple of KH)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    return B, Sq, Skv, H, KH, D


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version: ``chunked_attention``'s online softmax over
    q chunks and kv chunks of 1,024 (ragged last chunks allowed).  A kv
    chunk wholly above the causal diagonal is skipped: its probabilities
    are exactly 0 and its correction exactly 1."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    rep = H // KH
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Sq, Q_CHUNK):
        qg = q[:, q0:q0 + Q_CHUNK].float()
        Qc = qg.shape[1]
        qg = qg.reshape(B, Qc, KH, rep, D)
        q_pos = torch.arange(q0, q0 + Qc, device=q.device)
        m = torch.full((B, KH, rep, Qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KH, rep, Qc, D), dtype=torch.float32, device=q.device)
        kv_end = min(Skv, q0 + Qc) if causal else Skv
        for k0 in range(0, kv_end, KV_CHUNK):
            kc, vc = kf[:, k0:k0 + KV_CHUNK], vf[:, k0:k0 + KV_CHUNK]
            s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kc) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, vc)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + Qc] = o.permute(0, 3, 1, 2, 4).reshape(B, Qc, H, D).to(q.dtype)
    return out


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] (float32 or bfloat16) -> [B,Sq,H,D]
    in q's dtype.

    On CUDA tensors: launches ``flash_attention.cu`` on the current stream,
    reading the operands through their batch/sequence/head strides (the
    head dim must be contiguous); raises on what the kernel does not take
    (D > 256 or not a multiple of 8, another dtype) or if the launch fails.
    On CPU tensors: :func:`flash_attention_plain`.
    """
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    if not on_cuda(q):
        return flash_attention_plain(q, k, v, causal=causal)
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"the flash-attention kernel takes head_dim <= {MAX_HEAD_DIM} "
                         f"and a multiple of 8, got {D}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()  # no keys: the plain version's acc / max(l, 1e-30) = 0
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KH, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
