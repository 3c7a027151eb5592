"""Flash attention: the Hopper forward kernels, their plain version and the
gradient.

Port of ``repro/kernels/attention/kernel.py::flash_attention_pallas``, the
kernel the JAX package wrote to slot in behind
``repro/models/layers.py::chunked_attention``.  The function is
``chunked_attention``'s: q ``[B, Sq, H, D]``, k/v ``[B, Skv, KH, D]`` (GQA,
query head ``h`` reads kv head ``h // (H // KH)``), scores in float32
scaled by ``1/sqrt(D)``, the causal mask ``q_pos >= k_pos`` filled with
``-1e30``, an online softmax over kv blocks with the ``max(l, 1e-30)``
guard (``l`` summed from the float32 ``p``), and the output rounded once to
``q.dtype``.

:func:`flash_attention_kernel` launches one of two CUDA kernels for CUDA
tensors, by dtype and head dim (:func:`route`), and takes the plain
version, :func:`flash_attention_plain`, only for CPU tensors:

- ``"wgmma"``: bfloat16 with D a multiple of 16 up to 256 (every head dim
  of the registered configs: 80, 96, 112 and 128, and MLA's 192) runs
  ``kernels/csrc/flash_attention_sm90.cu`` on the tensor cores (``wgmma``
  fed by TMA) over key tiles of :func:`key_tile` keys.  It rounds ``p`` to
  bfloat16 before ``p @ v``, as the Pallas body does
  (``p.astype(v.dtype)``); within 3e-2 of the plain version.
- ``"cuda_cores"``: float32, and bfloat16 head dims outside that set (72,
  136, 200, ...), run ``kernels/csrc/flash_attention.cu`` in float32 on the
  CUDA cores, with ``p @ v`` in float32 as ``chunked_attention`` computes
  it.

The plain version keeps ``p`` in float32, as ``chunked_attention`` does.
Every launch adds one to ``flash_attention_kernel.launches`` and to its
route's entry of ``flash_attention_kernel.launches_by_route``; an operand
copied to meet a kernel's layout rules adds one to
``flash_attention_kernel.copies``.

:func:`flash_attention_bwd` is the function's gradient in torch ops (the
JAX package has no backward kernel: ``jax.grad`` of ``chunked_attention``
is its gradient); ``ops.flash_attention`` pairs it with the forward.
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
_HEAD = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
# route -> (csrc source, C launcher, its ctypes argument types)
LAUNCHERS = {
    "wgmma": ("flash_attention_sm90", "flash_attention_sm90_launch",
              _HEAD + [ctypes.c_int, ctypes.c_void_p]),
    "cuda_cores": ("flash_attention", "flash_attention_launch",
                   _HEAD + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True):
    """The gradient of :func:`flash_attention_plain`'s function (the
    reference's ``chunked_attention``, p in float32) in torch ops:
    ``(dq, dk, dv)`` in the inputs' dtypes.

    The flash-attention backward over q chunks of ``Q_CHUNK``: each
    chunk's float32 scores are recomputed against the kv chunks (those
    wholly above the causal diagonal skipped), first for each row's
    logsumexp (with the forward's ``max(l, 1e-30)`` guard), then for
    ``p``; with ``D = rowsum(dout * out)``, ``dv += p^T dout``,
    ``dp = dout v^T``, ``ds = p (dp - D)``, ``dq += ds k / sqrt(D)`` and
    ``dk += ds^T q / sqrt(D)``.  dk and dv sum over the ``H // KH`` query
    heads that read each kv head.  No [B, H, S, S] matrix is formed: the
    largest temporary is one [B, H, Q_CHUNK, KV_CHUNK] block."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    rep = H // KH
    scale = 1.0 / math.sqrt(D)
    f32 = dict(dtype=torch.float32, device=q.device)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Sq, H, D), **f32)
    dk = torch.zeros((B, Skv, KH, D), **f32)
    dv = torch.zeros((B, Skv, KH, D), **f32)
    for q0 in range(0, Sq, Q_CHUNK):
        Qc = min(Q_CHUNK, Sq - q0)
        qg, dog, og = (t[:, q0:q0 + Qc].float().reshape(B, Qc, KH, rep, D) for t in (q, dout, out))
        delta = (dog * og).sum(dim=-1).permute(0, 2, 3, 1)  # [B, KH, rep, Qc]
        q_pos = torch.arange(q0, q0 + Qc, device=q.device)
        kv_end = min(Skv, q0 + Qc) if causal else Skv
        chunks = range(0, kv_end, KV_CHUNK)

        def scores(k0):
            s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kf[:, k0:k0 + KV_CHUNK]) * scale
            if causal:
                k_pos = torch.arange(k0, min(k0 + KV_CHUNK, Skv), device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            return s

        m = torch.full((B, KH, rep, Qc), NEG_INF, **f32)
        l = torch.zeros_like(m)
        for k0 in chunks:
            s = scores(k0)
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
            m = m_new
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        dqg = torch.zeros((B, KH, rep, Qc, D), **f32)
        for k0 in chunks:
            kc, vc = kf[:, k0:k0 + KV_CHUNK], vf[:, k0:k0 + KV_CHUNK]
            p = torch.exp(scores(k0) - lse[..., None])
            ds = p * (torch.einsum("bqhrd,bkhd->bhrqk", dog, vc) - delta[..., None])
            dv[:, k0:k0 + KV_CHUNK] += torch.einsum("bhrqk,bqhrd->bkhd", p, dog)
            dk[:, k0:k0 + KV_CHUNK] += torch.einsum("bhrqk,bqhrd->bkhd", ds, qg) * scale
            dqg += torch.einsum("bhrqk,bkhd->bhrqd", ds, kc) * scale
        dq[:, q0:q0 + Qc] = dqg.permute(0, 3, 1, 2, 4).reshape(B, Qc, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches:
    ``"wgmma"`` for bfloat16 with D a multiple of 16 (up to 256), else
    ``"cuda_cores"``.  Raises on what neither takes (another dtype, D over
    256 or not a multiple of 8)."""
    if dtype not in _DTYPES:
        raise TypeError(f"the flash-attention kernels take float32 or bfloat16, got {dtype}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"the flash-attention kernels take head_dim <= {MAX_HEAD_DIM} "
                         f"and a multiple of 8, got {D}")
    if dtype == torch.bfloat16 and D % 16 == 0:
        return "wgmma"
    return "cuda_cores"


# keys per k/v tile of the wgmma kernel by 64-column chunks of the head dim
# (flash_attention_sm90.cu's Tile table): 128 up to D = 128, and past it as
# many as the 227 KB of shared memory a block may use leave room for
_KEY_TILE = {1: 128, 2: 128, 3: 64, 4: 64}


def key_tile(D: int) -> int:
    """Keys per k/v tile of the ``"wgmma"`` kernel at head dim ``D``: the
    online softmax's block, so the kernel's numbers depend on it."""
    return _KEY_TILE[-(-D // 64)]


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` [B, S, heads, D] in place: head dim
    contiguous, a 16-byte-aligned address, and 16-byte multiples as the
    strides of the dims longer than 1."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(st * t.element_size() % 16 == 0
               for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _launcher(path: str):
    source, symbol, argtypes = LAUNCHERS[path]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(path: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """Launch route ``path``'s kernel on CUDA operands it reads in place
    (Skv >= 1) and return the output; raises if the launch fails.  Counts
    nothing: :func:`flash_attention_kernel` is the entry point, this is its
    last step (and how a comparison runs a route by name)."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dtype = () if path == "wgmma" else (_DTYPES[q.dtype],)
    # the launcher runs on the thread's current card: make it the operands'
    with torch.cuda.device(q.device):
        err = _launcher(path)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KH, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), *dtype, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, f"flash_attention_kernel ({path})")
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] (float32 or bfloat16) -> [B,Sq,H,D]
    in q's dtype.

    On CUDA tensors: launches the kernel :func:`route` names on the current
    stream, reading the operands through their batch/sequence/head strides.
    An operand the kernel cannot read in place (head dim not contiguous; for
    ``"wgmma"``, not :func:`tma_ready`) is copied with ``.contiguous()``
    first.  Raises on what neither kernel takes or if the launch fails;
    nothing falls back to the other kernel or the plain version.  On CPU
    tensors: :func:`flash_attention_plain`.
    """
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    if not on_cuda(q):
        return flash_attention_plain(q, k, v, causal=causal)
    path = route(q.dtype, D)
    if q.numel() == 0 or Skv == 0:  # no keys: the plain version's acc / max(l, 1e-30) = 0
        return torch.zeros((B, Sq, H, D), dtype=q.dtype, device=q.device)
    ready = tma_ready if path == "wgmma" else (lambda t: t.stride(-1) == 1)
    ops = []
    for t in (q, k, v):
        if not ready(t):
            t = t.contiguous()
            flash_attention_kernel.copies += 1
        ops.append(t)
    out = launch(path, *ops, causal=causal)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_route[path] += 1
    return out


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
flash_attention_kernel.copies = 0
