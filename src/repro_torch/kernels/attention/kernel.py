"""Flash attention: the Hopper kernels, forward and backward, their plain
versions and the gradient's route.

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

The gradient (the JAX package has no backward kernel: ``jax.grad`` of
``chunked_attention`` is its gradient) takes one of two routes, by
:func:`bwd_route`, through :func:`flash_attention_backward`:

- ``"wgmma"``, exactly where the forward runs ``"wgmma"`` on CUDA:
  ``kernels/csrc/flash_attention_bwd_sm90.cu``, hand-written bf16 kernels
  (delta, then dK/dV a key tile a block, then dQ a query tile a block) on
  the tensor cores.  They read the float32 logsumexp that the forward's
  ``with_lse`` instantiation saves; p and ds are rounded to bfloat16 as
  product operands (the forward's rounding of p), the softmax, delta and
  every accumulator stay float32, and each output row is written by one
  block (no atomics: two calls give the same bits).
- ``"torch_ops"``, for float32, other head dims and CPU tensors:
  :func:`flash_attention_bwd`, the gradient in float32 torch ops and the
  kernels' plain version.

``ops.flash_attention`` pairs them with the forward.
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
# the forward's routes, and "bwd" (the backward's "wgmma" kernels) ->
# (csrc source, C launcher, its ctypes argument types)
LAUNCHERS = {
    "wgmma": ("flash_attention_sm90", "flash_attention_sm90_launch",
              _HEAD + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "cuda_cores": ("flash_attention", "flash_attention_launch",
                   _HEAD + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    # q, k, v, out, dout, lse, delta, dq, dk, dv; B, Sq, Skv, H, KH, D; the
    # (batch, sequence, head) strides of q, k, v, out, dout; causal; the stream
    "bwd": ("flash_attention_bwd_sm90", "flash_attention_bwd_sm90_launch",
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
            + [ctypes.c_int, ctypes.c_void_p]),
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
           causal: bool, lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch route ``path``'s kernel on CUDA operands it reads in place
    (Skv >= 1) and return the output; raises if the launch fails.  ``lse``
    (``"wgmma"`` only): a float32 contiguous [B, H, Sq] that the kernel's
    other instantiation fills with each row's logsumexp.  Counts nothing:
    :func:`flash_attention_kernel` is the entry point, this is its last step
    (and how a comparison runs a route by name)."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if path == "wgmma":
        last = (None if lse is None else lse.data_ptr(),)
    elif lse is None:
        last = (_DTYPES[q.dtype],)
    else:
        raise ValueError(f"only the wgmma route writes the logsumexp, not {path!r}")
    # the launcher runs on the thread's current card: make it the operands'
    with torch.cuda.device(q.device):
        err = _launcher(path)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KH, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), *last, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, f"flash_attention_kernel ({path})")
    return out


def _readable(path: str, ts, counter) -> list:
    """``ts`` as route ``path``'s kernels read them: an operand that breaks
    their layout rules is copied with ``.contiguous()``, one on ``counter``."""
    ready = tma_ready if path == "wgmma" else (lambda t: t.stride(-1) == 1)
    ops = []
    for t in ts:
        if not ready(t):
            t = t.contiguous()
            counter.copies += 1
        ops.append(t)
    return ops


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, with_lse: bool = False):
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] (float32 or bfloat16) -> [B,Sq,H,D]
    in q's dtype; with ``with_lse`` (the ``"wgmma"`` route only, the
    forward of a call that records a gradient), ``(out, lse)`` with the
    float32 [B, H, Sq] logsumexp of each row's scaled scores that
    :func:`flash_attention_backward` reads.

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
        if with_lse:
            raise ValueError("the logsumexp comes from the wgmma kernel, not the plain version")
        return flash_attention_plain(q, k, v, causal=causal)
    path = route(q.dtype, D)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if q.numel() == 0 or Skv == 0:  # no keys: the plain version's acc / max(l, 1e-30) = 0
        out = torch.zeros((B, Sq, H, D), dtype=q.dtype, device=q.device)
        return (out, lse.fill_(NEG_INF)) if with_lse else out
    out = launch(path, *_readable(path, (q, k, v), flash_attention_kernel), causal=causal, lse=lse)
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_route[path] += 1
    return (out, lse) if with_lse else out


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
flash_attention_kernel.copies = 0


def bwd_route(dtype: torch.dtype, D: int, cuda: bool = True) -> str:
    """The backward a call's gradient takes: ``"wgmma"``
    (``kernels/csrc/flash_attention_bwd_sm90.cu``) exactly where the
    forward runs ``"wgmma"`` (CUDA, bfloat16, D a multiple of 16 up to 256),
    else ``"torch_ops"`` (:func:`flash_attention_bwd`: float32, other head
    dims, CPU tensors)."""
    return "wgmma" if cuda and route(dtype, D) == "wgmma" else "torch_ops"


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
               dout: torch.Tensor, lse: torch.Tensor, *, causal: bool):
    """The ``"wgmma"`` backward's three kernels (delta, dK/dV, dQ) on CUDA
    operands they read in place (Sq, Skv >= 1): ``(dq, dk, dv)`` in the
    inputs' dtype.  Counts nothing; raises if the launch fails."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk, dv = (torch.empty((B, Skv, KH, D), dtype=k.dtype, device=k.device) for _ in range(2))
    with torch.cuda.device(q.device):
        err = _launcher("bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, H, KH, D,
            *(st for t in (q, k, v, out, dout) for st in t.stride()[:3]),
            int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "flash_attention_backward (wgmma)")
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor | None, *, causal: bool = True):
    """The gradient ``(dq, dk, dv)`` of a forward whose output is ``out``,
    in the inputs' dtypes, by :func:`bwd_route`: on ``"wgmma"`` the
    hand-written kernels (p and ds rounded to bfloat16 as product operands,
    float32 softmax, delta and accumulators; one block writes each output
    row, so two calls give the same bits), reading ``lse``, the forward's
    logsumexp; on ``"torch_ops"`` :func:`flash_attention_bwd`, which needs
    no ``lse``.  Each launch (or ``flash_attention_bwd`` call) adds one to
    its route's entry of ``flash_attention_backward.launches_by_route``; an
    empty call (no queries or no keys) launches nothing and counts nothing,
    as the forward does; an operand copied for
    TMA's layout rules adds one to ``flash_attention_backward.copies``."""
    B, Sq, Skv, H, KH, D = check_operands(q, k, v)
    path = bwd_route(q.dtype, D, on_cuda(q))
    if path == "torch_ops":
        grads = flash_attention_bwd(q, k, v, out, dout, causal=causal)
    elif q.numel() == 0 or Skv == 0:  # out = 0 whatever q, k, v: every gradient is 0, nothing launched
        return tuple(torch.zeros_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    else:
        if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
            raise ValueError(f"the wgmma backward reads the forward's float32 [B, H, Sq] logsumexp, "
                             f"got {None if lse is None else (tuple(lse.shape), lse.dtype)}")
        if out.shape != q.shape or dout.shape != q.shape:
            raise ValueError(f"out and dout must be {tuple(q.shape)}, got {tuple(out.shape)}, "
                             f"{tuple(dout.shape)}")
        ops = _readable(path, (q, k, v, out, dout.to(q.dtype)), flash_attention_backward)
        grads = launch_bwd(*ops, lse, causal=causal)
    flash_attention_backward.launches_by_route[path] += 1
    return grads


flash_attention_backward.launches_by_route = {"wgmma": 0, "torch_ops": 0}
flash_attention_backward.copies = 0
