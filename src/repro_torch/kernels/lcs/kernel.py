"""Batched LCS of pre-gathered rows: the Hopper kernel and its plain version.

Port of ``repro/kernels/lcs/kernel.py::lcs_pallas``.  The CUDA source is
``kernels/csrc/lcs.cu`` (one thread per row, exact row DP; its header notes
the bound and the design).  :func:`lcs_kernel` launches it for a CUDA
tensor and takes the plain version, :func:`lcs_plain` (the anti-diagonal
wavefront of ``core/similarity.py``), only for a CPU tensor.  Every launch
adds one to ``lcs_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.similarity import check_lcs_len, lcs_wavefront
from repro_torch.kernels import _build

# Sentinels of the rolling-window wavefront (fused.py's plain version): the
# window pad is -3 and the a-shift pad is -4, so no padding combination ever
# matches a code or a side sentinel (-1/-2).
SENT_WINDOW = -3
SENT_SHIFT = -4

# Both kernels keep two [L][threads] int32 arrays in shared memory and stay
# within the default 48 KB a block may use without an opt-in attribute.
_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 1024


def threads_for(L: int, cap: int) -> int:
    """Largest power-of-two block size <= ``cap`` whose shared memory fits."""
    limit = min(cap, _MAX_THREADS, _SMEM_BYTES // (2 * L * 4))
    t = 1
    while t * 2 <= limit:
        t *= 2
    return t


def check_rows(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """Validate a kernel operand pair: int32, contiguous, same [B, L] shape,
    same device, 1 <= L < 127.  Returns (B, L)."""
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"lcs operands must share one [B, L] shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"lcs operands must be int32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"lcs operands on {a.device} and {b.device}")
    B, L = a.shape
    if L < 1:
        raise ValueError("lcs rows must hold at least one position")
    check_lcs_len(L)
    return B, L


def lcs_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: int32 [B, L] x2 -> int32 [B]."""
    return lcs_wavefront(a, b)


def _launcher():
    fn = _build.load("lcs").lcs_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lcs_kernel(a: torch.Tensor, b: torch.Tensor, *, block_b: int = 512) -> torch.Tensor:
    """a, b: int32 [B, L] (sentinel-padded: side A -1, side B -2) -> int32 [B].

    On a CUDA tensor: launches ``lcs.cu`` with at most ``block_b`` threads
    per block on the current stream (raises if the launch fails).  On a CPU
    tensor: :func:`lcs_plain`.
    """
    B, L = check_rows(a, b)
    if not on_cuda(a):
        return lcs_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((B,), dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    err = _launcher()(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L,
        threads_for(L, block_b), torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(err, "lcs_kernel")
    lcs_kernel.launches += 1
    return out


lcs_kernel.launches = 0
