"""Batched LCS of pre-gathered rows: the Hopper kernel and its plain version.

Port of ``repro/kernels/lcs/kernel.py::lcs_pallas``.  The CUDA source is
``kernels/csrc/lcs.cu`` (one thread per row pair, exact row DP; its header
notes the bound and the design).  :func:`route` sends widths up to 32 to
the register kernels (the width a template argument, 128 rows a block
staged through shared memory with 16-byte loads) and wider rows to the
shared-memory kernel; the launcher runs the route it is given.
:func:`lcs_kernel` launches it for a CUDA tensor and takes the plain
version, :func:`lcs_plain` (the anti-diagonal wavefront of
``core/similarity.py``), only for a CPU tensor.  Every launch adds one to
``lcs_kernel.launches`` and to its route's count in
``lcs_kernel.launches_by_route``.  :func:`launch` runs a route or a
variant by name, for timing only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.similarity import check_lcs_len, lcs_wavefront
from repro_torch.kernels import _build

# Sentinels of the rolling-window wavefront (fused.py's plain version): the
# window pad is -3 and the a-shift pad is -4, so no padding combination ever
# matches a code or a side sentinel (-1/-2).
SENT_WINDOW = -3
SENT_SHIFT = -4

# The shared-memory kernels (this one's and the fused scorers') keep two
# [L][threads] int32 arrays in shared memory and stay within the default
# 48 KB a block may use without an opt-in attribute.
_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 1024

# widest row the register route takes; the launcher has a register kernel
# for every width up to csrc/pair_dp.cuh kMaxRegisterWidth and refuses wider
MAX_REGISTER_WIDTH = 32
# the launcher's route codes (csrc/pair_dp.cuh kRouteRegisters, kRouteShared)
ROUTES = ("registers", "shared")
# the register route's block: 128 rows a block, one a thread (csrc/lcs.cu
# kRowsPerBlock; the launcher refuses another)
REGISTER_THREADS = 128
# the variant launcher's codes (csrc/lcs.cu): the register route without
# its DP, at widths 10 and 8; for timing only
VARIANTS = {"loads_only": 0}


def route(L: int) -> str:
    """The kernel route of a row (or DP) width: ``"registers"`` (the width a
    template argument, rows and DP in registers) up to 32, ``"shared"`` (the
    runtime-width body, rows and DP in shared memory) up to 126; a width
    outside [1, 126] raises ``ValueError``."""
    if L < 1:
        raise ValueError("lcs rows must hold at least one position")
    check_lcs_len(L)
    return "registers" if L <= MAX_REGISTER_WIDTH else "shared"


def threads_for(L: int, cap: int) -> int:
    """Largest power-of-two block size <= ``cap`` whose shared memory fits
    (the shared route's block)."""
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


# ctypes prototypes of csrc/lcs.cu's launchers: the engine's ends in
# ``int route``, the variant launcher's in ``int variant``
LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str = "lcs_launch"):
    fn = getattr(_build.load("lcs"), symbol)
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
           block_b: int = 512) -> None:
    """Run one of :data:`ROUTES` (at this width, whatever :func:`route` would
    pick) or :data:`VARIANTS` on contiguous CUDA operands into the
    preallocated ``out`` [B], unchecked and uncounted; the shared route's
    block is ``threads_for(L, block_b)``.  Raises if the launcher has no
    kernel for it at this width.  :func:`lcs_kernel` runs ``route(L)``
    through it; a route by name, or a variant, is for timing only."""
    B, L = a.shape
    threads = threads_for(L, block_b) if name == "shared" else REGISTER_THREADS
    if name in ROUTES:
        fn, code = _launcher(), ROUTES.index(name)
    else:
        fn, code = _launcher("lcs_variant_launch"), VARIANTS[name]
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, L, threads,
             torch.cuda.current_stream(a.device).cuda_stream, code)
    _build.check(err, f"lcs kernel {name}")


def lcs_kernel(a: torch.Tensor, b: torch.Tensor, *, block_b: int = 512) -> torch.Tensor:
    """a, b: int32 [B, L] (sentinel-padded: side A -1, side B -2) -> int32 [B].

    On a CUDA tensor: launches ``lcs.cu`` on ``route(L)`` on the current
    stream (raises if the launch fails), counted in ``launches`` and
    ``launches_by_route``; the register route runs 128 threads a block, the
    shared route at most ``block_b``.  On a CPU tensor: :func:`lcs_plain`.
    """
    B, L = check_rows(a, b)
    if not on_cuda(a):
        return lcs_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((B,), dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    path = route(L)
    launch(path, a, b, out, block_b=block_b)
    lcs_kernel.launches += 1
    lcs_kernel.launches_by_route[path] += 1
    return out


lcs_kernel.launches = 0
lcs_kernel.launches_by_route = {"registers": 0, "shared": 0}
