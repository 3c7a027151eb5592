"""Shingle key generation: the Hopper kernel and its plain version.

Port of ``repro/kernels/shingle/kernel.py::shingle_pallas``.  For every row
and every one of the C(L, k) index combinations of the static table
``core/shingling.shingle_indices(L, k)``, the row's type codes at the
combination's positions are packed in base Q into one int32 key; a
combination whose last index is at or past the row's length, and every
column from C(L, k) up to ``s_pad``, holds ``PAD_KEY``.

The TPU kernel selected the codes with f32 one-hot matmuls (exact there
only because codes < 2**24); the CUDA source ``kernels/csrc/shingle.cu``
gathers in integer arithmetic instead: a persistent grid of warps, each
lane holding four columns' combination indices in registers, codes picked
by warp shuffles (or from a per-warp shared-memory slice for rows wider
than 32), 16-byte streaming stores (its header notes the bound and the
design).  :func:`shingle_kernel` launches it for a CUDA tensor and takes
the plain version, :func:`shingle_plain`, only for a CPU tensor.  Every
launch adds one to ``shingle_kernel.launches``.  :func:`launch` also runs
the first design or the loads and stores alone, for timing only.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.shingling import shingle_indices
from repro_torch.core.types import PAD_KEY
from repro_torch.kernels import _build

# widest row the kernel takes (csrc/shingle.cu kMaxWidth: one warp's
# shared-memory slice in 48 KB); C(L, k) stays within the combination
# budget past it only for k = 1 or k >= L - 1
MAX_WIDTH = 48 * 1024 // 4

# the variant launcher's codes (csrc/shingle.cu); only the smoke run calls
# them, to time the design's parts
VARIANTS = {
    "parent": 0,        # the first design: one thread per output int
    "loads_stores": 1,  # the engine kernel without its picks and pack (k = 3, L <= 32)
}


def check_types(types: torch.Tensor, lengths: torch.Tensor, k: int,
                s_pad: int) -> tuple[int, int, np.ndarray]:
    """Validate the operands; returns (N, L, the [S, k] combination table),
    S = C(L, k)."""
    if types.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"types and lengths must be int32, got {types.dtype}, {lengths.dtype}")
    if types.ndim != 2 or lengths.shape != types.shape[:1]:
        raise ValueError(f"types must be [N, L] and lengths [N], got "
                         f"{tuple(types.shape)} and {tuple(lengths.shape)}")
    if types.device != lengths.device:
        raise ValueError(f"types on {types.device}, lengths on {lengths.device}")
    if k < 1:
        raise ValueError(f"shingle order k must be positive, got {k}")
    N, L = types.shape
    combos = shingle_indices(L, k)
    if s_pad < combos.shape[0]:
        raise ValueError(f"s_pad = {s_pad} is below C({L}, {k}) = {combos.shape[0]}")
    return N, L, combos


def shingle_plain(types, lengths, *, k: int, num_types: int, s_pad: int) -> torch.Tensor:
    """The plain PyTorch version: int32 [N, L] types + [N] lengths -> int32
    [N, s_pad] raw (not deduplicated) keys, in int32 arithmetic that wraps
    as the reference's does."""
    N, _, combos = check_types(types, lengths, k, s_pad)
    S = combos.shape[0]
    idx = torch.as_tensor(combos, device=types.device).long()
    gathered = types[:, idx]                               # [N, S, k]
    key = torch.zeros((N, S), dtype=torch.int32, device=types.device)
    for j in range(k):
        key = key * num_types + gathered[..., j]
    valid = idx[:, -1][None, :] < lengths[:, None]
    out = torch.full((N, s_pad), PAD_KEY, dtype=torch.int32, device=types.device)
    out[:, :S] = torch.where(valid, key, PAD_KEY)
    return out


# ctypes prototypes of csrc/shingle.cu's launchers: the op's, and the
# variant launcher's (the same, ending in ``int variant``)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
VARIANT_ARGTYPES = LAUNCH_ARGTYPES + [ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _launcher(variant: bool):
    symbol = "shingle_variant_launch" if variant else "shingle_launch"
    fn = getattr(_build.load("shingle"), symbol)
    fn.argtypes = VARIANT_ARGTYPES if variant else LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def device_combos(L: int, k: int, device: torch.device) -> torch.Tensor:
    """The [C(L, k), k] int32 combination table on ``device``, uploaded once
    per (L, k, device)."""
    return torch.as_tensor(shingle_indices(L, k), device=device).contiguous()


def launch(name: str, types: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor, *,
           k: int, num_types: int) -> None:
    """Run the op's kernel (``"engine"``) or one of :data:`VARIANTS` on
    contiguous CUDA operands into the preallocated ``out`` [N, s_pad],
    uncounted; raises if the launch fails or the variant has no kernel at
    this shape.  :func:`shingle_kernel` runs ``"engine"``; the variants are
    for timing only."""
    N, L = types.shape
    combos = device_combos(L, k, types.device)
    args = [types.data_ptr(), lengths.data_ptr(), combos.data_ptr(), out.data_ptr(), N, L, k,
            combos.shape[0], out.shape[1], num_types,
            torch.cuda.current_stream(types.device).cuda_stream]
    if name != "engine":
        args.append(VARIANTS[name])
    _build.check(_launcher(name != "engine")(*args), f"shingle kernel {name}")


def shingle_kernel(types: torch.Tensor, lengths: torch.Tensor, *, k: int,
                   num_types: int, s_pad: int) -> torch.Tensor:
    """types int32 [N, L], lengths int32 [N] -> raw keys int32 [N, s_pad].

    On a CUDA tensor: launches ``shingle.cu`` on the current stream (raises
    if the launch fails, or for rows wider than :data:`MAX_WIDTH`).  On a
    CPU tensor: :func:`shingle_plain`.
    """
    if not on_cuda(types):
        return shingle_plain(types, lengths, k=k, num_types=num_types, s_pad=s_pad)
    N, L, _ = check_types(types, lengths, k, s_pad)
    if L > MAX_WIDTH:
        raise ValueError(f"shingle kernel takes rows of at most {MAX_WIDTH} codes, got {L}")
    types, lengths = types.contiguous(), lengths.contiguous()
    out = torch.empty((N, s_pad), dtype=torch.int32, device=types.device)
    if N == 0 or s_pad == 0:
        return out
    launch("engine", types, lengths, out, k=k, num_types=num_types)
    shingle_kernel.launches += 1
    return out


shingle_kernel.launches = 0
