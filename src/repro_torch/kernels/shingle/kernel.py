"""Shingle key generation: the Hopper kernel and its plain version.

Port of ``repro/kernels/shingle/kernel.py::shingle_pallas``.  For every row
and every one of the C(L, k) index combinations of the static table
``core/shingling.shingle_indices(L, k)``, the row's type codes at the
combination's positions are packed in base Q into one int32 key; a
combination whose last index is at or past the row's length, and every
column from C(L, k) up to ``s_pad``, holds ``PAD_KEY``.

The TPU kernel selected the codes with f32 one-hot matmuls (exact there
only because codes < 2**24); the CUDA source ``kernels/csrc/shingle.cu``
gathers by the combination table in integer arithmetic instead (its header
notes the bound and the design).  :func:`shingle_kernel` launches it for a
CUDA tensor and takes the plain version, :func:`shingle_plain`, only for a
CPU tensor.  Every launch adds one to ``shingle_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.shingling import shingle_indices
from repro_torch.core.types import PAD_KEY
from repro_torch.kernels import _build

# threads per block of the shingle kernel
_SHINGLE_THREADS = 256


def check_types(types: torch.Tensor, lengths: torch.Tensor, k: int, s_pad: int) -> tuple[int, int, int]:
    """Validate the operands; returns (N, L, S) with S = C(L, k)."""
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
    S = shingle_indices(L, k).shape[0]
    if s_pad < S:
        raise ValueError(f"s_pad = {s_pad} is below C({L}, {k}) = {S}")
    return N, L, S


def shingle_plain(types, lengths, *, k: int, num_types: int, s_pad: int) -> torch.Tensor:
    """The plain PyTorch version: int32 [N, L] types + [N] lengths -> int32
    [N, s_pad] raw (not deduplicated) keys, in int32 arithmetic that wraps
    as the reference's does."""
    N, L, S = check_types(types, lengths, k, s_pad)
    idx = torch.as_tensor(shingle_indices(L, k), device=types.device).long()
    gathered = types[:, idx]                               # [N, S, k]
    key = torch.zeros((N, S), dtype=torch.int32, device=types.device)
    for j in range(k):
        key = key * num_types + gathered[..., j]
    valid = idx[:, -1][None, :] < lengths[:, None]
    out = torch.full((N, s_pad), PAD_KEY, dtype=torch.int32, device=types.device)
    out[:, :S] = torch.where(valid, key, PAD_KEY)
    return out


def _launcher():
    fn = _build.load("shingle").shingle_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def shingle_kernel(types: torch.Tensor, lengths: torch.Tensor, *, k: int,
                   num_types: int, s_pad: int) -> torch.Tensor:
    """types int32 [N, L], lengths int32 [N] -> raw keys int32 [N, s_pad].

    On a CUDA tensor: launches ``shingle.cu`` on the current stream (raises
    if the launch fails).  On a CPU tensor: :func:`shingle_plain`.
    """
    N, L, S = check_types(types, lengths, k, s_pad)
    if not on_cuda(types):
        return shingle_plain(types, lengths, k=k, num_types=num_types, s_pad=s_pad)
    types, lengths = types.contiguous(), lengths.contiguous()
    combos = torch.as_tensor(shingle_indices(L, k), device=types.device).contiguous()
    out = torch.empty((N, s_pad), dtype=torch.int32, device=types.device)
    if N == 0:
        return out
    err = _launcher()(
        types.data_ptr(), lengths.data_ptr(), combos.data_ptr(), out.data_ptr(),
        N, L, k, S, s_pad, num_types, _SHINGLE_THREADS,
        torch.cuda.current_stream(types.device).cuda_stream,
    )
    _build.check(err, "shingle_kernel")
    shingle_kernel.launches += 1
    return out


shingle_kernel.launches = 0
