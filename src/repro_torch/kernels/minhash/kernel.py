"""MinHash signatures: the Hopper kernel and its plain version.

Port of ``repro/kernels/minhash/kernel.py::minhash_pallas``.  For every row
and every permutation ``p`` of the hash table ``ab [P, 2] = (a_p, b_p)``,
the signature is the minimum over the row's valid positions of the
reference's int32 hash of the type code (16-bit limb split, wrapping
products and sums, floor-mod by 2^31 - 1; :func:`minhash_plain` spells it
out), and INT32_MAX for an empty row.

:func:`minhash_kernel` launches ``kernels/csrc/minhash.cu`` for a CUDA
tensor and takes the plain version, :func:`minhash_plain`, only for a CPU
tensor.  Every launch adds one to ``minhash_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.types import PAD_KEY
from repro_torch.kernels import _build

# threads per block of the minhash kernel
_MINHASH_THREADS = 256
_MERSENNE = (1 << 31) - 1


def check_operands(types: torch.Tensor, lengths: torch.Tensor, ab: torch.Tensor) -> tuple[int, int, int]:
    """Validate the operands; returns (N, L, P)."""
    for name, t in (("types", types), ("lengths", lengths), ("ab", ab)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if types.ndim != 2 or lengths.shape != types.shape[:1]:
        raise ValueError(f"types must be [N, L] and lengths [N], got "
                         f"{tuple(types.shape)} and {tuple(lengths.shape)}")
    if ab.ndim != 2 or ab.shape[1] != 2:
        raise ValueError(f"ab must be [P, 2], got {tuple(ab.shape)}")
    if not (types.device == lengths.device == ab.device):
        raise ValueError(f"types on {types.device}, lengths on {lengths.device}, "
                         f"ab on {ab.device}")
    return types.shape[0], types.shape[1], ab.shape[0]


def minhash_plain(types: torch.Tensor, lengths: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: int32 [N, L] + [N] + [P, 2] -> int32 [N, P].

    Per row and permutation, the minimum of the reference's int32 hash over
    positions ``< lengths`` (INT32_MAX for an empty row), its operations
    replayed one for one: torch's int32 ``*`` and ``+`` wrap, and its
    integer ``%`` is floor-mod, as ``jnp``'s.
    """
    N, L, P = check_operands(types, lengths, ab)
    x = types
    valid = torch.arange(L, device=x.device)[None, :] < lengths[:, None]
    a_hi, a_lo, b = ab[:, 0] >> 16, ab[:, 0] & 0xFFFF, ab[:, 1]

    def mod_p(v):
        return torch.where(v >= _MERSENNE, v - _MERSENNE, v)

    sig = []
    for i in range(P):
        lo = (a_lo[i] * x) % _MERSENNE
        hi = (a_hi[i] * x) % _MERSENNE
        # hi * 2^16 mod p, in two 8-bit shifts (each product wraps in int32)
        hi = (hi * 256) % _MERSENNE
        hi = (hi * 256) % _MERSENNE
        h = mod_p(mod_p(lo + hi) + b[i])
        h = torch.where(valid, h, PAD_KEY)
        sig.append(h.min(dim=1).values)
    if not sig:
        return torch.empty((N, 0), dtype=torch.int32, device=x.device)
    return torch.stack(sig, dim=1)


def _launcher():
    fn = _build.load("minhash").minhash_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def minhash_kernel(types: torch.Tensor, lengths: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """types int32 [N, L], lengths int32 [N], ab int32 [P, 2] -> signatures
    int32 [N, P].

    On a CUDA tensor: launches ``minhash.cu`` on the current stream (raises
    if the launch fails).  On a CPU tensor: :func:`minhash_plain`.
    """
    N, L, P = check_operands(types, lengths, ab)
    if not on_cuda(types):
        return minhash_plain(types, lengths, ab)
    types, lengths, ab = types.contiguous(), lengths.contiguous(), ab.contiguous()
    out = torch.empty((N, P), dtype=torch.int32, device=types.device)
    if N == 0 or P == 0:
        return out
    err = _launcher()(
        types.data_ptr(), lengths.data_ptr(), ab.data_ptr(), out.data_ptr(),
        N, L, P, _MINHASH_THREADS, torch.cuda.current_stream(types.device).cuda_stream,
    )
    _build.check(err, "minhash_kernel")
    minhash_kernel.launches += 1
    return out


minhash_kernel.launches = 0
