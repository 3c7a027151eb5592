"""Mamba-2 SSD intra-chunk step: the Hopper kernel and its plain version.

Port of ``repro/kernels/ssd/kernel.py::ssd_intra_pallas``, with the numbers
of ``repro/models/mamba.py::_ssd_chunked`` (the function the serving path
runs).  For every chunk and head, with ``cum`` the within-chunk cumulative
log decay:

    M[i, j]  = tril(C_i . B_j * exp(cum_i - cum_j)) * dt_j
    y[i]     = sum_j M[i, j] x_j                          (float32)
    state    = sum_j x_j^T B_j exp(cum_last - cum_j) dt_j  (float32)
    cdecay   = exp(cum_last)

B and C belong to the one group (G = 1), so ``C B^T`` is per chunk.
:func:`ssd_intra` launches ``kernels/csrc/ssd_intra.cu`` for CUDA tensors
and takes the plain version, :func:`ssd_intra_plain`, only for CPU
tensors.  Every launch adds one to ``ssd_intra.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device import on_cuda
from repro_torch.kernels import _build

MAX_CHUNK = MAX_STATE = MAX_HEAD_DIM = 128
# heads that share one block's C B^T in the kernel
HEADS_PER_BLOCK = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(x, cum, dt, B_, C_) -> tuple[int, int, int, int, int]:
    """Validate the operands; returns (BC, Q, H, P, N)."""
    if x.ndim != 4:
        raise ValueError(f"x must be [BC, Q, H, P], got {tuple(x.shape)}")
    BC, Q, H, P = x.shape
    if cum.shape != (BC, Q, H) or dt.shape != (BC, Q, H):
        raise ValueError(f"cum and dt must be {(BC, Q, H)}, got {tuple(cum.shape)}, {tuple(dt.shape)}")
    if B_.ndim != 3 or B_.shape[:2] != (BC, Q) or C_.shape != B_.shape:
        raise ValueError(f"B_ and C_ must be [{BC}, {Q}, N], got {tuple(B_.shape)}, {tuple(C_.shape)}")
    if cum.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"cum and dt must be float32, got {cum.dtype}, {dt.dtype}")
    if len({t.device for t in (x, cum, dt, B_, C_)}) != 1:
        raise ValueError("the SSD operands lie on different devices")
    return BC, Q, H, P, B_.shape[2]


def ssd_intra_plain(x, cum, dt, B_, C_, *, bf16_intra: bool = False):
    """The plain PyTorch version: x [BC,Q,H,P], cum/dt [BC,Q,H] float32,
    B_/C_ [BC,Q,N] -> (y [BC,Q,H,P], state [BC,H,P,N], cdecay [BC,H,1,1]),
    all float32.

    ``_ssd_chunked``'s intra-chunk arithmetic with the chunks flattened:
    ``bf16_intra`` rounds the score and decay matrices (and x, B) to
    bfloat16 as the reference does, and the products accumulate in float32.
    """
    BC, Q, H, P, N = check_operands(x, cum, dt, B_, C_)
    mm = torch.bfloat16 if bf16_intra else torch.float32
    scores = torch.einsum("cqn,ckn->cqk", C_.to(mm).float(), B_.to(mm).float()).to(mm)
    cum_h = cum.transpose(1, 2)  # [BC, H, Q]
    decay = torch.exp(cum_h[..., :, None] - cum_h[..., None, :]).to(mm)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = torch.where(tri, scores[:, None] * decay, torch.zeros((), dtype=mm, device=x.device)) \
        * dt.transpose(1, 2)[..., None, :].to(mm)
    xm = x.to(mm).float()
    y = torch.einsum("chqk,ckhp->cqhp", M.float(), xm)
    w = (torch.exp(cum[:, -1:, :] - cum) * dt).to(mm).float()  # [BC, Q, H]
    state = torch.einsum("ckn,ckhp->chpn", B_.to(mm).float(), xm * w[..., None])
    cdecay = torch.exp(cum[:, -1, :])[..., None, None]
    return y, state, cdecay


def _launcher():
    fn = _build.load("ssd_intra").ssd_intra_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra(x, cum, dt, B_, C_, *, bf16_intra: bool = False):
    """The intra-chunk step: ``(y, state, cdecay)`` as
    :func:`ssd_intra_plain` gives them.

    On CUDA tensors: launches ``ssd_intra.cu`` on the current stream; x, B_
    and C_ must share one dtype (float32 or bfloat16), Q, N and P be at
    most 128 and P a multiple of 4, and ``bf16_intra`` be off (the kernel
    computes in float32 only); raises otherwise or if the launch fails.
    On CPU tensors: :func:`ssd_intra_plain`.
    """
    BC, Q, H, P, N = check_operands(x, cum, dt, B_, C_)
    if not on_cuda(x):
        return ssd_intra_plain(x, cum, dt, B_, C_, bf16_intra=bf16_intra)
    if bf16_intra:
        raise ValueError("the SSD kernel computes in float32; bf16_intra runs only in "
                         "the plain version (CPU tensors)")
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"the SSD kernel takes x, B_, C_ of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if Q > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM or P % 4:
        raise ValueError(f"the SSD kernel takes chunk, state <= 128 and head_dim <= 128, "
                         f"a multiple of 4; got Q={Q}, N={N}, P={P}")
    x, cum, dt, B_, C_ = (t.contiguous() for t in (x, cum, dt, B_, C_))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((BC, Q, H, P), **f32)
    state = torch.empty((BC, H, P, N), **f32)
    cdecay = torch.empty((BC, H, 1, 1), **f32)
    if BC == 0 or Q == 0 or H == 0:
        return y, state, cdecay
    err = _launcher()(
        x.data_ptr(), cum.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        y.data_ptr(), state.data_ptr(), cdecay.data_ptr(),
        BC, Q, H, P, N, HEADS_PER_BLOCK, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd_intra")
    ssd_intra.launches += 1
    return y, state, cdecay


ssd_intra.launches = 0
