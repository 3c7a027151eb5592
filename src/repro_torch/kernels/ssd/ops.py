"""Public op: the chunked SSD scan through the Hopper intra-chunk kernels.

Port of ``repro/kernels/ssd/ops.py::ssd_chunked`` with the semantics of
``repro/models/mamba.py::_ssd_chunked``: the float32 within-chunk cumsum of
``dt * A``, the intra-chunk step (:func:`~repro_torch.kernels.ssd.kernel.
ssd_intra`: a CUDA kernel on the card, its plain version on the CPU), the
inter-chunk recurrence of the ``[H, P, N]`` states and the rank-one-per-
token inter-chunk output, in torch.  ``y_intra`` stays float32 until the
one final rounding to ``x.dtype``, as in ``_ssd_chunked`` (the Pallas op
rounds it to ``x.dtype`` first).  The Mamba-2 mixer (``models/mamba.py``)
calls this op.

The op is differentiable: the intra-chunk step is a
``torch.autograd.Function`` whose forward is the wrapper and whose
backward is :func:`~repro_torch.kernels.ssd.kernel.ssd_intra_bwd`, on every
device, in an ``ssd_intra.bwd`` span; the rest of the scan is torch ops,
its chunk recurrence and inter-chunk output in an ``ssd.scan`` span.
"""
from __future__ import annotations

import torch

from repro_torch.core import trace
from repro_torch.kernels.ssd.kernel import ssd_intra, ssd_intra_bwd


class SSDIntra(torch.autograd.Function):
    """The intra-chunk step (the kernel, or the plain version for CPU
    tensors), with :func:`ssd_intra_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, cum, dt, B_, C_, bf16_intra):
        out = ssd_intra(x, cum, dt, B_, C_, bf16_intra=bf16_intra)
        ctx.bf16_intra = bf16_intra
        ctx.save_for_backward(x, cum, dt, B_, C_)
        return out

    @staticmethod
    def backward(ctx, dy, dstate, dcdecay):
        with trace.span("ssd_intra.bwd"):
            grads = ssd_intra_bwd(*ctx.saved_tensors, dy, dstate, dcdecay, bf16_intra=ctx.bf16_intra)
        return (*grads, None)


def ssd_intra_op(x, cum, dt, B_, C_, *, bf16_intra: bool = False):
    """:func:`~repro_torch.kernels.ssd.kernel.ssd_intra` with its gradient."""
    return SSDIntra.apply(x, cum, dt, B_, C_, bf16_intra)


def ssd_scan(x, dt, A, B_, C_, D, *, chunk: int, bf16_intra: bool, intra):
    """``_ssd_chunked`` with the intra-chunk step ``intra`` (the kernel's
    wrapper or its plain version): x [B,S,H,P], dt [B,S,H] (> 0), A [H]
    (< 0), B_/C_ [B,S,1,N], D [H] -> (y [B,S,H,P] in x's dtype,
    final_state [B,H,P,N] float32)."""
    Bz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if G != 1:
        raise ValueError(f"the SSD scan takes one B/C group, got G={G}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} must be a multiple of the chunk {chunk}")
    nc = S // chunk
    dtc = dt.reshape(Bz, nc, chunk, H)
    cum = torch.cumsum(dtc * A, dim=2)  # inclusive within-chunk log decay, float32
    y_intra, states, cdecay = intra(
        x.reshape(Bz * nc, chunk, H, P), cum.reshape(Bz * nc, chunk, H),
        dtc.reshape(Bz * nc, chunk, H), B_.reshape(Bz * nc, chunk, N),
        C_.reshape(Bz * nc, chunk, N), bf16_intra=bf16_intra,
    )
    states = states.reshape(Bz, nc, H, P, N)
    chunk_decay = cdecay.reshape(Bz, nc, H)

    with trace.span("ssd.scan"):
        # the state before each chunk: s_c = s_{c-1} * decay_c + states_c,
        # the recurrence the reference evaluates with an associative scan
        s = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
        s_prev = []
        for c in range(nc):
            s_prev.append(s)
            s = s * chunk_decay[:, c, :, None, None] + states[:, c]
        s_prev = torch.stack(s_prev, dim=1)  # [B, nc, H, P, N]

        Cc = C_.reshape(Bz, nc, chunk, N).float()
        y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, s_prev) * torch.exp(cum)[..., None]
    y = (y_intra.reshape(Bz, nc, chunk, H, P) + y_inter).reshape(Bz, S, H, P)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), s


def ssd_chunked(x, dt, A, B_, C_, D, *, chunk: int = 128, bf16_intra: bool = False):
    """x [B,S,H,P], dt [B,S,H] (> 0), A [H] (< 0), B_/C_ [B,S,G=1,N], D [H]
    -> (y [B,S,H,P], final_state [B,H,P,N]).  S must be a multiple of
    ``min(chunk, S)``.  On CUDA tensors the intra-chunk step launches the
    kernel :func:`~repro_torch.kernels.ssd.kernel.route` names (the
    tensor-core kernel for bfloat16 operands and for ``bf16_intra``)."""
    return ssd_scan(x, dt, A, B_, C_, D, chunk=chunk, bf16_intra=bf16_intra, intra=ssd_intra_op)
