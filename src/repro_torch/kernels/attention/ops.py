"""Public op: flash attention through the Hopper kernels, forward and
backward.

Port of ``repro/kernels/attention/ops.py::flash_attention``.  The TPU op
transposed q/k/v to the kernel's ``[B*H, S, D]`` layout; the CUDA kernels
read ``[B, S, H, D]`` through its strides, so the op only calls the
wrapper: on CUDA tensors it launches ``kernels/csrc/flash_attention_sm90.cu``
(bfloat16, D a multiple of 16 up to 256: tensor cores) or
``kernels/csrc/flash_attention.cu`` (float32 and other head dims: CUDA
cores), on CPU tensors the wrapper runs the plain version.  The model's attention
entry point (``models/layers.chunked_attention``) calls this op.

The op is differentiable: a ``torch.autograd.Function`` whose backward is
:func:`~repro_torch.kernels.attention.kernel.flash_attention_backward`, in a
``flash_attention.bwd`` span: where the forward runs ``"wgmma"`` the
hand-written bf16 kernels of ``kernels/csrc/flash_attention_bwd_sm90.cu``,
which read the logsumexp the forward saved; elsewhere (float32, other head
dims, CPU tensors) ``flash_attention_bwd``, torch ops on the inputs and the
saved output.
"""
from __future__ import annotations

import torch

from repro_torch.core import trace
from repro_torch.core.device import on_cuda
from repro_torch.kernels.attention.kernel import (bwd_route, flash_attention_backward,
                                                  flash_attention_kernel)


class FlashAttention(torch.autograd.Function):
    """The forward kernel (the plain version for CPU tensors), with
    :func:`flash_attention_backward` as its backward.  A forward whose
    inputs need a gradient on the ``"wgmma"`` backward route also saves the
    rows' logsumexp (so non-reentrant checkpointing drops and recomputes it
    with the rest); every other forward launches the serving path's kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        lse = None
        if any(ctx.needs_input_grad[:3]) and bwd_route(q.dtype, q.shape[-1], on_cuda(q)) == "wgmma":
            out, lse = flash_attention_kernel(q, k, v, causal=causal, with_lse=True)
        else:
            out = flash_attention_kernel(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with trace.span("flash_attention.bwd"):
            return (*flash_attention_backward(q, k, v, out, dout, lse, causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype."""
    return FlashAttention.apply(q, k, v, causal)
