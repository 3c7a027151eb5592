"""Public op: flash attention through the Hopper kernel.

Port of ``repro/kernels/attention/ops.py::flash_attention``.  The TPU op
transposed q/k/v to the kernel's ``[B*H, S, D]`` layout; the CUDA kernels
read ``[B, S, H, D]`` through its strides, so the op only calls the
wrapper: on CUDA tensors it launches ``kernels/csrc/flash_attention_sm90.cu``
(bfloat16, D a multiple of 16 up to 256: tensor cores) or
``kernels/csrc/flash_attention.cu`` (float32 and other head dims: CUDA
cores), on CPU tensors the wrapper runs the plain version.  The model's attention
entry point (``models/layers.chunked_attention``) calls this op.

The op is differentiable: a ``torch.autograd.Function`` whose forward is
the wrapper and whose backward is :func:`~repro_torch.kernels.attention.
kernel.flash_attention_bwd` (torch ops on the inputs and the saved
output), on every device, so the CPU runs the backward the card runs.
Each backward adds one to ``flash_attention_kernel.backward_calls``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_bwd, flash_attention_kernel


class FlashAttention(torch.autograd.Function):
    """The forward kernel (the plain version for CPU tensors), with
    :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = flash_attention_kernel(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        flash_attention_kernel.backward_calls += 1
        return (*flash_attention_bwd(q, k, v, out, dout, causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype."""
    return FlashAttention.apply(q, k, v, causal)
