"""Public op: flash attention through the Hopper kernel.

Port of ``repro/kernels/attention/ops.py::flash_attention``.  The TPU op
transposed q/k/v to the kernel's ``[B*H, S, D]`` layout; the CUDA kernels
read ``[B, S, H, D]`` through its strides, so the op only calls the
wrapper: on CUDA tensors it launches ``kernels/csrc/flash_attention_sm90.cu``
(bfloat16, D a multiple of 16 up to 128: tensor cores) or
``kernels/csrc/flash_attention.cu`` (float32 and other head dims: CUDA
cores), on CPU tensors the wrapper runs the plain version.  The model's attention
entry point (``models/layers.chunked_attention``) calls this op.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,KH,D] -> [B,Sq,H,D] in q's dtype."""
    return flash_attention_kernel(q, k, v, causal=causal)
