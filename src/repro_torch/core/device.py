"""Device probing for the PyTorch port.

The port runs on a CUDA card unless the caller names another device.  Entry
points resolve their ``device`` argument through :func:`resolve_device`:
``None`` means the card, and asking for the card on a machine without one
raises instead of quietly running on the CPU.  Kernel wrappers decide on
the tensor they are given (:func:`on_cuda`), never on a global setting.
"""
from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """The card (``cuda``); raises when PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port's plain PyTorch code on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``
    (a bare ``"cuda"`` gets the current device's index, so it compares equal
    to the device of the tensors placed there)."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is unavailable")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (kernel wrappers key off this)."""
    return t.is_cuda


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def synchronize(t: torch.Tensor) -> None:
    """Wait for the device work producing ``t`` (a phase boundary).

    The counterpart of ``block_until_ready`` in the JAX stages: phase timers
    must not stop while the card is still running the phase's kernels.
    """
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
