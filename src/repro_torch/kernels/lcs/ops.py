"""Dispatch wrapper for the batched LCS kernel.

``mode`` selects the dispatch policy:

  "auto"       on a CUDA tensor, always the Hopper kernel; on a CPU tensor,
               the wavefront for batches under ``block_b`` rows, else the
               kernel wrapper (whose CPU path is its plain version) — the
               production default.
  "pallas"     always the kernel wrapper (the kernel on a CUDA tensor).
  "interpret"  the plain version, on either device (the name of the JAX
               package's interpreted kernel body).
  "wavefront"  always the plain anti-diagonal wavefront.

``block_b`` is a cap on the threads per CUDA block of the kernel's shared
route (rows wider than 32), not the block itself: :func:`_block_for` picks
the power of two at or under it that leaves the fewest idle threads in the
ragged last block.  The register route (rows up to 32) always runs 128
rows a block.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import on_cuda
from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B
from repro_torch.core.similarity import (
    gather_windows, lcs_wavefront, repad, wavefront_dtype_from_env,
)
from repro_torch.core.subtraj import slice_lengths
from repro_torch.kernels.lcs.kernel import lcs_kernel

_MODES = ("auto", "pallas", "interpret", "wavefront")

# smallest block worth launching: below this, per-block overhead dominates
# the idle threads a smaller block would save
_BLOCK_FLOOR = 128


def _block_for(batch: int, block_b: int, *, floor: int = _BLOCK_FLOOR) -> int:
    """Power-of-two block <= block_b minimizing padded rows, over a floor.

    Every candidate power of two in [min(floor, block_b), block_b] is scored
    by its padded batch size ``ceil(B / b) * b``; the smallest padding wins,
    and ties go to the LARGER block (fewer blocks for the same rows).
    """
    cap = max(1, block_b)
    lo = min(floor, cap)
    best_b, best_padded = None, None
    b = 1
    while b <= cap:
        if b >= lo:
            padded = -(-batch // b) * b  # ceil(batch / b) * b
            if best_padded is None or padded <= best_padded:
                best_b, best_padded = b, padded
        b *= 2
    return best_b


def lcs(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_b: int = 512,
    mode: str = "auto",
    wavefront_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Batched LCS: int32 [B, L] x2 -> int32 [B].

    Inputs must be sentinel-padded (side A: -1, side B: -2) as produced by
    ``repro_torch.core.similarity.repad``.  ``wavefront_dtype=None`` reads
    the REPRO_LCS_DTYPE probe here, at the call boundary.
    """
    if mode not in _MODES:
        raise ValueError(
            f"unknown lcs dispatch mode {mode!r}; valid: {list(_MODES)}"
        )
    B, L = a.shape
    if b.shape != (B, L):
        raise ValueError(f"lcs operands differ in shape: {tuple(a.shape)} vs {tuple(b.shape)}")
    plain = mode in ("wavefront", "interpret") or (
        mode == "auto" and not on_cuda(a) and B < block_b
    )
    if plain:
        if wavefront_dtype is None:
            wavefront_dtype = wavefront_dtype_from_env()
        return lcs_wavefront(a, b, dtype=wavefront_dtype)
    return lcs_kernel(a, b, block_b=_block_for(B, block_b))


def lcs_windowed(
    a: torch.Tensor,
    b: torch.Tensor,
    off_a: torch.Tensor,
    off_b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    *,
    window: int,
    block_b: int = 512,
    mode: str = "auto",
    wavefront_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Subtrajectory LCS: full rows + per-row window coordinates -> [B].

    a/b int32 [B, L] code rows with the table's native padding (no repad
    needed), off_a/off_b [B] window start offsets, len_a/len_b [B] the
    rows' TRUE lengths.  Each row is sliced to its
    ``[off, off + clip(len - off, 0, window))`` window, sentinel-repadded to
    width ``min(window, L)``, and dispatched through :func:`lcs` (with the
    same ``block_b``/``mode``) — so the batched kernel runs over width-W
    rows instead of the full rows.
    """
    W = min(window, a.shape[1])

    def slice_side(x, off, length, pad_code):
        win = gather_windows(x[:, None], off, W)[:, 0]
        return repad(win, slice_lengths(length, off, W), pad_code)

    return lcs(
        slice_side(a, off_a, len_a, PAD_CODE_A),
        slice_side(b, off_b, len_b, PAD_CODE_B),
        block_b=block_b, mode=mode, wavefront_dtype=wavefront_dtype,
    )
