"""Mamba-2 SSD intra-chunk step: the Hopper kernels and their plain version.

Port of ``repro/kernels/ssd/kernel.py::ssd_intra_pallas``, with the numbers
of ``repro/models/mamba.py::_ssd_chunked`` (the function the serving path
runs).  For every chunk and head, with ``cum`` the within-chunk cumulative
log decay:

    M[i, j]  = tril(C_i . B_j * exp(cum_i - cum_j)) * dt_j
    y[i]     = sum_j M[i, j] x_j                          (float32)
    state    = sum_j x_j^T B_j exp(cum_last - cum_j) dt_j  (float32)
    cdecay   = exp(cum_last)

B and C belong to the one group (G = 1), so ``C B^T`` is per chunk.
:func:`ssd_intra` launches one of two CUDA kernels for CUDA tensors, by
dtype, shape and mode (:func:`route`), and takes the plain version,
:func:`ssd_intra_plain`, only for CPU tensors:

- ``"wgmma"``: bfloat16 x, B, C with P and N multiples of 16 up to 128 and
  any Q <= 128 run ``kernels/csrc/ssd_intra_sm90.cu`` on the tensor cores.
  x, B and C are exact in bfloat16; the float32 M and ``B * w`` go in as
  three bfloat16 parts whose sum is exact, so the route computes the
  default mode's float32 function (within 1e-4 of the plain version).  It
  also takes ``bf16_intra`` (then for float32 operands too, rounded to
  bfloat16 first, as the plain version rounds them), rounding where the
  plain version rounds.
- ``"cuda_cores"``: float32 operands, and bfloat16 shapes outside that set,
  run ``kernels/csrc/ssd_intra.cu`` in float32 on the CUDA cores.  It does
  not take ``bf16_intra``.

Every launch adds one to ``ssd_intra.launches`` and to its route's entry of
``ssd_intra.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import on_cuda
from repro_torch.kernels import _build

MAX_CHUNK = MAX_STATE = MAX_HEAD_DIM = 128
# heads that share one block's C B^T in the CUDA-core kernel
HEADS_PER_BLOCK = 8
# the tensor-core kernel's range: with N and P up to 64 two blocks of up to
# 10 heads' tables fit an SM's shared memory
WGMMA_HEADS_PER_BLOCK = range(4, 11)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# route -> (csrc source, C launcher, its ctypes argument types); the last
# int is bf16_intra for "wgmma" and the dtype code for "cuda_cores"
LAUNCHERS = {
    "wgmma": ("ssd_intra_sm90", "ssd_intra_sm90_launch", _ARGS),
    "cuda_cores": ("ssd_intra", "ssd_intra_launch", _ARGS),
}


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


def route(dtype: torch.dtype, Q: int, P: int, N: int, *, bf16_intra: bool = False) -> str:
    """The kernel a CUDA call with these operands launches: ``"wgmma"`` for
    bfloat16 x/B/C (any dtype of the two under ``bf16_intra``) with P and N
    multiples of 16 up to 128, else ``"cuda_cores"``.  Raises on what
    neither takes: another dtype, Q, P or N over 128, P not a multiple of 4,
    or ``bf16_intra`` at a shape the tensor-core kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"the SSD kernels take x, B_, C_ of one dtype, float32 or "
                        f"bfloat16; got {dtype}")
    if Q > MAX_CHUNK or N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"the SSD kernels take chunk, state and head_dim <= 128; "
                         f"got Q={Q}, N={N}, P={P}")
    if P % 16 == 0 and N % 16 == 0 and (dtype == torch.bfloat16 or bf16_intra):
        return "wgmma"
    if bf16_intra:
        raise ValueError(f"bf16_intra runs on the tensor-core SSD kernel, which takes P and "
                         f"N multiples of 16; got P={P}, N={N}")
    if P % 4:
        raise ValueError(f"the CUDA-core SSD kernel takes head_dim a multiple of 4, got P={P}")
    return "cuda_cores"


def heads_per_block(BC: int, H: int, P: int, N: int, sms: int) -> int:
    """Heads a block of the tensor-core kernel takes: the count in
    :data:`WGMMA_HEADS_PER_BLOCK` with the fewest waves times heads a block
    on ``sms`` SMs (a wave lasts as long as a full block; the largest count
    on a tie).  Blocks with N and P up to 64 run two an SM, larger ones
    one."""
    per_wave = sms * (2 if P <= 64 and N <= 64 else 1)

    def cost(hg):
        return -(-BC * -(-H // hg) // per_wave) * hg

    return min(WGMMA_HEADS_PER_BLOCK, key=lambda hg: (cost(hg), -hg))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launcher(path: str):
    source, symbol, argtypes = LAUNCHERS[path]
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(path: str, x, cum, dt, B_, C_, *, bf16_intra: bool = False):
    """Launch route ``path``'s kernel on contiguous CUDA operands it takes
    and return ``(y, state, cdecay)``; raises if the launch fails.  Counts
    nothing: :func:`ssd_intra` is the entry point, this is its last step
    (and how a comparison runs a route by name)."""
    BC, Q, H, P, N = check_operands(x, cum, dt, B_, C_)
    if not all(t.is_contiguous() for t in (x, cum, dt, B_, C_)):
        raise ValueError("the SSD kernels read contiguous operands (ssd_intra makes them so)")
    if path == "wgmma" and not (x.dtype == B_.dtype == C_.dtype == torch.bfloat16):
        raise TypeError(f"the tensor-core SSD kernel reads bfloat16 x, B_, C_; got {x.dtype}, "
                        f"{B_.dtype}, {C_.dtype}")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((BC, Q, H, P), **f32)
    state = torch.empty((BC, H, P, N), **f32)
    cdecay = torch.empty((BC, H, 1, 1), **f32)
    if BC == 0 or Q == 0 or H == 0:
        return y, state, cdecay
    if path == "wgmma":
        hg, last = heads_per_block(BC, H, P, N, _sms(x.device)), int(bf16_intra)
    else:
        hg, last = HEADS_PER_BLOCK, _DTYPES[x.dtype]
    err = _launcher(path)(
        x.data_ptr(), cum.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        y.data_ptr(), state.data_ptr(), cdecay.data_ptr(),
        BC, Q, H, P, N, hg, last,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"ssd_intra ({path})")
    return y, state, cdecay


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_intra(x, cum, dt, B_, C_, *, bf16_intra: bool = False):
    """The intra-chunk step: ``(y, state, cdecay)`` as
    :func:`ssd_intra_plain` gives them.

    On CUDA tensors: launches the kernel :func:`route` names on the current
    stream (x, B_ and C_ of one dtype, float32 or bfloat16; Q, N and P at
    most 128).  Under ``bf16_intra`` the operands are rounded to bfloat16
    first, as the plain version rounds them.  Raises on what neither kernel
    takes or if the launch fails; nothing falls back to the other kernel or
    the plain version.  On CPU tensors: :func:`ssd_intra_plain`.
    """
    BC, Q, H, P, N = check_operands(x, cum, dt, B_, C_)
    if not on_cuda(x):
        return ssd_intra_plain(x, cum, dt, B_, C_, bf16_intra=bf16_intra)
    if B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"the SSD kernels take x, B_, C_ of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {B_.dtype}, {C_.dtype}")
    path = route(x.dtype, Q, P, N, bf16_intra=bf16_intra)
    if path == "wgmma":
        x, B_, C_ = (_aligned(t.to(torch.bfloat16)) for t in (x, B_, C_))
    x, cum, dt, B_, C_ = (t.contiguous() for t in (x, cum, dt, B_, C_))
    out = launch(path, x, cum, dt, B_, C_, bf16_intra=bf16_intra)
    ssd_intra.launches += 1
    ssd_intra.launches_by_route[path] += 1
    return out


ssd_intra.launches = 0
ssd_intra.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
