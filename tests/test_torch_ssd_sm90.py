"""The tensor-core route of the SSD intra-chunk step (kernel #7), on the CPU.

``kernels/csrc/ssd_intra_sm90.cu`` runs only on the card (its tests are the
``cuda``-marked ones in ``tests/test_torch_cuda.py``).  What the CPU can
hold is held here: which kernel a call takes (dtype, Q, P, N and the
``bf16_intra`` mode), the C launchers' ctypes prototypes against the
sources' signatures (without loading a library), and the numerics.  x, B
and C are bfloat16 on that route, so every product with them is exact on
the bf16 tensor cores; the float32 values M and ``B * w`` go in as three
bfloat16 parts whose sum is exact.  A torch emulation of that arithmetic
(the parts as the kernel forms them, exact products, float32 sums) must
stay within the card's 1e-4 of the plain version and of the JAX Pallas
kernel (interpret mode), and two parts must not be enough.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as j_ssd_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import kernel as t_ssd

ATOL = 1e-4
BF16_INTRA_ATOL = 5e-2
bf16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Q", [1, 16, 65, 128])
@pytest.mark.parametrize("P,N", [(64, 64), (64, 128), (128, 128), (16, 16), (80, 48)])
def test_route_bf16_multiples_of_16_take_wgmma(Q, P, N):
    assert t_ssd.route(bf16, Q, P, N) == "wgmma"
    assert t_ssd.route(torch.float32, Q, P, N) == "cuda_cores"


@pytest.mark.parametrize("P,N", [(36, 64), (64, 24), (4, 8), (100, 128), (32, 1)])
def test_route_bf16_other_shapes_take_cuda_cores(P, N):
    assert t_ssd.route(bf16, 128, P, N) == "cuda_cores"


@pytest.mark.parametrize("dtype", [torch.float32, bf16])
def test_route_bf16_intra_takes_wgmma_for_both_dtypes(dtype):
    assert t_ssd.route(dtype, 128, 64, 64, bf16_intra=True) == "wgmma"
    assert t_ssd.route(dtype, 10, 32, 16, bf16_intra=True) == "wgmma"
    with pytest.raises(ValueError, match="bf16_intra"):
        t_ssd.route(dtype, 128, 36, 64, bf16_intra=True)


@pytest.mark.parametrize("Q,P,N", [(129, 64, 64), (128, 144, 64), (128, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, bf16])
def test_route_refuses_shapes_no_kernel_takes(dtype, Q, P, N):
    with pytest.raises(ValueError, match="<= 128"):
        t_ssd.route(dtype, Q, P, N)


def test_route_refuses_odd_head_dims_and_other_dtypes():
    with pytest.raises(ValueError, match="multiple of 4"):
        t_ssd.route(torch.float32, 128, 6, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_ssd.route(torch.float16, 128, 64, 64)


@pytest.mark.parametrize("bf16_intra", [False, True])
def test_cpu_tensors_take_the_plain_version_and_count_no_route(bf16_intra):
    ops = _operands(2, 16, 3, 32, 16, seed=1)
    before = (t_ssd.ssd_intra.launches, dict(t_ssd.ssd_intra.launches_by_route))
    got = t_ssd.ssd_intra(*ops, bf16_intra=bf16_intra)
    assert (t_ssd.ssd_intra.launches, t_ssd.ssd_intra.launches_by_route) == before
    for g, w in zip(got, t_ssd.ssd_intra_plain(*ops, bf16_intra=bf16_intra)):
        assert torch.equal(g, w)


def test_launch_refuses_operands_the_kernels_cannot_read():
    """A route run by name reads its operands as they lie: no strided view
    (the wrapper copies those), and bfloat16 for the tensor-core kernel."""
    x, cum, dt, B_, C_ = _operands(2, 16, 3, 32, 16, seed=2)
    wide = torch.cat([B_, C_], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        t_ssd.launch("cuda_cores", x, cum, dt, wide[..., :16], wide[..., 16:])
    with pytest.raises(TypeError, match="bfloat16"):
        t_ssd.launch("wgmma", x, cum, dt, B_, C_)


# ---------------------------------------------------------------------------
# the C launchers' prototypes, declared without loading a library
# ---------------------------------------------------------------------------
_CTYPE_OF = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}


def _c_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    types = []
    for param in m.group(1).split(","):
        words = param.split()
        base = " ".join(w.strip("*") for w in words[:-1] if w.strip("*"))
        types.append(_CTYPE_OF[base + ("*" if "*" in param else "")])
    return types


@pytest.mark.parametrize("path", ["wgmma", "cuda_cores"])
def test_launcher_prototype_matches_the_source(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    source, symbol, argtypes = t_ssd.LAUNCHERS[path]
    assert source in _build.sources()
    assert argtypes == _c_signature(source, symbol)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    assert argtypes[:8] == [ctypes.c_void_p] * 8 and argtypes[-1] is ctypes.c_void_p


def test_wgmma_source_uses_tensor_cores_and_takes_the_block_heads():
    text = (_build.CSRC / "ssd_intra_sm90.cu").read_text()
    assert '#include "sm90.cuh"' in text
    full = text + (_build.CSRC / "sm90.cuh").read_text()
    for needle in ("wgmma.mma_async", ".f32.bf16.bf16", "cp.async.bulk.tensor",
                   "const __grid_constant__ CUtensorMap"):
        assert needle in full, needle
    assert "#include <torch" not in full and "#include <cutlass" not in full
    max_heads = int(re.search(r"constexpr int kMaxHeads = (\d+);", text).group(1))
    assert 1 <= min(t_ssd.WGMMA_HEADS_PER_BLOCK) and max(t_ssd.WGMMA_HEADS_PER_BLOCK) <= max_heads


@pytest.mark.parametrize("BC,H,P,N,want", [
    (64, 80, 64, 64, 10),  # zamba2-2.7b's prefill: 512 blocks, two waves of two an SM
    (64, 64, 64, 128, 8),  # mamba2-1.3b's: 512 blocks, four waves of one an SM
    (3, 13, 64, 64, 4),  # a few blocks: as many as the heads allow
])
def test_heads_per_block_fills_the_waves(BC, H, P, N, want):
    assert t_ssd.heads_per_block(BC, H, P, N, sms=132) == want


# ---------------------------------------------------------------------------
# the split: three bfloat16 parts hold a float32 exactly
# ---------------------------------------------------------------------------
def split(v: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """``parts`` bfloat16 values (as float32) of float32 ``v``, as the kernel
    forms them: part k = bf16 of what parts 0..k-1 left."""
    out, rest = [], v
    for _ in range(parts):
        p = rest.to(bf16).float()
        out.append(p)
        rest = rest - p
    return out


def _floats(exp_lo, exp_hi, n, seed):
    """float32 values of random sign and significand with binary exponents
    in [exp_lo, exp_hi] (normal numbers)."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(exp_lo + 127, exp_hi + 128, size=n, dtype=np.uint32) << 23) \
        | rng.integers(0, 1 << 23, size=n, dtype=np.uint32) \
        | (rng.integers(0, 2, size=n, dtype=np.uint32) << 31)
    return torch.from_numpy(bits.view(np.float32).copy())


def test_three_parts_are_exact_for_float32():
    # M spans ~1e-30 (long decays) to ~1e2, B * w likewise; cover 2^-110 .. 2^100
    v = _floats(-110, 100, 200_000, 0)
    hi, mid, lo = split(v, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    assert torch.equal((hi + mid) + lo, v)  # the float32 sum too
    two = split(v, 2)
    assert not torch.equal(two[0].double() + two[1].double(), v.double())


def test_three_parts_below_2_pow_minus_110_lose_under_2_pow_minus_133():
    v = torch.cat([_floats(-126, -111, 50_000, 1),
                   torch.from_numpy(np.random.default_rng(2).integers(
                       1, 1 << 23, size=10_000, dtype=np.uint32).view(np.float32).copy())])  # subnormals
    err = (sum(p.double() for p in split(v, 3)) - v.double()).abs().max()
    assert float(err) <= 2.0 ** -133


def test_two_parts_are_exact_for_a_product_of_two_bfloat16_values():
    # B (|B| up to ~2^3) times w (down to ~2^-100 over a long chunk): the
    # products stay above 2^-110, where the second part is a normal float
    a = _floats(-40, 40, 100_000, 3).to(bf16).float()
    b = _floats(-60, 20, 100_000, 4).to(bf16).float()
    v = a * b  # 16 significand bits: exact in float32
    assert torch.equal(v.double(), a.double() * b.double())
    hi, lo = split(v, 2)
    assert torch.equal(hi.double() + lo.double(), v.double())


# ---------------------------------------------------------------------------
# the arithmetic of the wgmma route
# ---------------------------------------------------------------------------
def wgmma_numerics(x, cum, dt, B_, C_, *, bf16_intra=False, parts=None):
    """Test-only emulation of ``ssd_intra_sm90.cu``: x, B, C rounded to
    bfloat16; S = C B^T with exact products and float32 sums; M formed as
    ``(s * exp(cum_i - cum_j)) * dt_j`` (under ``bf16_intra`` rounded to
    bfloat16 where the plain version rounds) and ``B * w``, each split into
    ``parts`` bfloat16 parts (3 and 3 by default, 1 and 2 under
    ``bf16_intra``), every part one float32-summed product with x."""
    BC, Q, H, P = x.shape
    xf, Bf, Cf = (t.to(bf16).float() for t in (x, B_, C_))
    r = lambda t: t.to(bf16).float()  # noqa: E731
    S = torch.einsum("cin,cjn->cij", Cf, Bf)
    cum_h, dt_h = cum.transpose(1, 2), dt.transpose(1, 2)  # [BC, H, Q]
    decay = torch.exp(cum_h[..., :, None] - cum_h[..., None, :])
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    if bf16_intra:
        M = r(r(r(S)[:, None] * r(decay)) * r(dt_h)[..., None, :])
    else:
        M = (S[:, None] * decay) * dt_h[..., None, :]
    M = torch.where(tri, M, torch.zeros(()))
    w = torch.exp(cum[:, -1:, :] - cum) * dt  # [BC, Q, H]
    if bf16_intra:
        w = r(w)
    A = Bf[:, :, None, :] * w[..., None]  # [BC, Q, H, N]
    pm, pw = parts or ((1, 2) if bf16_intra else (3, 3))
    y = sum(torch.einsum("chij,cjhp->cihp", m, xf) for m in split(M, pm))
    state = sum(torch.einsum("cjhn,cjhp->chpn", a, xf) for a in split(A, pw))
    return y, state, torch.exp(cum[:, -1, :])[..., None, None]


def _operands(BC, Q, H, P, N, seed, *, x_scale=1.0):
    """The smoke's operand ranges: dt in U(1e-3, 1e-1), A = -U(1, 16),
    x, B, C standard normal (bfloat16-valued), as float32 numpy arrays
    turned into tensors."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 1e-1, size=(BC, Q, H)).astype(np.float32)
    cum = np.cumsum(dt * -rng.uniform(1.0, 16.0, size=H).astype(np.float32), axis=1)
    x, B_, C_ = (rng.normal(size=s).astype(np.float32) for s in ((BC, Q, H, P), (BC, Q, N), (BC, Q, N)))
    x = x * np.float32(x_scale)
    t = [torch.from_numpy(a) for a in (x, cum, dt, B_, C_)]
    for i in (0, 3, 4):
        t[i] = t[i].to(bf16).float()
    return t


def _errs(got, want):
    return [float((g - w).abs().max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("BC,Q,H,P,N", [
    (8, 128, 16, 64, 64), (8, 128, 16, 64, 128),  # chip_smoke.py's operands
    (2, 128, 80, 64, 64),  # zamba2-2.7b: 80 heads of 64, N 64
    (2, 128, 16, 64, 128),  # mamba2-1.3b: heads of 64, N 128
    (3, 65, 9, 128, 64), (3, 1, 9, 64, 64), (2, 16, 3, 80, 48),  # edges
])
def test_wgmma_numerics_within_1e4_of_the_plain_version(BC, Q, H, P, N):
    ops = _operands(BC, Q, H, P, N, BC + Q + H + P + N)
    errs = _errs(wgmma_numerics(*ops), t_ssd.ssd_intra_plain(*ops))
    assert max(errs) <= ATOL, errs


@pytest.mark.parametrize("BC,Q,H,P,N", [(2, 128, 4, 64, 64), (2, 128, 2, 64, 128)])
def test_wgmma_numerics_match_the_pallas_kernel(BC, Q, H, P, N):
    ops = _operands(BC, Q, H, P, N, 11 + N)
    want = j_ssd_kernel.ssd_intra_pallas(*(jnp.asarray(t.numpy()) for t in ops), interpret=True)
    want = [torch.from_numpy(np.array(w)) for w in want]
    errs = _errs(wgmma_numerics(*ops), want)
    assert max(errs) <= ATOL, errs


def test_two_parts_fall_outside_1e4_where_three_pass():
    """x scaled by 8 (|y| up to ~90): the second part's residue (2^-16 of
    M) shows in y, the third part's does not.  This is why the kernel uses
    three parts."""
    ops = _operands(4, 128, 16, 64, 64, 5, x_scale=8.0)
    plain = t_ssd.ssd_intra_plain(*ops)
    three = _errs(wgmma_numerics(*ops), plain)
    two = _errs(wgmma_numerics(*ops, parts=(2, 2)), plain)
    assert max(three) <= ATOL, three
    assert max(two) > ATOL, two


@pytest.mark.parametrize("BC,Q,H,P,N", [(4, 128, 8, 64, 64), (2, 65, 3, 32, 128)])
def test_wgmma_numerics_bf16_intra_within_5e2_of_the_plain_version(BC, Q, H, P, N):
    ops = _operands(BC, Q, H, P, N, 3 * Q + N)
    errs = _errs(wgmma_numerics(*ops, bf16_intra=True), t_ssd.ssd_intra_plain(*ops, bf16_intra=True))
    assert max(errs) <= BF16_INTRA_ATOL, errs
