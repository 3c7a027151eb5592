"""The tensor-core route of flash attention (kernel #6), on the CPU.

``kernels/csrc/flash_attention_sm90.cu`` runs only on the card (its tests are
the ``cuda``-marked ones in ``tests/test_torch_cuda.py``).  What the CPU can
hold is held here: which kernel a call takes (dtype and head dim), the C
launchers' ctypes prototypes against the sources' signatures (without
loading a library), which operand views TMA reads in place, and the
tolerance budget of the new numerics.  The wgmma route rounds ``p`` to
bfloat16 before ``p @ v``, as the Pallas body does, while
``flash_attention_plain`` keeps ``p`` in float32 as ``chunked_attention``
does; a torch emulation of the kernel's arithmetic (key tiles of
``key_tile(D)`` keys, ``l`` from the float32 ``p``) must stay within the
card's 3e-2 bfloat16 bar of the plain version at the smoke run's edge
shapes, at a granite-like layer and at an MLA-like one (D 192, v zero past
column 128), and match the JAX Pallas kernel (interpret mode, blocks of the
kernel's key tile), which rounds ``p`` the same way.

The backward (``kernels/csrc/flash_attention_bwd_sm90.cu``) is held the same
way: its route rule (the forward's ``"wgmma"`` calls, else torch ops), its
launcher's prototype, its tile table's shared memory, the forward saving
the logsumexp only where that backward reads it, and a torch emulation of
its arithmetic (p and ds rounded to bfloat16 as product operands) within
the card's 3e-2 relative-L2 bar of the float32 gradient.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as j_attn_ops
from repro_torch.kernels import _build
from repro_torch.kernels.attention import kernel as t_attn
from repro_torch.kernels.attention import ops as t_attn_ops

BF16_ATOL = 3e-2


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256])
def test_route_bf16_head_dims_take_wgmma(D):
    assert t_attn.route(torch.bfloat16, D) == "wgmma"


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 80),
                                     (torch.float32, 128), (torch.float32, 256),
                                     (torch.bfloat16, 72), (torch.bfloat16, 136),
                                     (torch.bfloat16, 200)])
def test_route_other_cases_take_cuda_cores(dtype, D):
    assert t_attn.route(dtype, D) == "cuda_cores"


def _tile_table():
    """``flash_attention_sm90.cu``'s Tile table: {chunks: (keys, stages)}
    (the primary template for the chunk counts it does not specialise)."""
    text = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    primary = re.search(r"struct Tile \{\s*static constexpr int BK = (\d+), NS = NC == 1 \? (\d+) : (\d+);",
                        text)
    assert primary, "the Tile table's primary template not found"
    table = {1: (int(primary.group(1)), int(primary.group(2))),
             2: (int(primary.group(1)), int(primary.group(3)))}
    for nc, bk, ns in re.findall(r"struct Tile<(\d+)> \{\s*static constexpr int BK = (\d+), NS = (\d+);",
                                 text):
        table[int(nc)] = (int(bk), int(ns))
    return table


def test_key_tile_is_the_kernels_tile_table():
    """The CPU emulation reads ``key_tile``; the card runs the Tile table."""
    table = _tile_table()
    assert sorted(table) == [1, 2, 3, 4]
    for D in range(16, 257, 16):
        assert t_attn.key_tile(D) == table[-(-D // 64)][0], D


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_tile_table_fits_the_shared_memory_and_the_wgmma_shapes(nc):
    """Each tile's shared memory (1 KB of alignment, the 128-row q tile and
    NS stages of k and v, 128-byte rows of 64 columns) within the 232,448
    bytes a block may use, less the kernel's static barriers; a key tile the
    m64nNk16 of q . k and the 16-key steps of p . v take."""
    bk, ns = _tile_table()[nc]
    smem = 1024 + nc * 128 * 128 + ns * 2 * nc * bk * 128
    assert smem + 8 * (ns + 1) + 4 * ns <= 232_448, smem
    assert bk % 16 == 0 and 16 <= bk <= 256 and ns >= 2


@pytest.mark.parametrize("D", [264, 512, 84, 100, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_refuses_head_dims_no_kernel_takes(dtype, D):
    with pytest.raises(ValueError, match="head_dim"):
        t_attn.route(dtype, D)


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_attn.route(torch.float16, 64)


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, 9, 4, 80), (1, 9, 2, 80), (1, 9, 2, 80)))
    fk = t_attn.flash_attention_kernel
    before = (fk.launches, dict(fk.launches_by_route), fk.copies)
    got = fk(q, k, v)
    assert (fk.launches, fk.launches_by_route, fk.copies) == before
    assert torch.equal(got, t_attn.flash_attention_plain(q, k, v))


# ---------------------------------------------------------------------------
# the C launchers' prototypes, declared without loading a library
# ---------------------------------------------------------------------------
_CTYPE_OF = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_signature(source, symbol):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', text, re.S)
    assert m, f"{symbol} not found in {source}.cu"
    types = []
    for param in m.group(1).split(","):
        words = param.split()
        ptr = "*" in param
        base = " ".join(w.strip("*") for w in words[:-1] if w.strip("*"))
        types.append(_CTYPE_OF[base + ("*" if ptr else "")])
    return types


@pytest.mark.parametrize("path", ["wgmma", "cuda_cores"])
def test_launcher_prototype_matches_the_source(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    source, symbol, argtypes = t_attn.LAUNCHERS[path]
    assert source in _build.sources()
    assert argtypes == _c_signature(source, symbol)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    assert argtypes[:4] == [ctypes.c_void_p] * 4 and argtypes[-1] is ctypes.c_void_p


def test_backward_launcher_prototype_matches_the_source(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    source, symbol, argtypes = t_attn.LAUNCHERS["bwd"]
    assert source in _build.sources()
    assert argtypes == _c_signature(source, symbol)
    assert argtypes[:10] == [ctypes.c_void_p] * 10 and argtypes[-1] is ctypes.c_void_p


def _with_headers(source):
    """The text of ``csrc/<source>.cu`` and of the ``csrc`` headers it includes."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    for name in re.findall(r'#include "(\w+\.cuh)"', text):
        text += (_build.CSRC / name).read_text()
    return text


def test_wgmma_source_uses_tensor_cores_and_tma():
    text = _with_headers("flash_attention_sm90")
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "const __grid_constant__ CUtensorMap", "cudaGetDriverEntryPoint"):
        assert needle in text, needle
    assert "#include <torch" not in text and "#include <cutlass" not in text
    assert "-lcuda" not in _build.NVCC_FLAGS


def test_backward_source_uses_tensor_cores_and_tma_under_backward_names():
    """The backward runs on the tensor cores from TMA-fed tiles, and no
    kernel of it is named like the forward (the benchmark files a kernel
    whose name holds ``flash_fwd`` as forward attention work)."""
    text = _with_headers("flash_attention_bwd_sm90")
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "const __grid_constant__ CUtensorMap"):
        assert needle in text, needle
    assert "#include <torch" not in text and "#include <cutlass" not in text
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    assert sorted(names) == ["flash_bwd_delta_kernel", "flash_bwd_dkdv_sm90_kernel", "flash_bwd_dq_sm90_kernel"]
    assert not any("flash_fwd" in n for n in names)


# ---------------------------------------------------------------------------
# which views TMA reads in place
# ---------------------------------------------------------------------------
def test_tma_ready_views():
    B, S, H, KH, D = 2, 130, 8, 2, 80
    qkv = torch.zeros(B, S, (H + 2 * KH) * D, dtype=torch.bfloat16)
    q, k, v = torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    views = q.view(B, S, H, D), k.view(B, S, KH, D), v.view(B, S, KH, D)
    assert not views[0].is_contiguous()
    assert all(t_attn.tma_ready(t) for t in views)  # the fused-qkv layout: no copy
    assert t_attn.tma_ready(torch.zeros(B, S, H, D, dtype=torch.bfloat16))


def test_tma_ready_refuses_misaligned_views():
    # a storage offset of one element: the address is not 16-byte aligned
    shifted = torch.zeros(2 * 40 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 40, 4, 64)
    assert not t_attn.tma_ready(shifted)
    # head stride of 68 elements (136 bytes) is not a multiple of 16 bytes
    odd = torch.zeros(2, 40, 4 * 68, dtype=torch.bfloat16).view(2, 40, 4, 68)[..., :64]
    assert not t_attn.tma_ready(odd)
    assert not t_attn.tma_ready(torch.zeros(2, 40, 64, 4, dtype=torch.bfloat16).transpose(2, 3))
    # a dim of length 1 may have any stride
    one = torch.zeros(1, 40, 1, 64, dtype=torch.bfloat16).as_strided((1, 40, 1, 64), (3, 64, 5, 1))
    assert t_attn.tma_ready(one)


# ---------------------------------------------------------------------------
# the tolerance budget of the wgmma route's numerics
# ---------------------------------------------------------------------------
def wgmma_numerics(q, k, v, *, causal=True, block_k=None):
    """Test-only emulation of ``flash_attention_sm90.cu``'s arithmetic: q . k
    of bfloat16 operands in float32, the -1e30 causal fill, keys past Skv at
    probability 0, an online softmax over tiles of ``block_k`` keys (the
    kernel's ``key_tile(D)`` unless given) with ``l`` summed
    from the float32 ``p``, ``p`` rounded to bfloat16 before ``p @ v`` (float32
    accumulation), out = acc / max(l, 1e-30) rounded once to bfloat16."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    block_k = block_k or t_attn.key_tile(D)
    rep = H // KH
    qf = q.float().reshape(B, Sq, KH, rep, D)
    kf = k.float()
    vr = v.float()  # bfloat16 values, exact in float32
    scale = float(np.float32(1.0 / math.sqrt(D)))
    m = torch.full((B, KH, rep, Sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, KH, rep, Sq, D)
    q_pos = torch.arange(Sq)
    for k0 in range(0, Skv, block_k):
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf[:, k0:k0 + block_k]) * scale
        if causal:
            k_pos = torch.arange(k0, min(Skv, k0 + block_k))
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pb = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", pb, vr[:, k0:k0 + block_k])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(torch.bfloat16)


def _bf16_operands(B, Sq, Skv, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
            for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D))]


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("S", [1, 65, 1000])
@pytest.mark.parametrize("D", [64, 80, 128, 192, 256])
@pytest.mark.parametrize("rep", [1, 4])
def test_wgmma_numerics_within_budget_at_edge_shapes(S, D, rep):
    """chip_smoke.py's edge shapes (B 2, KH 2), causal and not."""
    q, k, v = _bf16_operands(2, S, S, 2 * rep, 2, D, S + D + rep)
    for causal in (True, False):
        err = _err(wgmma_numerics(q, k, v, causal=causal),
                   t_attn.flash_attention_plain(q, k, v, causal=causal))
        assert err <= BF16_ATOL, f"causal={causal}: {err}"


@pytest.mark.parametrize("Sq,Skv", [(65, 1000), (1000, 65), (129, 127)])
def test_wgmma_numerics_within_budget_ragged(Sq, Skv):
    q, k, v = _bf16_operands(1, Sq, Skv, 8, 2, 80, Sq * Skv)
    for causal in (True, False):
        err = _err(wgmma_numerics(q, k, v, causal=causal),
                   t_attn.flash_attention_plain(q, k, v, causal=causal))
        assert err <= BF16_ATOL, f"causal={causal}: {err}"


def test_wgmma_numerics_within_budget_at_a_granite_like_layer():
    """S 2,048 (16 key tiles), D 128, GQA rep 4, causal: the longest online
    softmax of the serving path's cells."""
    q, k, v = _bf16_operands(1, 2048, 2048, 8, 2, 128, 5)
    err = _err(wgmma_numerics(q, k, v), t_attn.flash_attention_plain(q, k, v))
    assert err <= BF16_ATOL, err


def test_wgmma_numerics_within_budget_at_an_mla_like_layer():
    """deepseek-v2's MLA at the prefill's length: S 2,048 (32 key tiles of
    64 at D 192), q/k head dim 192 (128 + 64 rope), v zero past column 128
    (``v_pad``), causal, no GQA."""
    q, k, v = _bf16_operands(1, 2048, 2048, 4, 4, 192, 6)
    v[..., 128:] = 0
    got = wgmma_numerics(q, k, v)
    want = t_attn.flash_attention_plain(q, k, v)
    assert float(got[..., 128:].float().abs().max()) == 0.0
    assert _err(got, want) <= BF16_ATOL, _err(got, want)


@pytest.mark.parametrize("B,S,H,KH,D", [(2, 256, 4, 4, 80), (1, 256, 8, 2, 128), (1, 256, 4, 4, 192)])
def test_wgmma_numerics_match_the_pallas_kernel(B, S, H, KH, D):
    """The Pallas body rounds p to v's dtype too: the emulation and the JAX
    kernel (interpret mode, blocks of the kernel's key tile) compute the
    same formula."""
    q, k, v = _bf16_operands(B, S, S, H, KH, D, D + H)
    as_jax = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    blk = t_attn.key_tile(D)
    assert S % blk == 0
    pallas = j_attn_ops.flash_attention(*as_jax, causal=True, blk_q=128, blk_k=blk)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32)))
    assert _err(wgmma_numerics(q, k, v), pallas) <= BF16_ATOL


# ---------------------------------------------------------------------------
# the backward: its route, its tiles, the saved logsumexp, its numerics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 80, 128, 160, 192, 256])
def test_backward_route_bf16_head_dims_take_wgmma(D):
    assert t_attn.bwd_route(torch.bfloat16, D) == "wgmma"


@pytest.mark.parametrize("dtype,D,cuda", [(torch.float32, 64, True), (torch.float32, 160, True),
                                          (torch.bfloat16, 72, True), (torch.bfloat16, 136, True),
                                          (torch.bfloat16, 160, False), (torch.float32, 72, False),
                                          (torch.bfloat16, 12, False)])
def test_backward_route_other_cases_take_torch_ops(dtype, D, cuda):
    """float32, head dims the forward's wgmma route does not take, and CPU
    tensors (any head dim the plain version takes)."""
    assert t_attn.bwd_route(dtype, D, cuda) == "torch_ops"


def _dq_tile_table():
    """``flash_attention_bwd_sm90.cu``'s DqTile table: {chunks: keys}."""
    text = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    primary = re.search(r"struct DqTile \{\s*static constexpr int BK = (\d+);", text)
    assert primary, "the DqTile table's primary template not found"
    table = {nc: int(primary.group(1)) for nc in (1, 2, 3, 4)}
    for nc, bk in re.findall(r"struct DqTile<(\d+)> \{\s*static constexpr int BK = (\d+);", text):
        table[int(nc)] = int(bk)
    return table


def _bwd_constant(name):
    text = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_backward_tiles_fit_the_shared_memory_and_the_wgmma_shapes(nc):
    """Both kernels' shared memory within the 232,448 bytes a block may use
    (less their static barriers): dK/dV holds k, v, kNS stages of q and
    dout (64-row tiles) and the P^T and dS^T tiles; dQ holds the 128-row q
    and dout tiles and kNS stages of k and v.  The key tiles are what the
    m64nNk16 shapes take, and the dK/dV step splits into two 32-query
    halves."""
    ns, keys, step, bq = (_bwd_constant(n) for n in ("kNS", "kKeys", "kQStep", "kBQ"))
    bk = _dq_tile_table()[nc]
    dkdv = 1024 + 2 * nc * keys * 128 + ns * 2 * nc * step * 128 + 2 * keys * 128
    dq = 1024 + 2 * nc * bq * 128 + ns * 2 * nc * bk * 128
    assert dkdv + 8 * (ns + 1) <= 232_448, dkdv
    assert dq + 8 * (ns + 1) + 4 * ns <= 232_448, dq
    assert keys == step == 64 and bq == 128 and bk in (32, 64) and ns >= 2


def _bf16_grad_operands(B, S, H, KH, D, seed):
    q, k, v = _bf16_operands(B, S, S, H, KH, D, seed)
    dout = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(B, S, H, D)).astype(np.float32))
    return q, k, v, dout


def test_cpu_backward_takes_torch_ops_once_and_saves_no_logsumexp(monkeypatch):
    """On CPU tensors the op's forward never asks for the logsumexp and its
    backward calls ``flash_attention_bwd`` once, counted on ``"torch_ops"``."""
    seen = {"with_lse": [], "bwd": 0}
    real_fwd, real_bwd = t_attn.flash_attention_kernel, t_attn.flash_attention_bwd

    def fwd(*a, with_lse=False, **kw):
        seen["with_lse"].append(with_lse)
        return real_fwd(*a, with_lse=with_lse, **kw)

    def bwd(*a, **kw):
        seen["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(t_attn_ops, "flash_attention_kernel", fwd)
    monkeypatch.setattr(t_attn, "flash_attention_bwd", bwd)
    monkeypatch.setattr(t_attn.flash_attention_backward, "launches_by_route", {"wgmma": 0, "torch_ops": 0})
    q, k, v, dout = _bf16_grad_operands(1, 40, 4, 2, 80, 3)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    out = t_attn_ops.flash_attention(*args, causal=True)
    assert out.grad_fn.saved_tensors[4] is None
    torch.autograd.grad(out, args, dout.to(out.dtype))
    assert seen == {"with_lse": [False], "bwd": 1}
    assert t_attn.flash_attention_backward.launches_by_route == {"wgmma": 0, "torch_ops": 1}


@pytest.mark.parametrize("Sq,Skv", [(0, 16), (16, 0)])
def test_empty_wgmma_backward_launches_and_counts_nothing(Sq, Skv, monkeypatch):
    """A call on the ``"wgmma"`` route with no queries or no keys returns
    zero gradients without a launch and, as the forward, counts nothing."""
    def refuse(*a, **kw):
        raise AssertionError("launched an empty backward")

    monkeypatch.setattr(t_attn, "on_cuda", lambda t: True)
    monkeypatch.setattr(t_attn, "launch_bwd", refuse)
    monkeypatch.setattr(t_attn.flash_attention_backward, "launches_by_route", {"wgmma": 0, "torch_ops": 0})
    q, k, v = _bf16_operands(1, Sq, Skv, 4, 2, 64, 0)
    out, dout = torch.zeros_like(q), torch.ones_like(q)
    assert t_attn.bwd_route(q.dtype, 64, t_attn.on_cuda(q)) == "wgmma"
    grads = t_attn.flash_attention_backward(q, k, v, out, dout, None, causal=True)
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype and not bool(g.any())
    assert t_attn.flash_attention_backward.launches_by_route == {"wgmma": 0, "torch_ops": 0}


def test_logsumexp_is_cuda_only():
    q, k, v = _bf16_operands(1, 8, 8, 2, 2, 64, 0)
    with pytest.raises(ValueError, match="logsumexp"):
        t_attn.flash_attention_kernel(q, k, v, with_lse=True)


def wgmma_bwd_numerics(q, k, v, dout, *, causal=True):
    """Test-only emulation of ``flash_attention_bwd_sm90.cu``'s arithmetic
    on the forward's output (:func:`wgmma_numerics`) and logsumexp: float32
    scores of the bfloat16 operands, p = exp(s - lse) (0 under the causal
    mask), delta = rowsum(dout * out), dp = dout v^T and ds = p (dp - delta)
    in float32, p and ds rounded to bfloat16 as the operands of dv = p^T
    dout, dk = ds^T q / sqrt(D) and dq = ds k / sqrt(D) (float32 sums, dk
    and dv over the query heads of each kv head), each rounded once to
    bfloat16."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    rep = H // KH
    qf = q.float().reshape(B, Sq, KH, rep, D)
    kf, vf = k.float(), v.float()
    do = dout.to(torch.bfloat16).float().reshape(B, Sq, KH, rep, D)
    out = wgmma_numerics(q, k, v, causal=causal).float().reshape(B, Sq, KH, rep, D)
    scale = float(np.float32(1.0 / math.sqrt(D)))
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf) * scale
    if causal:
        s = torch.where(torch.tril(torch.ones(Sq, Skv, dtype=torch.bool)), s, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    delta = (do * out).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhrd,bkhd->bhrqk", do, vf) - delta[..., None])
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = torch.einsum("bhrqk,bqhrd->bkhd", pb, do)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", dsb, qf) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", dsb, kf).reshape(B, Sq, H, D) * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _plain_grads(q, k, v, dout, causal):
    args = [t.float().requires_grad_() for t in (q, k, v)]
    out = t_attn.flash_attention_plain(*args, causal=causal)
    return torch.autograd.grad(out, args, dout.to(torch.bfloat16).float())


@pytest.mark.parametrize("S,H,KH,D,causal", [(256, 4, 4, 160, True), (200, 4, 2, 128, False),
                                             (130, 2, 2, 256, True), (97, 6, 3, 80, True)])
def test_wgmma_backward_numerics_within_budget(S, H, KH, D, causal):
    """The card test's bar (3e-2 relative L2 against the float32 gradient of
    the plain version): the zamba2 cell's head dim, granite's GQA
    non-causal, D 256 and a length no tile divides."""
    q, k, v, dout = _bf16_grad_operands(1, S, H, KH, D, S + D)
    got = wgmma_bwd_numerics(q, k, v, dout, causal=causal)
    for name, g, w in zip("qkv", got, _plain_grads(q, k, v, dout, causal)):
        assert _rel_l2(g, w) <= BF16_ATOL, (name, _rel_l2(g, w))


def test_wgmma_backward_emulation_is_the_torch_ops_gradient_without_rounding():
    """The emulation's formula, with p and ds left in float32, is
    ``flash_attention_bwd``'s (the plain version's gradient) on the same
    forward output."""
    q, k, v, dout = _bf16_grad_operands(1, 96, 4, 2, 64, 7)
    out = wgmma_numerics(q, k, v)
    want = t_attn.flash_attention_bwd(q.float(), k.float(), v.float(), out.float(),
                                      dout.to(torch.bfloat16).float(), causal=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = float(np.float32(1.0 / math.sqrt(64)))
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf.reshape(1, 96, 2, 2, 64), kf) * scale
    s = torch.where(torch.tril(torch.ones(96, 96, dtype=torch.bool)), s, -1e30)
    p = torch.softmax(s, dim=-1)
    do = dout.to(torch.bfloat16).float().reshape(1, 96, 2, 2, 64)
    delta = (do * out.float().reshape(1, 96, 2, 2, 64)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhrd,bkhd->bhrqk", do, vf) - delta[..., None])
    dv = torch.einsum("bhrqk,bqhrd->bkhd", p, do)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qf.reshape(1, 96, 2, 2, 64)) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, kf).reshape(1, 96, 4, 64) * scale
    for g, w in zip((dq, dk, dv), want):
        assert _rel_l2(g, w) <= 1e-5
