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
