"""The port's MoE block and MLA attention against the JAX package, on the CPU.

The reference's parameters (``repro.models.model.init_params`` in float32,
carried over by ``interop.lm_params_from_numpy``) and the same numpy
activations go through ``repro`` and ``repro_torch`` (``device="cpu"``).
The JAX MoE block runs under ``shard_map`` on a 1 x 1 ``("data", "model")``
mesh, as the JAX package's own tests run it.  Tolerances: float32 layers
1e-4 (sums in another order); the aux loss 1e-5; routing (experts, the
sorted order, slots, the kept mask) and the dropped count exactly.

The routing oracle below repeats the reference's routing lines
(``repro/models/moe.py::_local_dispatch_compute`` at one rank) in JAX, since
the reference returns only the block's output and aux; the block's output
against the reference's ``moe_block`` checks the routing end to end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jA
import repro.models.model as jmodel
import repro.models.moe as jmoe
import repro.serve.serve_step as jserve
from repro.configs import get_config as j_get_config
from repro.core import compat

import repro_torch.models.attention as tA
import repro_torch.models.moe as tmoe
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def T(x):
    """numpy / JAX array -> CPU tensor (bfloat16 kept bit for bit)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def N(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def layer(arch, group, **changes):
    """(JAX config, port config, layer 0's ``group`` params in JAX float32,
    the same as tensors)."""
    jc = dataclasses.replace(j_get_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    jp = jmodel.init_params(jc, KEY, dtype=jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"][group])
    tlp = {k: v[0] for k, v in tp["blocks"][group].items()}
    return jc, tc, jlp, tlp


def jax_routing(x_flat, router_w, cfg):
    """The reference's routing at one rank (tp = 1, my_rank = 0)."""
    T_, _ = x_flat.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    capacity = int(T_ * K / E * cfg.capacity_factor) + 1
    logits = jnp.einsum("td,de->te", x_flat.astype(jnp.float32), router_w.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    idx = jnp.arange(e_sorted.shape[0], dtype=jnp.int32)
    start = jnp.concatenate([jnp.ones((1,), bool), e_sorted[1:] != e_sorted[:-1]])
    run_start = jax.lax.cummax(jnp.where(start, idx, -1))
    pos = idx - run_start
    ok = (e_sorted < E) & (pos < capacity)
    slot = jnp.where(ok, e_sorted * capacity + pos, E * capacity)
    return dict(experts=expert_idx, order=order, slot=slot, kept=ok, capacity=capacity)


# capacity_factor 1.0 binds (assignments drop); 8.0 does not
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_routing_and_dropped_count(capacity_factor, dtype):
    jc, tc, jlp, tlp = layer("deepseek-v2-236b", "moe", capacity_factor=capacity_factor)
    x = np.random.default_rng(0).normal(size=(2 * 24, jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = T(jx)
    want = jax_routing(jx, jlp["router"], jc)
    got = tmoe.route(tx, tlp["router"], tc)
    assert got["capacity"] == want["capacity"]
    for k in ("experts", "order", "slot", "kept"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    n_dropped = int((~np.asarray(want["kept"])).sum())
    assert (n_dropped > 0) == (capacity_factor == 1.0)
    tmoe.reset_dropped()
    tmoe.dispatch_compute(tx, tlp["router"], tlp["w_gate"], tlp["w_up"], tlp["w_down"], tc)
    tmoe.dispatch_compute(tx, tlp["router"], tlp["w_gate"], tlp["w_up"], tlp["w_down"], tc)
    assert tmoe.dropped_assignments() == 2 * n_dropped  # summed over calls
    tmoe.reset_dropped()
    assert tmoe.dropped_assignments() == 0


def test_moe_routing_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities: ``jax.lax.top_k``
    takes the lower expert id first, and so does the port (a stable
    descending sort; ``torch.topk`` promises no order among equals)."""
    jc, tc, jlp, tlp = layer("deepseek-v2-236b", "moe")
    router = np.array(jlp["router"])
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    x = np.random.default_rng(1).normal(size=(64, jc.d_model)).astype(np.float32)
    want = jax_routing(jnp.asarray(x), jnp.asarray(router), jc)
    got = tmoe.route(T(x), T(router), tc)
    experts = got["experts"].numpy()
    np.testing.assert_array_equal(experts, np.asarray(want["experts"]))
    tied = np.isin(experts, (2, 5, 7)).sum(axis=1) >= 2
    assert tied.any()  # the case is exercised
    for row in experts[tied]:
        picked = [e for e in row if e in (2, 5, 7)]
        assert picked == sorted(picked)


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_block_matches_jax(mesh, arch, capacity_factor):
    """Output within 1e-4 and aux within 1e-5 in float32, capacity binding
    or not; the shared experts ride along."""
    jc, tc, jlp, tlp = layer(arch, "moe", capacity_factor=capacity_factor)
    assert tc.num_shared_experts and "shared_w_gateup" in tlp
    x = np.random.default_rng(2).normal(size=(2, 24, jc.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda x: jmoe.moe_block(x, jlp, jc, mesh))(jnp.asarray(x))
    got, aux = tmoe.moe_block(T(x), tlp, tc)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(N(got), N(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-5)


def test_moe_block_bfloat16_routing_and_output(mesh):
    """bfloat16 activations: the same routing (above) and the output within
    one bfloat16 rounding of the block's largest magnitude."""
    jc, tc, jlp, tlp = layer("deepseek-v2-236b", "moe", capacity_factor=1.0)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 24, jc.d_model)).astype(np.float32),
                    jnp.bfloat16)
    want, want_aux = jax.jit(lambda x: jmoe.moe_block(x, jlp, jc, mesh))(x)
    got, aux = tmoe.moe_block(T(x), tlp, tc)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(N(want)).max())
    assert float(np.abs(N(got) - N(want)).max()) <= 1e-2 * scale
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-5)


MLA_CASES = {  # the q low-rank path (deepseek-v2, minicpm3) and the wq path
    "deepseek-q_lora": ("deepseek-v2-236b", {}),
    "minicpm3-q_lora": ("minicpm3-4b", {}),
    "deepseek-wq": ("deepseek-v2-236b", dict(q_lora_rank=0)),
}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_attention_matches_jax(case):
    arch, changes = MLA_CASES[case]
    jc, tc, jlp, tlp = layer(arch, "attn", **changes)
    assert ("wq" in tlp) == (not tc.q_lora_rank)
    B, S = 2, 9
    x = np.random.default_rng(4).normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    want = jax.jit(lambda x, p: jA.mla_attention(x, jlp, jc, None, p))(jx, jpos)
    np.testing.assert_allclose(N(tA.mla_attention(T(x), tlp, tc, T(pos))), N(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(tA.attention_block(T(x), tlp, tc, T(pos))), N(want), rtol=0, atol=1e-4)
    wo, wc, wk = jax.jit(lambda x, p: jserve._mla_with_kv(x, jlp, jc, None, p))(jx, jpos)
    out, c_kv, k_rope = tA.mla_attention(T(x), tlp, tc, T(pos), return_kv=True)
    assert c_kv.shape == (B, S, jc.kv_lora_rank) and k_rope.shape == (B, S, jc.qk_rope_head_dim)
    for g, w in ((out, wo), (c_kv, wc), (k_rope, wk)):
        np.testing.assert_allclose(N(g), N(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_decode_matches_jax(case):
    arch, changes = MLA_CASES[case]
    jc, tc, jlp, tlp = layer(arch, "attn", **changes)
    rng = np.random.default_rng(5)
    B, Smax, at = 2, 16, 6
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, Smax, jc.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(B, Smax, jc.qk_rope_head_dim)).astype(np.float32)
    tc_kv, tk_rope = T(ckv), T(krope)
    out, c2, k2 = tA.mla_decode(T(x), tlp, tc, tc_kv, tk_rope, torch.tensor(at, dtype=torch.int32))
    wo, wc, wk = jax.jit(lambda x, c, k: jA.mla_decode(x, jlp, jc, c, k, at))(
        jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(krope))
    for g, w in ((out, wo), (c2, wc), (k2, wk)):
        np.testing.assert_allclose(N(g), N(w), rtol=0, atol=1e-4)
    assert c2 is tc_kv and k2 is tk_rope  # written in place
    rest = np.arange(Smax) != at
    np.testing.assert_array_equal(tc_kv.numpy()[:, rest], ckv[:, rest])
