"""The port's LM serving slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, and the reference's own parameter
trees (``repro.models.model.init_params``, carried over leaf for leaf by
``interop.lm_params_from_numpy``) go through ``repro`` and ``repro_torch``
(``device="cpu"``, so the flash-attention and SSD kernel wrappers run their
plain versions, which ``tests/test_torch_kernels.py`` holds against the
reference's Pallas kernels).  Tolerances, each with its reason:

- layers fed float32 activations stay float32 end to end: 1e-4 (sums in
  another order); the reference's layers run jitted.
- the whole model computes in bfloat16 (``COMPUTE_DTYPE``) whatever the
  parameters' dtype: logits within 5e-2, the bar of the reference's
  decode-vs-forward test (``tests/test_models.py``); caches within 1% of
  each tensor's largest magnitude (one bfloat16 rounding apart).

The JAX MoE block runs under ``shard_map``, so MoE configs get a 1 x 1
``("data", "model")`` mesh on the JAX side (as ``conftest.smoke_mesh``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jA
import repro.models.layers as jL
import repro.models.mamba as jM
import repro.models.model as jmodel
import repro.serve.kvcache as jkv
import repro.serve.serve_step as jserve
from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs as j_all_archs
from repro.configs import get_config as j_get_config
from repro.core import compat
from repro.launch import inputs as jinputs

import repro_torch.models.attention as tA
import repro_torch.models.layers as tL
import repro_torch.models.mamba as tM
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
import repro_torch.serve.kvcache as tkv
import repro_torch.serve.serve_step as tserve
from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import serve as tserve_cli

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
LOGITS_ATOL = 5e-2
CACHE_REL = 1e-2
MESH = compat.make_mesh((1, 1), ("data", "model"))


def jmesh(cfg):
    """The JAX side's mesh: the 1 x 1 mesh for MoE (its ``shard_map``)."""
    return MESH if cfg.family == "moe" else None


def T(x, dtype=None):
    """numpy / JAX array -> CPU tensor (a copy; bfloat16 kept bit for bit)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def N(x):
    """tensor or JAX array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, want, atol, what=""):
    np.testing.assert_allclose(N(got), N(want), rtol=0, atol=atol, err_msg=what)


def assert_cache_close(got: dict, want: dict):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in want:
        g, w = N(got[name]), N(want[name])
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= CACHE_REL * scale, f"cache {name}: max |diff| {err} > 1% of {scale}"


def reduced(arch, **changes):
    """The reduced config in both packages (the same data)."""
    jc = dataclasses.replace(j_get_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(arch, changes):
    jc, tc = reduced(arch, **dict(changes))
    jp = jmodel.init_params(jc, KEY, dtype=jnp.float32)
    return jc, tc, jp, lm_params_from_numpy(np_tree(jp), tc, CPU)


def jax_params(arch, **changes):
    """(JAX config, port config, JAX float32 params, the same as tensors),
    made once per config."""
    return _jax_params(arch, tuple(sorted(changes.items())))


# ---------------------------------------------------------------------------
# layers (float32 activations: a float32 path, 1e-4)
# ---------------------------------------------------------------------------
def test_rmsnorm_and_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32) * 0.1
    assert_close(tL.rmsnorm(T(x), T(w), 1e-5), jL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-4)
    pos = rng.integers(0, 100, size=(2, 6)).astype(np.int32)
    assert_close(tL.rope(T(x), T(pos), 10_000.0), jL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_swiglu_mlp(fused):
    jc, tc, jp, tp = jax_params("granite-3-8b", **({} if fused else {"fused_gate_up": False}))
    x = np.random.default_rng(2).normal(size=(2, 5, jc.d_model)).astype(np.float32)
    lp = tmodel.layer_params(tp["blocks"], 1)["mlp"]
    jlp = jax.tree.map(lambda a: a[1], jp["blocks"]["mlp"])
    assert ("w_gateup" in lp) == fused
    assert_close(tL.swiglu_mlp(T(x), lp), jax.jit(jL.swiglu_mlp)(jnp.asarray(x), jlp), 1e-4)


@pytest.fixture(scope="module")
def mamba_layer():
    jc, tc, jp, tp = jax_params("mamba2-1.3b")
    jlp = jax.tree.map(lambda a: a[2], jp["blocks"]["mamba"])
    tlp = tmodel.layer_params(tp["blocks"], 2)["mamba"]
    x = np.random.default_rng(3).normal(size=(2, 32, jc.d_model)).astype(np.float32)
    return jc, tc, jlp, tlp, x


def test_mamba_block(mamba_layer):
    jc, tc, jlp, tlp, x = mamba_layer
    want = jax.jit(lambda x: jM.mamba_block(x, jlp, jc, None))(jnp.asarray(x))
    assert_close(tM.mamba_block(T(x), tlp, tc), want, 1e-4)


@pytest.mark.parametrize("S", [2, 32])  # S < W - 1 left-pads the conv history
def test_mamba_prefill_state(mamba_layer, S):
    jc, tc, jlp, tlp, x = mamba_layer
    out, st = tM.mamba_prefill(T(x[:, :S]), tlp, tc)
    jout, jst = jax.jit(lambda x: jM.mamba_prefill(x, jlp, jc, None))(jnp.asarray(x[:, :S]))
    assert_close(out, jout, 1e-4)
    for k in ("conv_x", "conv_bc", "ssm"):
        assert_close(st[k], jst[k], 1e-4, k)


def test_mamba_decode_step(mamba_layer):
    jc, tc, jlp, tlp, x = mamba_layer
    _, jst = jax.jit(lambda x: jM.mamba_prefill(x, jlp, jc, None))(jnp.asarray(x[:, :31]))
    tst = {k: T(v) for k, v in jst.items()}
    out, new = tM.mamba_decode_step(T(x[:, 31:]), tst, tlp, tc)
    jout, jnew = jax.jit(lambda x, st: jM.mamba_decode_step(x, st, jlp, jc))(jnp.asarray(x[:, 31:]), jst)
    assert_close(out, jout, 1e-4)
    for k in ("conv_x", "conv_bc", "ssm"):
        assert_close(new[k], jnew[k], 1e-4, k)


ATTN_CFGS = {"split": {}, "fused_bias": dict(fused_qkv=True, qkv_bias=True)}


@pytest.mark.parametrize("variant", sorted(ATTN_CFGS))
def test_gqa_attention_and_decode(variant):
    jc, tc, jp, _ = jax_params("granite-3-8b", **ATTN_CFGS[variant])
    rng = np.random.default_rng(4)
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    if jc.qkv_bias:  # the reference initialises biases to zero: make them count
        jlp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
                   if k.startswith("b") else v) for k, v in jlp.items()}
    tlp = {k: T(v) for k, v in jlp.items()}
    B, S, Smax = 2, 9, 16
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = tA.gqa_attention(T(x), tlp, tc, T(pos))
    want = jax.jit(lambda x, pos: jA.gqa_attention(x, jlp, jc, None, pos))(jnp.asarray(x), jnp.asarray(pos))
    assert_close(got, want, 1e-4)

    KH, D = jc.num_kv_heads, jc.head_dim
    kc = rng.normal(size=(B, Smax, KH, D)).astype(np.float32)
    vc = rng.normal(size=(B, Smax, KH, D)).astype(np.float32)
    xt = x[:, :1]
    tk, tv = T(kc), T(vc)
    out, k2, v2 = tA.gqa_decode(T(xt), tlp, tc, tk, tv, torch.tensor(5, dtype=torch.int32))
    jout, jk2, jv2 = jax.jit(lambda x, kc, vc: jA.gqa_decode(x, jlp, jc, kc, vc, 5))(
        jnp.asarray(xt), jnp.asarray(kc), jnp.asarray(vc))
    assert_close(out, jout, 1e-4)
    assert_close(k2, jk2, 1e-4)
    assert_close(v2, jv2, 1e-4)
    assert k2 is tk and v2 is tv  # written in place


# ---------------------------------------------------------------------------
# the whole slice: forward, prefill with cache, greedy decode
# ---------------------------------------------------------------------------
SLICE = {
    # case: (arch, config changes, tokens S, prompt length, max_len)
    "granite-3-8b": ("granite-3-8b", {}, 12, 10, 16),
    "mamba2-1.3b": ("mamba2-1.3b", {}, 12, 10, 16),
    "zamba2-2.7b": ("zamba2-2.7b", {}, 12, 10, 16),
    # three SSD chunks in the prefill, four in the forward pass
    "zamba2-2.7b-chunk16": ("zamba2-2.7b", dict(ssm_chunk=16), 64, 48, 64),
    # MoE + MLA, MoE + GQA at head dim 32, MLA with a dense MLP
    "deepseek-v2-236b": ("deepseek-v2-236b", {}, 12, 10, 16),
    "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {}, 12, 10, 16),
    "minicpm3-4b": ("minicpm3-4b", {}, 12, 10, 16),
}


@pytest.fixture(scope="module")
def slice_runs():
    """Each case run once through both packages (lazily, by name)."""
    runs = {}

    def get(case):
        if case in runs:
            return runs[case]
        arch, changes, S, P, MAX = SLICE[case]
        jc, tc, jp, tp = jax_params(arch, **changes)
        tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (2, S)).astype(np.int32)
        jt, tt = jnp.asarray(tokens), torch.as_tensor(tokens).long()
        mesh = jmesh(jc)
        jfwd, jaux = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, jc, mesh))(jp, jt)
        # eagerly, as the reference's serving CLI runs it: its jitted prefill
        # fuses the bfloat16 conv sums in float32 and moves its own SSM
        # state further than the 1% bar from the eager one; the port rounds
        # per op, as the eager run does.  MoE has no SSM state, and its
        # eager shard_map dispatch takes ~40 s a prefill: jitted there.
        prefill = jserve.prefill_with_cache
        if jc.family == "moe":
            prefill = jax.jit(prefill, static_argnums=(2, 3, 4))
        jlp, jcache = prefill(jp, jt[:, :P], jc, mesh, MAX)
        jstep = jax.jit(jserve.make_decode_step(jc, mesh))
        jdec, c = [], jcache
        for t in (P, P + 1):
            logits, c = jstep(jp, c, jt[:, t:t + 1])
            jdec.append(logits)
        with torch.inference_mode():
            tfwd, taux = tmodel.forward(tp, {"tokens": tt}, tc)
            tlp, tcache = tserve.prefill_with_cache(tp, tt[:, :P], tc, MAX)
            tcache_prefill = {k: v.clone() for k, v in tcache.items()}
            tstep = tserve.make_decode_step(tc)
            tdec, dropped, c = [], [], tcache
            for t in (P, P + 1):
                tmoe.reset_dropped()
                logits, c = tstep(tp, c, tt[:, t:t + 1])
                tdec.append(logits)
                dropped.append(tmoe.dropped_assignments())
        runs[case] = dict(cfg=tc, P=P, jfwd=jfwd, tfwd=tfwd, jlp=jlp, tlp=tlp, jcache=jcache,
                          tcache=tcache_prefill, jdec=jdec, tdec=tdec, dropped=dropped,
                          jaux=float(jaux), taux=float(taux))
        return runs[case]

    return get


@pytest.mark.parametrize("case", sorted(SLICE))
def test_forward_logits(slice_runs, case):
    r = slice_runs(case)
    V = r["cfg"].vocab_size
    assert r["tfwd"].shape == tuple(r["jfwd"].shape)
    assert bool(torch.isfinite(r["tfwd"]).all())
    assert_close(r["tfwd"][..., :V], np.asarray(r["jfwd"])[..., :V], LOGITS_ATOL)
    assert bool((r["tfwd"][..., V:] == -1e30).all())
    # the MoE layers' aux losses, summed (0 without MoE)
    assert abs(r["taux"] - r["jaux"]) <= 1e-5 * max(1.0, abs(r["jaux"]))
    assert (r["taux"] > 0) == (r["cfg"].family == "moe")


@pytest.mark.parametrize("case", sorted(SLICE))
def test_prefill_logits_and_cache(slice_runs, case):
    r = slice_runs(case)
    V = r["cfg"].vocab_size
    assert r["tlp"].shape == tuple(r["jlp"].shape)
    assert_close(r["tlp"][..., :V], np.asarray(r["jlp"])[..., :V], LOGITS_ATOL)
    assert_cache_close(r["tcache"], r["jcache"])
    assert int(r["tcache"]["pos"]) == r["P"]


@pytest.mark.parametrize("case", sorted(SLICE))
def test_decode_steps(slice_runs, case):
    """Two teacher-forced decode steps: equal to the reference's, and to
    the port's own forward pass over the same tokens (as the reference's
    decode-vs-forward test holds its own).  An MoE decode step runs at
    capacity ``int(B*K/E*1.25) + 1`` (1 here): a step that dropped an
    assignment computes another function than the forward pass, as in the
    reference, and is held to the reference's step alone."""
    r = slice_runs(case)
    V, P = r["cfg"].vocab_size, r["P"]
    errs = [float((r["tlp"][:, -1, :V] - r["tfwd"][:, P - 1, :V]).abs().max())]
    for i, (td, jd) in enumerate(zip(r["tdec"], r["jdec"])):
        assert_close(td[..., :V], np.asarray(jd)[..., :V], LOGITS_ATOL, f"decode step {i}")
        if r["dropped"][i] == 0:
            errs.append(float((td[:, 0, :V] - r["tfwd"][:, P + i, :V]).abs().max()))
    assert max(errs) < LOGITS_ATOL, errs
    if r["cfg"].family != "moe":
        assert r["dropped"] == [0, 0]


# ---------------------------------------------------------------------------
# parameter trees, caches, init, typed errors, interop, the CLI
# ---------------------------------------------------------------------------
def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


@pytest.mark.parametrize("arch", j_all_archs())
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_param_tree_matches_jax(arch, size):
    jc, tc = j_get_config(arch), get_config(arch)
    if size == "reduced":
        jc, tc = jc.reduced(), tc.reduced()
    assert all_archs() == j_all_archs()
    assert tmodel.param_count(tc) == jmodel.param_count(jc)
    assert tmodel.padded_vocab(tc) == jmodel.padded_vocab(jc)
    want = {k: (tuple(s.shape), jnp.dtype(s.dtype).name)
            for k, s in _flat(jmodel.param_shape_structs(jc)).items()}
    got = {k: (s.shape, str(s.dtype).removeprefix("torch."))
           for k, s in _flat(tmodel.param_shape_structs(tc)).items()}
    assert got == want


@pytest.mark.parametrize("arch", j_all_archs())
def test_cache_shapes_match_jax(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    want = {k: (tuple(s), jnp.dtype(dt).name) for k, (s, dt, _) in jkv.cache_shapes(jc, 4, 2080).items()}
    got = {k: (tuple(s), str(dt).removeprefix("torch.")) for k, (s, dt) in tkv.cache_shapes(tc, 4, 2080).items()}
    assert got == want
    assert tkv.cache_bytes(tc, 4, 2080) == jkv.cache_bytes(jc, 4, 2080)


def test_full_width_cache_bytes():
    """The serving cells' caches at 4 x 2,080 positions."""
    assert tkv.cache_bytes(get_config("zamba2-2.7b"), 4, 2080) == 1_056_688_132
    assert tkv.cache_bytes(get_config("granite-3-8b"), 4, 2080) == 1_363_148_804


def test_init_params_recipes():
    cfg = get_config("zamba2-2.7b").reduced()
    p = tmodel.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    shapes = _flat(tmodel.param_shape_structs(cfg))
    got = _flat(p)
    assert set(got) == set(shapes)
    for k, t in got.items():
        assert (tuple(t.shape), t.dtype) == (shapes[k].shape, shapes[k].dtype), k
    m = p["blocks"]["mamba"]
    assert bool((p["blocks"]["ln1"] == 0).all()) and bool((m["norm"] == 0).all())
    assert bool((m["D"] == 1).all())
    a = torch.exp(m["A_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    L = cfg.num_layers
    for t, scale in ((p["embed"], 1.0), (m["w_out"], 0.02 / np.sqrt(2 * L)),
                     (m["conv_x"], 0.2), (p["lm_head"], 0.02)):
        assert abs(float(t.float().std()) / scale - 1) < 0.1
    assert not torch.equal(m["w_zx"][0], m["w_zx"][1])  # one draw per layer
    again = tmodel.init_params(cfg, 3, CPU)
    assert all(torch.equal(got[k], v) for k, v in _flat(again).items())


@pytest.mark.parametrize("arch", j_all_archs())
def test_active_param_count_matches_jax(arch):
    for jc, tc in ((j_get_config(arch), get_config(arch)),
                   (j_get_config(arch).reduced(), get_config(arch).reduced())):
        assert tmodel.active_param_count(tc) == jmodel.active_param_count(jc)
        assert (tmodel.active_param_count(tc) < tmodel.param_count(tc)) == bool(tc.num_experts)


# ---------------------------------------------------------------------------
# the modality frontends and launch/inputs.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", j_all_archs())
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_make_inputs_bit_equal(arch, shape):
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    js, ts = J_SHAPES[shape].reduced(), SHAPES[shape].reduced()
    want = jinputs.make_inputs(jc, js, seed=3)
    got = tinputs.make_inputs(tc, ts, seed=3, device=CPU)
    specs = tinputs.input_specs(tc, ts)
    jspecs = jinputs.input_specs(jc, js)
    assert list(got) == list(want) == list(specs) == list(jspecs)
    for name, w in want.items():
        g = got[name]
        assert (g.shape, g.dtype) == (specs[name].shape, specs[name].dtype), name
        assert specs[name].shape == tuple(jspecs[name].shape)
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, name
        wn = np.asarray(w)
        if wn.dtype.name == "bfloat16":  # the bits
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), wn.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), wn, err_msg=name)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b"])
def test_frontend_forward_matches_jax(arch):
    """The audio frontend (frame features, no embedding; non-causal) and
    the vision frontend (patches before the tokens, positions over both)."""
    jc, tc, jp, tp = jax_params(arch)
    assert tc.frontend != "none"
    shape = SHAPES["train_4k"].reduced()
    jin = jinputs.make_inputs(jc, J_SHAPES["train_4k"].reduced(), seed=1)
    tin = tinputs.make_inputs(tc, shape, seed=1, device=CPU)
    want = jax.jit(lambda p, i: jmodel.forward(p, i, jc, None)[0])(
        jp, {k: v for k, v in jin.items() if k != "labels"})
    with torch.inference_mode():
        got, aux = tmodel.forward(tp, tin, tc)
    V = tc.vocab_size
    assert got.shape == tuple(want.shape) == (shape.global_batch, shape.seq_len, tmodel.padded_vocab(tc))
    assert bool(torch.isfinite(got[..., :V]).all()) and float(aux) == 0.0
    assert_close(got[..., :V], np.asarray(want)[..., :V], LOGITS_ATOL)


def test_lm_params_from_numpy_bf16_and_refusals():
    jc, tc = reduced("zamba2-2.7b")
    jp = np_tree(jmodel.init_params(jc, KEY))  # bfloat16 leaves (and float32 norms)
    tp = lm_params_from_numpy(jp, tc, CPU)
    for k, a in _flat(jp).items():
        t = _flat(tp)[k]
        assert t.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32), k
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    bad = dict(jp, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(bad, tc, CPU)
    missing = {k: v for k, v in jp.items() if k != "shared"}
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(missing, tc, CPU)


def test_serve_cli_on_cpu(capsys):
    argv = ["--arch", "zamba2-2.7b", "--device", "cpu", "--batch", "2", "--gen-len", "3"]
    gen = tserve_cli.main(argv)
    cfg = get_config("zamba2-2.7b").reduced()  # --reduced is always on
    assert gen.shape == (2, 3) and gen.min() >= 0 and gen.max() < cfg.vocab_size
    np.testing.assert_array_equal(tserve_cli.main(argv), gen)
    out = capsys.readouterr().out
    assert f"cache {tkv.cache_bytes(cfg, 2, 128) / 1e6:.2f} MB" in out and "seq 1:" in out


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b", "minicpm3-4b", "internvl2-76b"])
def test_serve_cli_moe_mla_and_frontend(arch):
    """The families the CLI refused before: MoE, MLA, and a vision config
    served with ``frontend="none"`` (as the reference's CLI does)."""
    gen = tserve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--gen-len", "3",
                           "--prompt-len", "6", "--max-len", "16"])
    assert gen.shape == (2, 3) and gen.min() >= 0 and gen.max() < get_config(arch).reduced().vocab_size


def test_serve_cli_refuses_encoder_only():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve_cli.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_analyze_cli_matches_run_anotherme(capsys):
    """``python -m repro_torch.launch.analyze --n 300 --device cpu``: the
    communities and every count of the JAX pipeline on the same world."""
    from repro.core import AnotherMeConfig, run_anotherme
    from repro.data import synthetic_setup

    from repro_torch.launch import analyze

    res = analyze.main(["--n", "300", "--device", "cpu"])
    batch, forest = synthetic_setup(300, num_types=30, seed=0)
    want = run_anotherme(batch, forest, AnotherMeConfig(k=3, rho=2.0, community_mode="cliques"))
    assert sorted(map(sorted, res.communities)) == sorted(map(sorted, want.communities))
    assert {(int(a), int(b)) for a, b in res.similar_pairs} == {(int(a), int(b)) for a, b in want.similar_pairs}
    counts = [k for k, v in want.stats.items() if not k.startswith("t_")]
    assert {k: res.stats[k] for k in counts} == {k: want.stats[k] for k in counts}
    assert res.stats["num_communities"] > 0
    out = capsys.readouterr().out
    assert "trajectories          : 300" in out and "largest communities" in out
