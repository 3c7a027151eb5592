"""The port's gradients against ``jax.vjp`` / ``jax.value_and_grad`` of the
JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the reference and the
port (``device="cpu"``: the flash-attention and SSD autograd ops run their
plain forwards and the same hand-written backwards the card runs).
Tolerances, each with its reason:

- ``rmsnorm_fused``'s backward, float32: 1e-5 (the same float32 formula,
  sums in another order); bfloat16 inputs: ``dx`` within one bfloat16
  rounding (both round the same float32 value once), ``dw`` 1e-5 relative.
- ``flash_attention_bwd`` against ``jax.vjp`` of ``chunked_attention``,
  float32: 1e-4 relative L2 (the analytic gradient against autodiff of the
  online softmax: the same function, other sums).  The reference's
  ``chunked_attention`` takes only lengths its chunks divide, so the ragged
  length (S = 1,100) is held against ``jax.vjp`` of the JAX package's
  full-softmax oracle (``repro/kernels/attention/ref.py``), the same
  function.
- ``ssd_intra_bwd`` through ``ssd_chunked`` against ``jax.vjp`` of
  ``repro.models.mamba._ssd_chunked``, float32: 1e-4 relative L2.  Where a
  chunk's decay spans more than ~88 the reference's unmasked ``exp``
  overflows above the diagonal and its gradients of dt, A, B and C are not
  finite (0 * inf; a reference behaviour kept, ROADMAP §3): there the port
  is held to the reference's finite gradients (x, D), to autograd through
  the port's plain scan for the rest, and to finite values.  At that decay
  dA (a sum over every position of terms of both signs, far larger than
  the sum) carries float32 cancellation error: autograd through the plain
  scan and the hand-written backward each sit ~7e-3 from a float64-cum
  evaluation, so dA is held to the plain scan within 1e-2 there.
- ``loss_fn`` and its gradient against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` (jitted, float32 parameters, bfloat16 compute):
  loss within 5e-2, each leaf within 5e-2 relative L2 (the bfloat16
  compute bar of ``tests/test_torch_lm.py``).  The JAX MoE runs under
  ``shard_map``: MoE configs get a 1 x 1 ``("data", "model")`` mesh.
  Six configs run in tier-1; the ten architectures' matrix is ``slow``.
  In an MoE config the routed experts' leaves (``router``, ``w_gate``,
  ``w_up``, ``w_down``) and ``ln2``, which only they feed, carry more
  bfloat16 noise than that: the softmax gate's gradient cancels, and the
  reference's own bfloat16 gradient of them sits 4-8% from its
  float32-compute gradient (reduced deepseek-v2).  Those leaves are held
  within 5e-2 more than that distance, the rule the smoke holds decode
  steps to; and the whole MoE model is also run with float32 compute in
  both packages, where every leaf is held within 1e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.attention.ref as jattn_ref
import repro.models.layers as jL
import repro.models.mamba as jM
import repro.models.model as jmodel
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core import compat
from repro.launch import inputs as jinputs

import repro_torch.models.layers as tL
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
from repro_torch.configs import all_archs, get_config
from repro_torch.core import trace
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels.attention import kernel as tattn
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.kernels.ssd import ref as tssd_ref
from repro_torch.launch import inputs as tinputs
from repro_torch.train.optimizer import leaves as t_leaves
from repro_torch.train.train_step import loss_and_grads

CPU = "cpu"
MESH = compat.make_mesh((1, 1), ("data", "model"))
GRAD_REL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite's parallel workers share the CPU: torch on one thread here,
    as in ``tests/test_torch_sharded.py``, keeps this module from
    oversubscribing the cores under the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(x):
    """numpy / JAX array -> CPU tensor (a copy; bfloat16 kept bit for bit)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_l2(got, want) -> float:
    g, w = N(got).astype(np.float64), N(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def torch_vjp(fn, args, cotangents):
    """Gradients of ``sum(out * cotangent)`` w.r.t. ``args`` (tensors)."""
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * c.float()).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, args)


# ---------------------------------------------------------------------------
# rmsnorm_fused: the custom VJP
# ---------------------------------------------------------------------------
def _one_bf16_rounding(got, want):
    g, w = N(got), N(want)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_fused_vjp(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    w = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(3, 7, 64)).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    y, vjp = jax.vjp(lambda x, w: jL.rmsnorm_fused(x, w, 1e-5), jx, jnp.asarray(w))
    jdx, jdw = vjp(jg)
    tx, tg = T(jx), T(jg)
    ty = tL.rmsnorm_fused(tx, T(w), 1e-5)
    tdx, tdw = torch_vjp(lambda x, w: tL.rmsnorm_fused(x, w, 1e-5), (tx, T(w)), (tg,))
    assert tdx.dtype == tx.dtype and tdw.dtype == torch.float32
    if dtype == "float32":
        for got, want in ((ty, y), (tdx, jdx), (tdw, jdw)):
            np.testing.assert_allclose(N(got), N(want), rtol=1e-5, atol=1e-5)
    else:
        _one_bf16_rounding(ty, y)
        _one_bf16_rounding(tdx, jdx)
        assert rel_l2(tdw, jdw) <= 1e-5
    # the dispatcher's plain-autodiff baseline computes the same values
    np.testing.assert_array_equal(N(tL.rmsnorm_ref(tx, T(w))), N(ty))


def test_rmsnorm_dispatcher(monkeypatch):
    x, w = torch.randn(2, 5, 16, requires_grad=True), torch.zeros(16, requires_grad=True)
    assert tL.rmsnorm(x, w).grad_fn.name().endswith("_RMSNormFusedBackward")
    monkeypatch.setenv("REPRO_RMSNORM", "ref")
    assert not tL.rmsnorm(x, w).grad_fn.name().endswith("_RMSNormFusedBackward")


# ---------------------------------------------------------------------------
# flash attention (#6): its backward
# ---------------------------------------------------------------------------
ATTN_CASES = {
    # name: (B, S, H, KH, D, causal)
    "causal-d32": (2, 128, 4, 4, 32, True),
    "noncausal-d32": (2, 128, 4, 4, 32, False),
    "gqa4-d80": (1, 96, 8, 2, 80, True),
    "gqa2-d192-noncausal": (1, 64, 4, 2, 192, False),
    "two-q-chunks": (1, 2048, 2, 1, 32, True),
    "ragged-1100": (1, 1100, 4, 2, 32, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_vs_jax(case):
    B, S, H, KH, D, causal = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if S % min(1024, S):
        ref = lambda q, k, v: jattn_ref.attention(q, k, v, causal=causal)  # noqa: E731
    else:
        ref = lambda q, k, v: jL.chunked_attention(q, k, v, causal=causal)  # noqa: E731
    out, vjp = jax.vjp(jax.jit(ref), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    with trace.counting() as calls:
        got = torch_vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal), (T(q), T(k), T(v)), (T(dout),))
    assert (trace.calls(calls, "flash_attention.bwd"), trace.calls(calls, "ssd_intra.bwd")) == (1, 0)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert rel_l2(g, w) <= 1e-4, (name, rel_l2(g, w))


def test_flash_attention_bwd_dtypes_and_plain_autograd():
    """bfloat16 inputs get bfloat16 gradients; the hand-written backward
    equals autograd through the plain version (float32)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32)) for sh in
               ((2, 70, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    dout = torch.as_tensor(rng.normal(size=(2, 70, 4, 16)).astype(np.float32))
    fn = functools.partial(flash_attention, causal=True)
    plain = functools.partial(tattn.flash_attention_plain, causal=True)
    for g, w in zip(torch_vjp(fn, (q, k, v), (dout,)), torch_vjp(plain, (q, k, v), (dout,))):
        assert rel_l2(g, w) <= 1e-5
    got = torch_vjp(fn, [t.bfloat16() for t in (q, k, v)], (dout.bfloat16(),))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in got)


# ---------------------------------------------------------------------------
# the SSD intra-chunk step (#7): its backward, through the chunked scan
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, S, H, P, N, *, a_range=(1.0, 16.0), dt_range=(1e-3, 1e-1)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = rng.uniform(*dt_range, size=(2, S, H)).astype(np.float32)
    A = -rng.uniform(*a_range, size=H).astype(np.float32)
    Bm, Cm = (rng.normal(size=(2, S, 1, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=H).astype(np.float32)
    gy = rng.normal(size=(2, S, H, P)).astype(np.float32)
    gs = rng.normal(size=(2, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm, D), (gy, gs)


def _ssd_grads(args, cots, chunk):
    _, vjp = jax.vjp(jax.jit(lambda *a: jM._ssd_chunked(*a, chunk=chunk)), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cots)))
    with trace.counting() as calls:
        got = torch_vjp(lambda *a: tssd.ssd_chunked(*a, chunk=chunk), [T(a) for a in args], [T(c) for c in cots])
    assert (trace.calls(calls, "flash_attention.bwd"), trace.calls(calls, "ssd_intra.bwd")) == (0, 1)
    return got, want


@pytest.mark.parametrize("S,chunk", [(64, 64), (96, 32), (128, 16)])
def test_ssd_intra_bwd_vs_jax(S, chunk):
    args, cots = _ssd_inputs(3, S, 4, 16, 8)
    got, want = _ssd_grads(args, cots, chunk)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= 1e-4, (name, rel_l2(g, w))


def test_ssd_intra_bwd_large_decay():
    """A chunk whose decay spans several hundred: the reference's gradients
    of dt, A, B and C are not finite (its unmasked exp overflows above the
    diagonal); the port masks before the exponential."""
    args, cots = _ssd_inputs(4, 64, 4, 16, 8, a_range=(8.0, 16.0), dt_range=(0.5, 1.0))
    cum_span = float(np.max(np.sum(args[1] * -args[2], axis=1)))
    assert cum_span > 88.0 * 3
    got, want = _ssd_grads(args, cots, 64)
    names = ("x", "dt", "A", "B", "C", "D")
    assert all(bool(torch.isfinite(g).all()) for g in got)
    finite = {n: bool(jnp.isfinite(w).all()) for n, w in zip(names, want)}
    assert finite == {"x": True, "dt": False, "A": False, "B": False, "C": False, "D": True}, finite
    for n, g, w in zip(names, got, want):
        if finite[n]:
            assert rel_l2(g, w) <= 1e-4, (n, rel_l2(g, w))
    plain = torch_vjp(lambda *a: tssd_ref.ssd_chunked(*a, chunk=64), [T(a) for a in args],
                      [T(c) for c in cots])
    for n, g, w in zip(names, got, plain):
        assert rel_l2(g, w) <= (1e-2 if n == "A" else 1e-4), (n, rel_l2(g, w))


def test_ssd_intra_bwd_bf16_intra_close_to_autograd():
    """Under ``bf16_intra`` the backward computes in float32 from the
    bfloat16-rounded operands: within 5e-2 of autograd through the plain
    version's rounded forward (the smoke's bar on the card)."""
    args, cots = _ssd_inputs(5, 64, 4, 16, 16)
    fn = lambda *a: tssd.ssd_chunked(*a, chunk=32, bf16_intra=True)  # noqa: E731
    plain = lambda *a: tssd_ref.ssd_chunked(*a, chunk=32, bf16_intra=True)  # noqa: E731
    for g, w in zip(torch_vjp(fn, [T(a) for a in args], [T(c) for c in cots]),
                    torch_vjp(plain, [T(a) for a in args], [T(c) for c in cots])):
        assert rel_l2(g, w) <= 5e-2


# ---------------------------------------------------------------------------
# loss_fn and its gradients, the whole model
# ---------------------------------------------------------------------------
LOSS_CASES = {
    # case: (arch, config changes)
    "dense": ("granite-3-8b", {}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "moe-mla": ("deepseek-v2-236b", {}),
    "vision": ("internvl2-76b", {}),
    "audio": ("hubert-xlarge", {}),
}
SLOW_ARCHS = sorted(set(all_archs()) - {a for a, _ in LOSS_CASES.values()})


@functools.lru_cache(maxsize=None)
def _loss_run(arch, changes=(), compute="bfloat16"):
    """Both packages' loss, metrics and gradients on the reduced config
    (the reference's float32 parameters carried over), batch 2 x 32, with
    activations in ``compute`` (the packages' ``COMPUTE_DTYPE``)."""
    jc = dataclasses.replace(j_get_config(arch).reduced(), **dict(changes))
    tc = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc, CPU)
    shape = dataclasses.replace(J_SHAPES["train_4k"].reduced(), seq_len=32, global_batch=2)
    jin = jinputs.make_inputs(jc, shape, seed=0)
    tin = tinputs.make_inputs(tc, shape, seed=0, device=CPU)
    mesh = MESH if jc.family == "moe" else None
    saved = jL.COMPUTE_DTYPE, tL.COMPUTE_DTYPE
    jL.COMPUTE_DTYPE, tL.COMPUTE_DTYPE = getattr(jnp, compute), getattr(torch, compute)
    try:
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, i: jmodel.loss_fn(p, i, jc, mesh), has_aux=True))(jp, jin)
        tmoe.reset_dropped()
        tloss, tmet, tgrads = loss_and_grads(tp, tin, tc)
    finally:
        jL.COMPUTE_DTYPE, tL.COMPUTE_DTYPE = saved
    return dict(cfg=tc, jloss=float(jloss), tloss=float(tloss), jmet=jmet, tmet=tmet,
                jgrads=_flat(jax.tree.map(np.asarray, jgrads)), tgrads=_flat(tgrads), tp=_flat(tp))


ROUTED = {("blocks", "moe", k) for k in ("router", "w_gate", "w_up", "w_down")} | {("blocks", "ln2")}


def _check_loss_and_grads(arch, changes=()):
    r = _loss_run(arch, changes)
    assert abs(r["tloss"] - r["jloss"]) <= 5e-2, (r["tloss"], r["jloss"])
    assert int(r["tmet"]["ntok"]) == int(r["jmet"]["ntok"])
    assert abs(float(r["tmet"]["aux"]) - float(r["jmet"]["aux"])) <= 1e-3 * max(1.0, float(r["jmet"]["aux"]))
    assert set(r["jgrads"]) == set(r["tgrads"])
    bars = {key: GRAD_REL for key in r["tgrads"]}
    if r["cfg"].family == "moe":
        f32 = _loss_run(arch, changes, "float32")
        for key in ROUTED:
            bars[key] = GRAD_REL + rel_l2(r["jgrads"][key], f32["jgrads"][key])
        bad32 = {k: e for k, g in f32["tgrads"].items() if (e := rel_l2(g, f32["jgrads"][k])) > 1e-3}
        assert not bad32, bad32
    worst = {}
    for key, g in r["tgrads"].items():
        p = r["tp"][key]
        assert g.shape == p.shape and g.dtype == p.dtype, key
        assert bool(torch.isfinite(g).all()), key
        worst[key] = rel_l2(g, r["jgrads"][key])
    bad = {k: (v, bars[k]) for k, v in worst.items() if v > bars[k]}
    assert not bad, bad


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_vs_jax(case):
    arch, changes = LOSS_CASES[case]
    _check_loss_and_grads(arch, tuple(sorted(changes.items())))


@pytest.mark.slow
@pytest.mark.parametrize("arch", SLOW_ARCHS)
def test_loss_and_grads_vs_jax_all_archs(arch):
    _check_loss_and_grads(arch)


def test_vision_labels_padded_and_metrics():
    """The vision frontend's loss counts the text labels only: ``ntok`` is
    the batch's text tokens, the patches are padded with -1."""
    r = _loss_run("internvl2-76b")
    cfg = r["cfg"]
    assert int(r["tmet"]["ntok"]) == 2 * (32 - cfg.vis_tokens)
    assert abs(float(r["tmet"]["ce"]) + tmodel.AUX_LOSS_COEF * float(r["tmet"]["aux"]) - r["tloss"]) <= 1e-6


def test_loss_counts_only_labels_ge_0():
    cfg = get_config("granite-3-8b").reduced()
    params = tmodel.init_params(cfg, 0, CPU, dtype=torch.float32)
    rng = np.random.default_rng(6)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    labels[0, :5] = -1
    with torch.no_grad():
        _, m = tmodel.loss_fn(params, {"tokens": tokens, "labels": labels}, cfg)
        logits, _ = tmodel.forward(params, {"tokens": tokens}, cfg)
    keep = labels >= 0
    ce = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    assert int(m["ntok"]) == int(keep.sum())
    assert abs(float(m["ce"]) - float(ce[keep].mean())) <= 1e-5


# ---------------------------------------------------------------------------
# recompute: units, the REPRO_REMAT policies, MoE drops counted once
# ---------------------------------------------------------------------------
def test_units_follow_the_scanned_unit():
    z = get_config("zamba2-2.7b")
    assert tmodel.units(z) == [list(range(i, i + 6)) for i in range(0, 54, 6)]
    assert tmodel.units(get_config("granite-3-8b").reduced()) == [[0], [1], [2], [3]]
    odd = dataclasses.replace(z.reduced(), num_layers=5)
    assert tmodel.units(odd) == [[0, 1], [2, 3], [4]]


def test_remat_policies_give_the_same_gradient(monkeypatch):
    cfg = get_config("zamba2-2.7b").reduced()
    params = tmodel.init_params(cfg, 0, CPU, dtype=torch.float32)
    inputs = tinputs.make_inputs(cfg, J_SHAPES["train_4k"].reduced(), seed=1, device=CPU)
    base = loss_and_grads(params, inputs, cfg)
    monkeypatch.setenv("REPRO_REMAT", "dots")
    dots = loss_and_grads(params, inputs, cfg)
    assert float(base[0]) == float(dots[0])
    for g, w in zip(t_leaves(dots[2]), t_leaves(base[2])):
        assert torch.equal(g, w)
    monkeypatch.setenv("REPRO_REMAT", "everything")
    with pytest.raises(ValueError, match="REPRO_REMAT"):
        loss_and_grads(params, inputs, cfg)


def test_moe_drops_counted_once_per_step():
    """A training step recomputes each MoE layer in its backward; the
    layer's dropped assignments count once: equal to a plain forward's."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), capacity_factor=0.5)
    params = tmodel.init_params(cfg, 0, CPU, dtype=torch.float32)
    inputs = tinputs.make_inputs(cfg, J_SHAPES["train_4k"].reduced(), seed=2, device=CPU)
    tmoe.reset_dropped()
    with torch.no_grad():
        tmodel.forward(params, inputs, cfg)
    plain = tmoe.dropped_assignments()
    tmoe.reset_dropped()
    loss_and_grads(params, inputs, cfg)
    assert plain > 0 and tmoe.dropped_assignments() == plain


def test_serving_forward_builds_no_graph():
    cfg = get_config("zamba2-2.7b").reduced()
    params = tmodel.init_params(cfg, 0, CPU)
    tokens = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 16)))
    with torch.no_grad():
        a, _ = tmodel.forward(params, {"tokens": tokens}, cfg)
    b, _ = tmodel.forward(params, {"tokens": tokens}, cfg)
    assert a.grad_fn is None
    assert torch.equal(a, b.detach())
