"""Expert-parallel MoE on CPU meshes against one device and against JAX.

The reference's ``moe_block`` runs ``shard_map`` over a ``("data",
"model")`` mesh: each model rank holds E/tp experts, each data shard
routes its own tokens at its own capacity, one ``psum`` over ``model``
sums the partial outputs.  The port runs the same program rank by rank on
an in-process mesh of CPU ranks (``models/moe.py``).  Tolerances, each
with its reason:

- At ``(1, 2)`` and ``(1, 4)`` against the port's one-device block
  (``mesh=None``): routing (each token's experts), the capacity and the
  dropped count exactly (a rank's stable sort of its own experts keeps
  the global order); the output within 1e-4 in float32 (the partial sums
  add in another order), the aux exactly.
- At ``(2, 2)`` against JAX's ``moe_block`` on 4 virtual CPU devices:
  output within 1e-4 and aux within 1e-5 (the bars of
  ``tests/test_torch_moe_mla.py``); the dropped count, which the
  reference does not report, equal to its routing's (the reference's
  routing lines at each data shard's capacity).  The aux is data shard
  0's (what JAX returns under ``out_specs=P()``, which is not a
  replicated value at dp = 2).
- Gradients at ``(1, 2)`` (input, router and expert weights) against
  ``jax.grad`` on 2 virtual devices: 5e-2 relative L2, the LM gradient
  bar of ``tests/test_torch_train_grads.py`` (float32 here: they agree far
  closer).  The aux gradient at ``(2, 2)``: the data shards' mean, as JAX
  takes it.
- Serving over a mesh: a ``(1, 2)`` prefill and teacher-forced decode
  give the one-device run's logits within 5e-2 (the LM serving bar;
  bfloat16 partial outputs summed as the reference's psum sums them).

The JAX side runs once, in one 4-device subprocess, and writes its arrays
to ``tmp_path``.
"""
import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from conftest import run_subprocess

from repro_torch.configs import get_config
from repro_torch.core import compat
from repro_torch.models import moe as tmoe

ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
CPU = "cpu"
X_SHAPE = (4, 12)  # batch x sequence; 48 tokens, 12 a (data, model) rank at (2, 2)

JAX_SIDE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.model as jmodel, repro.models.moe as jmoe
    from repro.configs import get_config
    from repro.core import compat
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "."
    OUT = {out_dir!r}
    devs = jax.devices()
    m22 = compat.make_mesh((2, 2), ("data", "model"), devices=devs[:4])
    m12 = compat.make_mesh((1, 2), ("data", "model"), devices=devs[:2])
    res = {{}}
    for arch in {archs!r}:
        for cf in (1.0, 8.0):
            cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)
            jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
            p = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
            x = np.random.default_rng(5).normal(size={xs!r} + (cfg.d_model,)).astype(np.float32)
            tag = f"{{arch}}_{{cf}}"
            np.savez(f"{{OUT}}/params_{{tag}}.npz", **{{k: np.asarray(v) for k, v in p.items()}}, x=x)
            out, aux = jax.jit(lambda x, p: jmoe.moe_block(x, p, cfg, m22))(jnp.asarray(x), p)
            # the reference's routing lines at each data shard's capacity: its drops
            E, K = cfg.num_experts, cfg.experts_per_token
            drops = 0
            for xs in np.split(x, 2):
                xf = jnp.asarray(xs.reshape(-1, cfg.d_model))
                T = xf.shape[0]
                C = int(T * K / E * cfg.capacity_factor) + 1
                probs = jax.nn.softmax(xf @ p["router"], axis=-1)
                _, idx = jax.lax.top_k(probs, K)
                flat = np.asarray(idx).reshape(-1)
                counts = np.bincount(flat, minlength=E)
                drops += int(np.maximum(counts - C, 0).sum())
            # gradients: a fixed cotangent on the output, plus the aux
            h = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

            def f(x, p, mesh):
                o, a = jmoe.moe_block(x, p, cfg, mesh)
                return jnp.sum(o * h) + a

            gx, gp = jax.jit(jax.grad(lambda x, p: f(x, p, m12), argnums=(0, 1)))(jnp.asarray(x), p)
            ga = jax.jit(jax.grad(lambda r: jmoe.moe_block(jnp.asarray(x), {{**p, "router": r}}, cfg,
                                                           m22)[1]))(p["router"])
            np.savez(f"{{OUT}}/jax_{{tag}}.npz", out=np.asarray(out), aux=np.asarray(aux), gx=np.asarray(gx),
                     h=h, gaux_router=np.asarray(ga), **{{"g_" + k: np.asarray(v) for k, v in gp.items()}})
            res[tag] = {{"drops": drops}}
    json.dump(res, open(f"{{OUT}}/jax.json", "w"))
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep")
    run_subprocess(JAX_SIDE.format(out_dir=str(out), archs=ARCHS, xs=X_SHAPE), devices=4, timeout=600)
    return out, json.loads((out / "jax.json").read_text())


def _load(jax_side, arch, cf):
    out, meta = jax_side
    tag = f"{arch}_{cf}"
    p = dict(np.load(out / f"params_{tag}.npz"))
    x = p.pop("x")
    return (dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf),
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
            dict(np.load(out / f"jax_{tag}.npz")), meta[tag])


def _mesh(shape):
    return compat.make_mesh(shape, ("data", "model"), devices=(CPU,) * int(np.prod(shape)))


class _Routes:
    """Every ``moe.route`` call's (rank, experts, capacity)."""

    def __enter__(self):
        self.calls, self.real = [], tmoe.route

        def spy(x_flat, router_w, cfg, **kw):
            r = self.real(x_flat, router_w, cfg, **kw)
            self.calls.append((kw.get("rank", 0), r["experts"].clone(), r["capacity"]))
            return r

        tmoe.route = spy
        return self

    def __exit__(self, *exc):
        tmoe.route = self.real


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_equals_one_device(jax_side, arch, cf, tp):
    cfg, p, x, _, _ = _load(jax_side, arch, cf)
    tmoe.reset_dropped()
    with _Routes() as one:
        want, want_aux = tmoe.moe_block(x, p, cfg)
    want_drops = tmoe.dropped_assignments()
    tmoe.reset_dropped()
    with _Routes() as ep:
        got, aux = tmoe.moe_block(x, p, cfg, _mesh((1, tp)))
    assert tmoe.dropped_assignments() == want_drops
    assert (want_drops > 0) == (cf == 1.0)  # the capacity binds, or not
    assert sorted(r for r, _, _ in ep.calls) == list(range(tp))
    for _, experts, capacity in ep.calls:  # every rank routes the data shard's tokens alike
        assert capacity == one.calls[0][2]
        assert torch.equal(experts, one.calls[0][1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    assert float(aux) == float(want_aux)


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_2x2_equals_jax(jax_side, arch, cf):
    cfg, p, x, want, meta = _load(jax_side, arch, cf)
    mesh = _mesh((2, 2))
    tmoe.reset_dropped()
    with _Routes() as routes:
        got, aux = tmoe.moe_block(x, p, cfg, mesh)
    assert tmoe.dropped_assignments() == meta["drops"]
    # each data shard routes its 24 tokens at its own capacity
    T_local = X_SHAPE[0] * X_SHAPE[1] // 2
    assert {c for _, _, c in routes.calls} == {
        int(T_local * cfg.experts_per_token / cfg.num_experts * cf) + 1}
    np.testing.assert_allclose(got.numpy(), want["out"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=0, atol=1e-5)
    # data shard 0's aux, not shard 1's
    shard0 = tmoe.moe_block(x[:2], p, cfg, _mesh((1, 2)))[1]
    assert float(aux) == float(shard0)


def _rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_gradients_equal_jax(jax_side, arch):
    cfg, p, x, want, _ = _load(jax_side, arch, 1.0)
    h = torch.from_numpy(want["h"])
    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in p.items()}
    o, a = tmoe.moe_block(xs, ps, cfg, _mesh((1, 2)))
    (torch.sum(o * h) + a).backward()
    assert _rel_l2(xs.grad, want["gx"]) <= 5e-2
    for k, v in ps.items():
        assert _rel_l2(v.grad, want["g_" + k]) <= 5e-2, k
    # the aux at (2, 2): the data shards' mean gradient, as JAX's
    r = p["router"].clone().requires_grad_()
    tmoe.moe_block(x, {**p, "router": r}, cfg, _mesh((2, 2)))[1].backward()
    assert _rel_l2(r.grad, want["gaux_router"]) <= 5e-2


def test_expert_weights_are_views_on_a_shared_device():
    """Ranks on one device get views of the stacked weights: nothing of
    the experts is copied per data rank."""
    cfg = get_config("deepseek-v2-236b").reduced()
    w = torch.randn(cfg.num_experts, 8, 4)
    blocks = compat.Placement(_mesh((2, 2)), compat.P("model", None, None)).place(w)
    ptr = w.untyped_storage().data_ptr()
    assert all(b.untyped_storage().data_ptr() == ptr for b in blocks)
    assert blocks[0] is blocks[2] and blocks[1] is blocks[3]  # one view a block
    assert torch.equal(blocks[1], w[cfg.num_experts // 2:])


def test_expert_parallel_refuses_an_uneven_split():
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), num_experts=6)
    p = {"router": torch.randn(cfg.d_model, 6), "w_gate": torch.randn(6, cfg.d_model, 8),
         "w_up": torch.randn(6, cfg.d_model, 8), "w_down": torch.randn(6, 8, cfg.d_model),
         "shared_w_gateup": torch.randn(cfg.d_model, 2, 8), "shared_w_down": torch.randn(8, cfg.d_model)}
    with pytest.raises(ValueError, match="do not split"):
        tmoe.moe_block(torch.randn(2, 4, cfg.d_model), p, cfg, _mesh((1, 4)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_a_mesh(arch):
    """Prefill and 3 teacher-forced decode steps over a (1, 2) mesh: the
    one-device run's logits within 5e-2 (bfloat16 activations and caches;
    the partial outputs are summed in bfloat16, as the reference's psum
    sums them), and its greedy tokens."""
    from repro_torch.models.model import init_params
    from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache

    cfg = get_config(arch).reduced()
    V = cfg.vocab_size
    params = init_params(cfg, 0, CPU)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, V, (4, 11)))
    runs = []
    for mesh in (None, _mesh((1, 2))):
        with torch.inference_mode():
            logits, cache = prefill_with_cache(params, tokens[:, :8], cfg, 16, mesh=mesh)
            step, out = make_decode_step(cfg, mesh), [logits]
            for t in range(8, 11):
                logits, cache = step(params, cache, tokens[:, t:t + 1])
                out.append(logits)
        runs.append(torch.cat(out, dim=1)[..., :V].float())
    np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(), rtol=0, atol=5e-2)
