"""The port's training substrate against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.train`` and
``repro_torch.train``.  Tolerances, each with its reason:

- ``quantize_block_int8`` codes equal (both divide in float32 and round
  half to even), scales and dequantized values within 1e-6 relative.
- ``adamw_update`` (float32 and 8-bit moments) and ``ef_compress`` on
  identical inputs: new parameters, moments and residuals within 1e-6
  relative to each leaf's largest magnitude, codes equal but where a
  value sat within float32 rounding of a half (counted, at most 1 in
  10,000); the global norm, which sums the leaves in another order,
  within 1e-6.
- ``compressed_psum`` on an 8-shard CPU mesh against its numpy formula:
  equal (the same float32 operations).
- ``pipeline_apply`` against the sequential application of the stages:
  1e-5, as ``tests/test_pipeline_parallel.py``.
- The train step's properties as ``tests/test_train.py`` holds them (the
  loss falls; ``grad_accum`` 1 against 4 within 1e-4); the port against
  the reference's ``make_train_step`` over 3 steps of the tests' ``TINY``
  from the same float32 parameters: each step's loss within 5e-2 (the
  bfloat16 compute bar of ``tests/test_torch_lm.py``).
- The straggler watchdog: the same events as the reference on the same
  timings.
- The CLI (``launch/train.py``) as ``tests/test_train_cli.py`` runs the
  reference's, on the reduced granite-3-8b without dedup (the reference's
  tests take tiny-100m, whose 66.6M parameters cost the parallel CPU
  suite minutes, and its 512-token vocabulary is under the 3,000 that
  ``vocab_forest`` needs; SSH dedup in the pipeline runs on the card, in
  ``chip_smoke.py``'s training example): resume runs only the remaining
  steps; ``grad_accum`` with compression gives finite losses.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.compression as jcomp
import repro.train.optimizer as jopt
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.inputs import make_inputs as j_make_inputs
from repro.models.model import init_params as j_init_params
from repro.train.straggler import StragglerWatchdog as JWatchdog
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_state as j_make_train_state
from repro.train.train_step import make_train_step as j_make_train_step

import repro_torch.train.compression as tcomp
import repro_torch.train.optimizer as topt
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import compat as tcompat
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch.inputs import make_inputs
from repro_torch.launch.train import build_parser, train
from repro_torch.models.model import init_params
from repro_torch.train.pipeline import pipeline_apply
from repro_torch.train.straggler import StragglerWatchdog
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

CPU = "cpu"
TINY_FIELDS = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, attn="gqa")
TINY, J_TINY = ModelConfig(**TINY_FIELDS), JModelConfig(**TINY_FIELDS)
SHAPE, J_SHAPE = ShapeConfig("t", 32, 8, "train"), JShapeConfig("t", 32, 8, "train")


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
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def close(got, want, rel=1e-6):
    g, w = N(got).astype(np.float64), N(want).astype(np.float64)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= rel * scale, float(np.abs(g - w).max()) / scale


def codes_equal(got, want, max_frac=1e-4):
    """int8 codes equal but where a value sat within float32 rounding of a
    half (the two packages reach it by different float32 sums)."""
    g, w = N(got).astype(np.int64), N(want).astype(np.int64)
    diff = g != w
    assert np.abs(g - w).max(initial=0) <= 1
    assert diff.mean() <= max_frac, diff.mean()


def _params(seed, dtype=jnp.float32):
    jp = j_init_params(J_TINY, jax.random.PRNGKey(seed), dtype=dtype)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), TINY, CPU)


def _grads_like(jp, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(rng.normal(size=p.shape, scale=scale), np.float32), jp)


# ---------------------------------------------------------------------------
# block int8 quantization and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7,), (300,), (4, 515), (3, 2, 256)])
def test_block_int8_equals_reference(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 10)).astype(np.float32)
    x.flat[0] = 0.5 * np.abs(x).max() / 127.0 * 3  # exactly 1.5 scales: a half
    jq = jopt.quantize_block_int8(jnp.asarray(x))
    tq = topt.quantize_block_int8(T(x))
    assert tq["q"].dtype == torch.int8 and tq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(N(tq["q"]), np.asarray(jq["q"]))
    close(tq["scale"], jq["scale"])
    close(topt.dequantize_block_int8(tq, shape), jopt.dequantize_block_int8(jq, shape))


def test_round_half_to_even():
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() == [0.0, 2.0, 2.0, -0.0]


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_equals_reference(bits):
    jp, tp = _params(2)
    g = _grads_like(jp)
    cfg = dict(lr=1e-3, state_bits=bits, warmup_steps=3)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jst = jopt.init_opt_state(jp, jcfg)
    tst = opt_state_from_numpy(jax.tree.map(np.asarray, jst), TINY, CPU)
    tg = jax.tree.map(T, g)
    jupdate = jax.jit(jopt.adamw_update, static_argnums=3)
    for step in range(3):
        jp, jst, jm = jupdate(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        tp, tst, tm = topt.adamw_update(tp, tg, tst, tcfg)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        close(tm["grad_norm"], jm["grad_norm"])
        close(tm["lr"], jm["lr"])
    for key, want in flat(jax.tree.map(np.asarray, jp)).items():
        close(flat(tp)[key], want)
    tmom, jmom = flat(tst["moments"]), flat(jax.tree.map(np.asarray, jst["moments"]))
    assert set(tmom) == set(jmom)
    for key, want in jmom.items():
        if key[-1] == "q":
            codes_equal(tmom[key], want)
        else:
            close(tmom[key], want, rel=1e-5 if bits == 8 else 1e-6)


_RANDOM_TREE_SHAPES = ((64, 300), (128, 256), (1000,), (32, 4, 70))
_JIT_ADAMW = jax.jit(jopt.adamw_update, static_argnums=3)


@pytest.mark.parametrize("tree", range(12))
def test_adamw_8bit_codes_follow_the_norm(tree):
    """8-bit moments on a random 4-leaf tree, 3 clipped steps (grads
    N(0, 0.3^2)), each step taken by both packages from the reference's
    state: the int8 codes are equal wherever the two global norms are
    equal, and within 1 where they are not.  The norms may differ by an
    ulp: a leaf's float32 sum of squares follows XLA's reduction order
    (windows of 32, then fusion-dependent contractions) in the reference
    and torch's in the port, and the clip scale carries that ulp into m
    and v, where a value at a rounding boundary of ``round(x / scale)``
    flips a code (ROADMAP §3, reference behaviours)."""
    rng = np.random.default_rng(100 + tree)
    cfg = dict(lr=1e-3, state_bits=8, warmup_steps=3)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = {f"l{i}": jnp.asarray((rng.normal(size=s) * 0.02).astype(np.float32))
          for i, s in enumerate(_RANDOM_TREE_SHAPES)}
    jst = jopt.init_opt_state(jp, jcfg)
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in jp.items()}
        tp, tst = jax.tree.map(T, jp), jax.tree.map(T, jst)
        jp, jst, jm = _JIT_ADAMW(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        tp, tst, tm = topt.adamw_update(tp, jax.tree.map(T, g), tst, tcfg)
        assert float(tm["grad_norm"]) > tcfg.grad_clip  # the clip is on
        same_norm = float(tm["grad_norm"]) == float(jm["grad_norm"])
        close(tm["grad_norm"], jm["grad_norm"])
        for key, want in flat(jax.tree.map(np.asarray, jst["moments"])).items():
            if key[-1] != "q":
                continue
            diff = np.abs(N(flat(tst["moments"])[key]).astype(np.int64) - want.astype(np.int64))
            assert diff.max() <= (0 if same_norm else 1), (key, same_norm, int(diff.max()))


def test_adamw_8bit_close_to_fp32():
    """As the reference's test: 8-bit updates point where float32's do."""
    _, tp = _params(2)
    rng = np.random.default_rng(0)
    grads = topt._map(lambda p: torch.as_tensor(rng.normal(size=p.shape, scale=0.01), dtype=p.dtype), tp)
    base = torch.cat([p.flatten() for p in topt.leaves(tp)]).clone()
    outs = {}
    for bits in (32, 8):
        cfg = topt.OptConfig(lr=1e-3, state_bits=bits)
        p = topt._map(torch.clone, tp)
        p2, _, _ = topt.adamw_update(p, grads, topt.init_opt_state(p, cfg), cfg)
        outs[bits] = torch.cat([x.flatten() for x in topt.leaves(p2)]) - base
    cos = float(outs[32] @ outs[8] / (outs[32].norm() * outs[8].norm()))
    assert cos > 0.98, cos


def test_updates_slice_large_leaves(monkeypatch):
    """A leaf updated in slices of dim 0 (the cap on float32 temporaries)
    gets the values of one whole update: AdamW (both moment kinds) and the
    EF round trip."""
    _, tp = _params(3)
    g = topt._map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(1)), tp)
    outs = []
    for cap in (1 << 26, 1000):
        monkeypatch.setattr(topt, "SLICE_ELEMENTS", cap)
        for bits in (32, 8):
            cfg = topt.OptConfig(lr=1e-3, state_bits=bits)
            p = topt._map(torch.clone, tp)
            st = topt.init_opt_state(p, cfg)
            topt.adamw_update(p, g, st, cfg)
            outs.append((p, st["moments"]))
        outs.append(tcomp.ef_compress(g, tcomp.init_residuals(g)))
    for a, b in zip(outs[:3], outs[3:]):
        for x, y in zip(topt.leaves(a[0]) + topt.leaves(a[1]), topt.leaves(b[0]) + topt.leaves(b[1])):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_ef_compress_equals_reference():
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(1000,)).astype(np.float32) * 0.1,
         "b": {"m": rng.normal(size=(3, 300)).astype(np.float32)}}
    jr, tr = jcomp.init_residuals(jax.tree.map(jnp.asarray, g)), tcomp.init_residuals(jax.tree.map(T, g))
    for step in range(5):
        gs = jax.tree.map(lambda a: a * (step + 1), g)
        jout, jr = jcomp.ef_compress(jax.tree.map(jnp.asarray, gs), jr)
        tout, tr = tcomp.ef_compress(jax.tree.map(T, gs), tr)
        for key, want in flat(jax.tree.map(np.asarray, jout)).items():
            close(flat(tout)[key], want)
        for key, want in flat(jax.tree.map(np.asarray, jr)).items():
            close(flat(tr)[key], want)


def test_ef_compression_bias_vanishes():
    """The reference's property: the running sum of decompressed grads
    tracks the true sum."""
    rng = np.random.default_rng(3)
    true, seen = np.zeros(1000, np.float32), np.zeros(1000, np.float32)
    resid = tcomp.init_residuals({"w": torch.zeros(1000)})
    for _ in range(50):
        g = rng.normal(size=1000).astype(np.float32) * 0.1
        true += g
        out, resid = tcomp.ef_compress({"w": torch.as_tensor(g)}, resid)
        seen += out["w"].numpy()
    assert np.abs(seen - true).max() < 5 * (0.1 * 3) / 127


def test_compressed_psum_8_shards():
    mesh = tcompat.make_mesh((8,), ("data",), devices=("cpu",) * 8)
    rng = np.random.default_rng(4)
    xs = [(rng.normal(size=(3, 300)) * rng.uniform(0.1, 5)).astype(np.float32) for _ in range(8)]
    outs = tcomp.compressed_psum([torch.as_tensor(x) for x in xs], mesh)
    # the numpy formula: shared per-block scales, int32 code sums
    pad = (-300) % 256
    xb = [np.pad(x, ((0, 0), (0, pad))).reshape(3, -1, 256) for x in xs]
    scale = np.maximum(np.max([np.abs(b).max(-1, keepdims=True) for b in xb], axis=0) / np.float32(127.0),
                       np.float32(1e-12))
    codes = sum(np.clip(np.round(b / scale), -127, 127).astype(np.int32) for b in xb)
    want = (codes.astype(np.float32) * scale).reshape(3, -1)[:, :300]
    assert len(outs) == 8
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
    assert np.abs(want - sum(xs)).max() <= 8 * scale.max() / 2 * 1.01


def test_mesh_psum_and_ppermute():
    mesh = tcompat.make_mesh((4,), ("stage",), devices=("cpu",) * 4)
    xs = [torch.full((2,), float(i)) for i in range(4)]
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in mesh.psum(xs))
    got = mesh.ppermute(xs, [(0, 1), (1, 2), (2, 3)])
    assert [float(t[0]) for t in got] == [0.0, 0.0, 1.0, 2.0]


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def test_gpipe_matches_sequential():
    n_stages, n_micro, mb, d = 4, 6, 2, 16
    mesh = tcompat.make_mesh((n_stages,), ("stage",), devices=("cpu",) * n_stages)
    rng = np.random.default_rng(0)
    Ws = torch.as_tensor(rng.normal(scale=0.3, size=(n_stages, d, d)).astype(np.float32))
    bs = torch.as_tensor(rng.normal(scale=0.1, size=(n_stages, d)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(n_micro, mb, d)).astype(np.float32))

    def stage_fn(p, h):
        W, b = p
        return torch.tanh(h @ W + b)

    out = pipeline_apply(stage_fn, (Ws, bs), x, mesh)
    ref = x
    for s in range(n_stages):
        ref = torch.tanh(ref @ Ws[s] + bs[s])
    assert float((out - ref).abs().max()) < 1e-5
    # gradients flow through the pipeline (through ppermute's copies)
    W = Ws.clone().requires_grad_()
    (g,) = torch.autograd.grad((pipeline_apply(stage_fn, (W, bs), x, mesh) ** 2).sum(), W)
    (g_ref,) = torch.autograd.grad((_seq(stage_fn, W, bs, x) ** 2).sum(), W)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert torch.allclose(g, g_ref, atol=1e-5)


def _seq(stage_fn, Ws, bs, x):
    for s in range(Ws.shape[0]):
        x = stage_fn((Ws[s], bs[s]), x)
    return x


def test_pipeline_refuses_another_axis():
    mesh = tcompat.make_mesh((2,), ("data",), devices=("cpu",) * 2)
    with pytest.raises(ValueError, match="axis"):
        pipeline_apply(lambda p, h: h, torch.zeros(2, 1), torch.zeros(3, 1, 1), mesh)


# ---------------------------------------------------------------------------
# straggler watchdog
# ---------------------------------------------------------------------------
def test_straggler_events_equal_reference():
    events, jevents = [], []
    wd, jwd = StragglerWatchdog(threshold=5.0, on_event=events.append), JWatchdog(threshold=5.0, on_event=jevents.append)
    jitter = [0.0, 0.002, -0.002, 0.001, -0.001, 0.003, -0.003, 0.0]
    for step in range(60):
        for host in range(4):
            dur = 0.10 + jitter[(step + host) % len(jitter)]
            if host == 2 and step >= 35:
                dur = 0.50
            assert wd.observe(step, host, dur) == jwd.observe(step, host, dur)
    assert [dataclasses.astuple(e) for e in events] == [dataclasses.astuple(e) for e in jevents]
    big = [ev for ev in events if ev.duration > 0.4]
    assert big and big[0].host == 2 and big[0].step == 35
    assert wd.slowest_hosts(3) == jwd.slowest_hosts(3)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _batch(seed=0):
    return make_inputs(TINY, SHAPE, seed=seed, device=CPU)


def test_loss_decreases():
    params = init_params(TINY, 0, CPU, dtype=torch.float32)
    tcfg = TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=5))
    state, step, batch = make_train_state(params, tcfg), make_train_step(TINY, tcfg), _batch()
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[::10]


def test_grad_accum_equivalence():
    params = init_params(TINY, 1, CPU, dtype=torch.float32)
    outs = {}
    for accum in (1, 4):
        tcfg = TrainConfig(opt=topt.OptConfig(lr=1e-3), grad_accum=accum)
        p = topt._map(torch.clone, params)
        p2, _, _ = make_train_step(TINY, tcfg)(p, make_train_state(p, tcfg), _batch())
        outs[accum] = torch.cat([x.flatten() for x in topt.leaves(p2)])
    assert float((outs[1] - outs[4]).abs().max()) < 1e-4


def test_compressed_training_still_learns():
    params = init_params(TINY, 4, CPU, dtype=torch.float32)
    tcfg = TrainConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=5), compress_grads=True)
    state = make_train_state(params, tcfg)
    assert "ef_residual" in state
    step, batch, losses = make_train_step(TINY, tcfg), _batch(), []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0


@pytest.mark.parametrize("variant", [
    dict(),
    dict(grad_accum=2, compress_grads=True),
    dict(state_bits=8),
])
def test_train_step_equals_reference(smoke_mesh, variant):
    """Three steps of the port against the reference's from the same float32
    parameters on the same batches: each step's loss within 5e-2."""
    variant = dict(variant)
    state_bits = variant.pop("state_bits", 32)
    opt = dict(lr=1e-3, warmup_steps=2, state_bits=state_bits)
    jt = JTrainConfig(opt=jopt.OptConfig(**opt), **variant)
    tt = TrainConfig(opt=topt.OptConfig(**opt), **variant)
    jp, tp = _params(5)
    jstate, tstate = j_make_train_state(jp, jt), make_train_state(tp, tt)
    jstep, tstep = jax.jit(j_make_train_step(J_TINY, jt, smoke_mesh)), make_train_step(TINY, tt)
    for i in range(3):
        jb = j_make_inputs(J_TINY, J_SHAPE, seed=10 + i)
        tb = {k: T(v) for k, v in jb.items()}
        jp, jstate, jm = jstep(jp, jstate, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 5e-2, (i, float(tm["loss"]), float(jm["loss"]))
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9


def test_split_microbatches_refuses_uneven():
    tcfg = TrainConfig(grad_accum=3)
    params = init_params(TINY, 0, CPU, dtype=torch.float32)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(TINY, tcfg)(params, make_train_state(params, tcfg), _batch())


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------
def test_train_cli_with_resume(tmp_path):
    common = [
        "--arch", "granite-3-8b", "--reduced", "--global-batch", "4", "--seq-len", "64",
        "--num-docs", "128", "--lr", "1e-3", "--warmup", "2", "--dedup", "none",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "5", "--log-every", "50", "--device", CPU,
    ]
    out1 = train(build_parser().parse_args(common + ["--steps", "6"]))
    assert len(out1["losses"]) == 6
    assert sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*")) == \
        ["step_0000000005", "step_0000000006"]
    out2 = train(build_parser().parse_args(common + ["--steps", "8", "--resume"]))
    assert len(out2["losses"]) == 2  # only the remaining steps ran
    assert int(out2["state"]["opt"]["step"]) == 8


def test_train_cli_grad_accum_and_compression():
    args = build_parser().parse_args([
        "--arch", "granite-3-8b", "--reduced", "--steps", "3", "--global-batch", "4",
        "--seq-len", "64", "--num-docs", "64", "--grad-accum", "2",
        "--compress-grads", "--dedup", "none", "--log-every", "50", "--device", CPU,
    ])
    out = train(args)
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert "ef_residual" in out["state"]


def test_train_cli_defaults_to_the_card():
    args = build_parser().parse_args([])
    assert args.device is None and args.arch == "tiny-100m"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train(args)
