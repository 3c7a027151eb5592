"""Data-parallel training on CPU meshes against the JAX package.

The reference jits ``make_train_step(cfg, tcfg, mesh)`` over a ``(2, 1)``
``("data", "model")`` mesh: its MoE layers route each data shard's tokens
at that shard's capacity.  The port splits each microbatch over the data
ranks, takes each shard's gradient on its rows and averages them with
``mesh.psum`` in float32 (``train/train_step.py``).  The JAX side runs
once, in one 2-device subprocess, from the reference's float32
parameters, which the port takes over (``interop.lm_params_from_numpy``).

Tolerances (those of ``tests/test_torch_train_grads.py``), float32
activations in both packages: the loss within 5e-2 (and here within
1e-4: the same float32 functions); the first moment (``m`` = 0.1 of the
clipped gradient, the gradient the step applied) within 1e-3 relative L2
a leaf; the new parameters within 5e-2 relative L2 of the reference's
update (Adam's first step is nearly a sign, so a gradient within float32
rounding of zero may flip an element's step); ``grad_norm`` within 1e-4
relative.  Resume onto another mesh: the restored parameters equal the
saved ones bit for bit.
"""
import json
import textwrap

import numpy as np
import pytest
import torch

from conftest import run_subprocess

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import compat
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.inputs import make_inputs
from repro_torch.launch.train import build_parser, make_mesh_for_devices, train
from repro_torch.models import layers as tL
from repro_torch.models.model import init_params
from repro_torch.train.checkpoint import latest_step, restore_checkpoint
from repro_torch.train.optimizer import OptConfig, leaves
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

CPU = "cpu"
CASES = ("granite-3-8b", "deepseek-v2-236b")  # dense, MoE
ACCUMS = (1, 2)
BATCH, SEQ = 8, 16

JAX_SIDE = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.layers as jL
    import repro.models.model as jmodel
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.core import compat
    from repro.launch.inputs import make_inputs
    from repro.train.optimizer import OptConfig
    from repro.train.train_step import TrainConfig, make_train_state, make_train_step
    OUT = {out!r}
    jL.COMPUTE_DTYPE = jnp.float32
    mesh = compat.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])

    def flat(tree, path=""):
        out = {{}}
        for k, v in tree.items():
            out.update(flat(v, path + k + "/") if isinstance(v, dict) else {{path + k: np.asarray(v)}})
        return out

    meta = {{}}
    for arch in {cases!r}:
        cfg = get_config(arch).reduced()
        p0 = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        np.savez(f"{{OUT}}/params_{{arch}}.npz", **flat(p0))
        inputs = make_inputs(cfg, ShapeConfig("t", {seq}, {batch}, "train"), seed=1)
        for accum in {accums!r}:
            tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), grad_accum=accum)
            step = jax.jit(make_train_step(cfg, tcfg, mesh))
            p, st, m = step(p0, make_train_state(p0, tcfg), inputs)
            np.savez(f"{{OUT}}/step_{{arch}}_{{accum}}.npz", **flat(p),
                     **{{"mom/" + k: v for k, v in flat(st["opt"]["moments"]).items()}})
            meta[f"{{arch}}_{{accum}}"] = {{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}}
    json.dump(meta, open(f"{{OUT}}/meta.json", "w"))
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_dp")
    run_subprocess(JAX_SIDE.format(out=str(out), cases=CASES, accums=ACCUMS, seq=SEQ, batch=BATCH),
                   devices=2, timeout=600)
    return out, json.loads((out / "meta.json").read_text())


def _nest(flat: dict, prefix="") -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _rel_l2(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + k + "/") if isinstance(v, dict) else {path + k: v})
    return out


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", CASES)
def test_data_parallel_step_equals_jax(jax_side, arch, accum):
    out, meta = jax_side
    cfg = get_config(arch).reduced()
    p0 = dict(np.load(out / f"params_{arch}.npz"))
    want = dict(np.load(out / f"step_{arch}_{accum}.npz"))
    params = lm_params_from_numpy(_nest(p0), cfg, CPU)
    inputs = make_inputs(cfg, ShapeConfig("t", SEQ, BATCH, "train"), seed=1, device=CPU)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), grad_accum=accum)
    mesh = compat.make_mesh((2, 1), ("data", "model"), devices=(CPU, CPU))
    saved, tL.COMPUTE_DTYPE = tL.COMPUTE_DTYPE, torch.float32
    try:
        mesh.reset_collective_bytes()
        p, st, m = make_train_step(cfg, tcfg, mesh)(params, make_train_state(params, tcfg), inputs)
    finally:
        tL.COMPUTE_DTYPE = saved
    ref = meta[f"{arch}_{accum}"]
    assert abs(float(m["loss"]) - ref["loss"]) <= 1e-4, (float(m["loss"]), ref["loss"])
    assert abs(float(m["grad_norm"]) - ref["grad_norm"]) <= 1e-4 * ref["grad_norm"]
    n_param_bytes = sum(4 * v.size for v in p0.values())
    assert mesh.collective_bytes["all-reduce"] == 2 * n_param_bytes  # one float32 psum a leaf
    for key, got in _flat(p).items():
        delta = want[key] - p0[key]
        if np.linalg.norm(delta) == 0:
            np.testing.assert_array_equal(got.numpy(), want[key], err_msg=key)
        else:
            assert _rel_l2(got.numpy() - p0[key], delta) <= 5e-2, key
    for key, got in _flat(st["opt"]["moments"]).items():
        if key.endswith("/m"):
            assert _rel_l2(got.numpy(), want["mom/" + key]) <= 1e-3, key


def test_data_shards_see_their_own_capacity():
    """At dp = 2 a microbatch's MoE layers route each data shard's tokens
    at the shard's capacity, not the microbatch's."""
    from repro_torch.models import moe

    cfg = get_config("deepseek-v2-236b").reduced()
    params = init_params(cfg, 0, CPU, dtype=torch.float32)
    inputs = make_inputs(cfg, ShapeConfig("t", SEQ, BATCH, "train"), seed=1, device=CPU)
    caps, real = [], moe.route

    def spy(x_flat, router_w, c, **kw):
        r = real(x_flat, router_w, c, **kw)
        caps.append((x_flat.shape[0], r["capacity"]))
        return r

    moe.route = spy
    try:
        tcfg = TrainConfig(grad_accum=2)
        make_train_step(cfg, tcfg, make_mesh_for_devices(devices=(CPU, CPU)))(
            params, make_train_state(params, tcfg), inputs)
    finally:
        moe.route = real
    T_shard = BATCH // 2 // 2 * SEQ  # microbatches first, then data
    assert {t for t, _ in caps} == {T_shard}
    assert {c for _, c in caps} == {int(T_shard * cfg.experts_per_token / cfg.num_experts
                                        * cfg.capacity_factor) + 1}


def test_uneven_data_split_refused():
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, 0, CPU, dtype=torch.float32)
    tcfg = TrainConfig()
    inputs = make_inputs(cfg, ShapeConfig("t", SEQ, 3, "train"), seed=1, device=CPU)
    with pytest.raises(ValueError, match="data shards"):
        make_train_step(cfg, tcfg, make_mesh_for_devices(devices=(CPU, CPU)))(
            params, make_train_state(params, tcfg), inputs)


def test_training_mesh_defaults_to_the_cards():
    mesh = make_mesh_for_devices(devices=(CPU,) * 3)
    assert mesh.shape == {"data": 3, "model": 1} and mesh.axis_names == ("data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh_for_devices(2)


def test_resume_onto_another_mesh(tmp_path):
    """Two data ranks train and checkpoint; the resume runs on one rank
    from the saved parameters, bit for bit, and only the steps left."""
    common = ["--arch", "granite-3-8b", "--reduced", "--global-batch", "4", "--seq-len", "32",
              "--num-docs", "64", "--lr", "1e-3", "--warmup", "2", "--dedup", "none",
              "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "50", "--device", CPU]
    first = train(build_parser().parse_args(common + ["--steps", "2"]),
                  mesh=make_mesh_for_devices(devices=(CPU, CPU)))
    assert latest_step(tmp_path) == 2
    restored = restore_checkpoint(tmp_path, 2, {"params": first["params"]}, device=CPU)["params"]
    for a, b in zip(leaves(restored), leaves(first["params"])):
        assert torch.equal(a, b)
    resumed = train(build_parser().parse_args(common + ["--steps", "3", "--resume"]))
    assert len(resumed["losses"]) == 1 and np.isfinite(resumed["losses"]).all()
