"""The port's checkpoints (``repro_torch/train/checkpoint.py``) on the CPU,
and their interchange with the JAX package's.

As ``tests/test_checkpoint.py`` holds the reference's: round trip,
atomicity (a step without a manifest is invisible), orphaned temporary
directories collected, the last k kept, a shape mismatch refused, the
asynchronous writer, resume determinism; and both directions between the
packages on a training state with bfloat16 parameters, float32 and int8
moments and an int32 step: a checkpoint written by ``repro.train.
checkpoint`` restores into the port bit for bit, and one written by the
port restores into the reference bit for bit.  Exact equality throughout:
the format stores every value exactly (bfloat16 as float32).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.checkpoint as jck
import repro.train.optimizer as jopt
from repro.configs import get_config as j_get_config
import repro.models.model as jmodel

import repro_torch.train.optimizer as topt
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenDataset, synthetic_corpus
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.models.model import init_params, param_shape_structs
from repro_torch.train.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite's parallel workers share the CPU: torch on one thread here,
    as in ``tests/test_torch_sharded.py``, keeps this module from
    oversubscribing the cores under the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.as_tensor(rng.normal(size=(8, 16)).astype(np.float32)),
            "h": torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16(),
            "blocks": {"a": torch.as_tensor(rng.normal(size=(4, 8)).astype(np.float32))},
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "q": torch.as_tensor(rng.integers(-127, 128, (2, 256)).astype(np.int8))},
    }


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    manifest = json.loads((tmp_path / "step_0000000007" / "MANIFEST.json").read_text())
    assert manifest["leaves"]["params.h"] == {"shape": [3, 5], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt.step"] == {"shape": [], "dtype": "int32"}
    assert np.load(tmp_path / "step_0000000007" / "arrays" / "params.h.npy").dtype == np.float32
    _assert_same(restore_checkpoint(tmp_path, 7, tree), tree)


def test_restore_onto_a_device_and_from_shapes(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    out = restore_checkpoint(tmp_path, 1, tree, device=CPU)
    assert all(t.device.type == "cpu" for t in _leaves(out))
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, 0, CPU)
    save_checkpoint(tmp_path, 2, params)
    _assert_same(restore_checkpoint(tmp_path, 2, param_shape_structs(cfg)), params)


def test_atomicity_no_manifest_ignored(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    broken = tmp_path / "step_0000000009"
    (broken / "arrays").mkdir(parents=True)
    np.save(broken / "arrays" / "params.w.npy", np.zeros((8, 16)))
    assert latest_step(tmp_path) == 5
    assert latest_step(tmp_path / "absent") is None


def test_orphan_tmp_garbage_collected(tmp_path):
    orphan = tmp_path / ".tmp_step_0000000001_123"
    orphan.mkdir(parents=True)
    save_checkpoint(tmp_path, 2, _tree())
    assert not orphan.exists()


def test_keep_last_k(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, _tree(), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_0000000004", "step_0000000005"]


def test_shape_mismatch_rejected(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(tmp_path, 1, bad)
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(tmp_path, 1, {**tree, "extra": torch.zeros(1)})


def test_async_checkpointer_snapshots(tmp_path):
    tree = _tree()
    want = {k: {kk: vv.clone() if isinstance(vv, torch.Tensor) else vv for kk, vv in v.items()}
            for k, v in tree.items()}
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, tree)
    tree["params"]["w"].add_(1.0)  # an in-place update after save: not in the checkpoint
    ck.wait()
    assert latest_step(tmp_path) == 3
    out = restore_checkpoint(tmp_path, 3, tree)
    assert torch.equal(out["params"]["w"], want["params"]["w"])


def test_resume_determinism(tmp_path):
    """train(10) == train(5) -> checkpoint -> resume -> train(5)."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128, attn="gqa")
    corpus, _ = synthetic_corpus(64, 33, cfg.vocab_size, seed=0)
    ds = TokenDataset(corpus, global_batch=4, seed=0, device=CPU)
    tcfg = TrainConfig(opt=topt.OptConfig(lr=1e-3, state_bits=8))
    step = make_train_step(cfg, tcfg)

    def run(p, s, start, stop):
        for i in range(start, stop):
            p, s, _ = step(p, s, ds.batch(i))
        return p, s

    def fresh():
        p = init_params(cfg, 0, CPU, dtype=torch.float32)
        return p, make_train_state(p, tcfg)

    pa, _ = run(*fresh(), 0, 10)
    pb, sb = run(*fresh(), 0, 5)
    save_checkpoint(tmp_path, 5, {"params": pb, "state": sb})
    p0, s0 = fresh()
    rest = restore_checkpoint(tmp_path, 5, {"params": p0, "state": s0})
    pc, _ = run(rest["params"], rest["state"], 5, 10)
    _assert_same(pa, pc)


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------
def _state_pair(bits):
    """The same training state in both packages: reduced zamba2's tree with
    bfloat16 weights and the optimizer state of ``bits``-bit moments, every
    leaf random numpy (the format, not the values, is under test)."""
    jc = j_get_config("zamba2-2.7b").reduced()
    tc = get_config("zamba2-2.7b").reduced()
    rng = np.random.default_rng(bits)
    ocfg = jopt.OptConfig(state_bits=bits)
    shapes = jmodel.param_shape_structs(jc)
    jp = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32), s.dtype), shapes)
    jst = jax.tree.map(lambda a: jnp.asarray(
        rng.integers(-127, 128, a.shape).astype(np.int8) if a.dtype == jnp.int8
        else rng.normal(size=a.shape).astype(np.float32)), jopt.init_opt_state(shapes, ocfg))
    jst["step"] = jnp.asarray(3, jnp.int32)
    host = jax.tree.map(np.asarray, {"params": jp, "state": {"opt": jst}})
    tp = lm_params_from_numpy(host["params"], tc, CPU)
    tst = opt_state_from_numpy(host["state"]["opt"], tc, CPU)
    return {"params": jp, "state": {"opt": jst}}, {"params": tp, "state": {"opt": tst}}


@pytest.mark.parametrize("bits", [32, 8])
def test_reference_checkpoint_restores_into_the_port(tmp_path, bits):
    jtree, ttree = _state_pair(bits)
    jck.save_checkpoint(tmp_path, 4, jtree)
    template = {"params": init_params(get_config("zamba2-2.7b").reduced(), 1, CPU),
                "state": {"opt": topt.init_opt_state(ttree["params"], topt.OptConfig(state_bits=bits))}}
    out = restore_checkpoint(tmp_path, latest_step(tmp_path), template)
    _assert_same(out, ttree)
    assert out["params"]["embed"].dtype == torch.bfloat16
    if bits == 8:
        assert out["state"]["opt"]["moments"]["lm_head"]["m"]["q"].dtype == torch.int8


@pytest.mark.parametrize("bits", [32, 8])
def test_port_checkpoint_restores_into_the_reference(tmp_path, bits):
    jtree, ttree = _state_pair(bits)
    save_checkpoint(tmp_path, 4, ttree)
    template = jax.tree.map(jnp.zeros_like, jtree)
    out = jck.restore_checkpoint(tmp_path, 4, template)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jtree), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a),
                                      np.asarray(b, np.float32) if b.dtype == jnp.bfloat16 else np.asarray(b))
