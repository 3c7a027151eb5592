"""The port's sharding helpers and multi-axis meshes against the JAX package.

- ``resolve_spec``: the JAX package's resolver reads only ``mesh.shape``
  and ``mesh.axis_names``, so a stand-in with those two attributes checks
  every spec with no devices.  Every parameter leaf, cache leaf (decode
  and long-context batches) and input of every registered architecture
  resolves to the reference's spec, axis by axis, on the ``(16, 16)``,
  ``(2, 16, 16)``, ``(1, 1)``, ``(2, 2)`` and ``(1, 4)`` meshes (the port's
  meshes of ``meta`` devices: nothing is allocated).
- Per-rank parameter bytes on a 256-rank ``meta`` mesh equal the bytes of
  JAX's ``param_shardings(...)[leaf].shard_shape`` on 256 virtual CPU
  devices (one subprocess) for a dense, an MoE and a hybrid architecture;
  optimizer state follows the parameters' placements.
- Multi-axis ``ShardMesh`` collectives equal their numpy definitions on
  ``(2, 2)`` and ``(2, 2, 2)`` CPU meshes, group by group; ``Placement``
  cuts and reassembles as JAX's ``NamedSharding`` does; ``shard_map``
  splits by multi-axis specs.  Exact: the same float32 operations.
- The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.
"""
import ast
import json
import math
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO, run_subprocess

import repro.launch.inputs as jinputs
import repro.models.layers as jL
import repro.models.model as jmodel
import repro.serve.kvcache as jkv
from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs
from repro.configs import get_config as j_get_config

import repro_torch.launch.inputs as tinputs
import repro_torch.models.layers as tL
import repro_torch.models.model as tmodel
import repro_torch.serve.kvcache as tkv
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import compat
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_executor_mesh, make_production_mesh, make_smoke_mesh

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
BYTES_ARCHS = ("granite-3-8b", "deepseek-v2-236b", "zamba2-2.7b")  # dense, MoE, hybrid


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StandIn:
    """What JAX's resolver reads of a mesh."""

    def __init__(self, shape, names):
        self.shape, self.axis_names = dict(zip(names, shape)), names


def meta_mesh(shape, names):
    return compat.make_mesh(shape, names, devices=("meta",) * math.prod(shape))


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_param_specs_equal_jax(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    want = {k: _spec(jL.resolve_spec(StandIn(shape, names), s.shape, s.axes))
            for k, s in _flat(jmodel._fix_shared(jmodel.build_param_specs(j_get_config(arch)),
                                                 j_get_config(arch))).items()}
    got = {k: _spec(p.spec) for k, p in _flat(tmodel.param_shardings(get_config(arch),
                                                                     meta_mesh(shape, names))).items()}
    assert got == want
    specs = _flat(tmodel.build_param_specs(get_config(arch)))
    jspecs = _flat(jmodel._fix_shared(jmodel.build_param_specs(j_get_config(arch)), j_get_config(arch)))
    assert {k: (s.shape, s.axes) for k, s in specs.items()} == \
        {k: (tuple(s.shape), tuple(s.axes)) for k, s in jspecs.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_cache_and_input_specs_equal_jax(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    stand, mesh = StandIn(shape, names), meta_mesh(shape, names)
    jc, tc = j_get_config(arch), get_config(arch)
    for batch, max_len in ((128, 32_768), (1, 524_288)):
        want = {k: _spec(jL.resolve_spec(stand, s, ax)) for k, (s, _, ax) in jkv.cache_shapes(
            jc, batch, max_len).items()}
        got = {k: _spec(p.spec) for k, p in tkv.cache_shardings(tc, batch, max_len, mesh).items()}
        assert got == want, (batch, max_len)
        structs = tkv.cache_shape_structs(tc, batch, max_len, mesh)
        assert {k: s.placement.spec for k, s in structs.items()} == \
            {k: p.spec for k, p in tkv.cache_shardings(tc, batch, max_len, mesh).items()}
    for sname in ("train_4k", "prefill_32k"):
        ax = jL.dp_axes(stand)
        want = {k: _spec(jL.resolve_spec(stand, s, (ax,) + (None,) * (len(s) - 1)))
                for k, (s, _) in jinputs.train_input_shapes(jc, J_SHAPES[sname]).items()}
        specs = tinputs.input_specs(tc, SHAPES[sname], mesh)
        assert {k: _spec(s.placement.spec) for k, s in specs.items()} == want
        assert {k: _spec(p.spec) for k, p in tinputs.input_shardings(tc, SHAPES[sname], mesh).items()} == want


def test_resolver_drops_absent_and_uneven_axes():
    mesh = meta_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tuple(tL.resolve_spec(mesh, (64, 48, 7), (("pod", "data"), "model", "model"))) == \
        (("pod", "data"), "model", None)
    assert tuple(tL.resolve_spec(mesh, (64, 8), ("expert", ("data", "nope")))) == (None, None)
    assert tL.axis_size(mesh, ("pod", "data")) == 32 and tL.axis_size(mesh, None) == 1
    assert tL.dp_axes(mesh) == ("pod", "data") and tL.dp_axes(meta_mesh((1, 1), ("data", "model"))) == ("data",)


JAX_BYTES = textwrap.dedent("""
    import json, math
    import jax, numpy as np
    jax.devices()  # the 256 devices bind before the dry-run module sets its own count
    import repro.launch.dryrun as jdry
    import repro.models.model as jmodel
    from repro.configs import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.train.optimizer import OptConfig, init_opt_state
    mesh = make_production_mesh()
    out, opt = {{}}, {{}}
    for arch in {archs!r}:
        cfg = get_config(arch)
        sds = jmodel.param_shape_structs(cfg)
        sh = jmodel.param_shardings(cfg, mesh)
        flat_s = jax.tree_util.tree_flatten_with_path(sds)[0]
        flat_h = jax.tree.leaves(sh)
        out[arch] = {{jax.tree_util.keystr(k): [list(h.shard_shape(s.shape)), np.dtype(s.dtype).itemsize]
                      for (k, s), h in zip(flat_s, flat_h)}}
        ocfg = OptConfig(state_bits=jdry._opt_bits(cfg))
        st = jax.eval_shape(lambda p: {{"opt": init_opt_state(p, ocfg)}}, sds)
        st_sh = jdry._state_shardings(st, sh, mesh)
        opt[arch] = sum(math.prod(h.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize
                        for s, h in zip(jax.tree.leaves(st), jax.tree.leaves(st_sh)))
    print(json.dumps({{"params": out, "opt_state": opt}}))
""")


@pytest.fixture(scope="module")
def jax_shard_shapes():
    out = run_subprocess(JAX_BYTES.format(archs=BYTES_ARCHS), devices=256, timeout=600)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_per_rank_bytes_equal_jax_shard_shapes(jax_shard_shapes, arch):
    cfg = get_config(arch)
    mesh = make_production_mesh(devices=("meta",) * 256)
    places = _flat(tmodel.param_shardings(cfg, mesh))
    structs = _flat(tmodel.param_shape_structs(cfg))
    got = {}
    for k, p in places.items():
        blocks = p.place(torch.empty(structs[k].shape, dtype=structs[k].dtype, device="meta"))
        assert len(blocks) == 256 and all(b.device.type == "meta" for b in blocks)
        assert {tuple(b.shape) for b in blocks} == {p.shard_shape(structs[k].shape)}
        got["".join(f"['{part}']" for part in k)] = [list(blocks[0].shape), structs[k].dtype.itemsize]
    want = jax_shard_shapes["params"][arch]
    assert got == want
    rank_bytes = sum(math.prod(s) * b for s, b in got.values())
    assert rank_bytes == sum(math.prod(s) * b for s, b in want.values())
    # the dry-run's per-rank bytes: the same parameters, and the optimizer
    # state on the reference's ``_state_shardings`` (8-bit for deepseek-v2)
    derived = dryrun.rank_bytes(cfg, SHAPES["train_4k"], mesh)
    assert derived["params"] == rank_bytes
    assert derived["opt_state"] == jax_shard_shapes["opt_state"][arch]


def _rank_groups_numpy(shape, axis_positions):
    """{rank: its group, ordered} for a collective over the axes at
    ``axis_positions``: numpy's view of a row-major rank grid."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    other = [i for i in range(len(shape)) if i not in axis_positions]
    moved = np.moveaxis(grid, other + list(axis_positions), range(len(shape)))
    groups = moved.reshape(-1, math.prod(shape[i] for i in axis_positions))
    return {int(r): [int(x) for x in g] for g in groups for r in g}


COLLECTIVE_CASES = [((2, 2), ("data", "model"), "model"), ((2, 2), ("data", "model"), "data"),
                    ((2, 2), ("data", "model"), None),
                    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
                    ((2, 2, 2), ("pod", "data", "model"), "model"),
                    ((2, 2, 2), ("pod", "data", "model"), "pod")]


@pytest.mark.parametrize("shape,names,axis", COLLECTIVE_CASES)
def test_multi_axis_collectives_equal_numpy(shape, names, axis):
    n = math.prod(shape)
    mesh = compat.make_mesh(shape, names, devices=("cpu",) * n)
    axes = names if axis is None else ((axis,) if isinstance(axis, str) else axis)
    groups = _rank_groups_numpy(shape, [names.index(a) for a in axes])
    assert sorted(map(tuple, mesh.groups(axis))) == sorted({tuple(g) for g in groups.values()})
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(len(groups[0]) * 2, 3)).astype(np.float32) for _ in range(n)]
    ts = [torch.from_numpy(x) for x in xs]
    for r in range(n):
        g = groups[r]
        np.testing.assert_array_equal(mesh.psum(ts, axis)[r].numpy(), sum(xs[q] for q in g))
        np.testing.assert_array_equal(mesh.pmax(ts, axis)[r].numpy(), np.maximum.reduce([xs[q] for q in g]))
        np.testing.assert_array_equal(mesh.all_gather(ts, axis)[r].numpy(), np.concatenate([xs[q] for q in g]))
        j = g.index(r)
        np.testing.assert_array_equal(mesh.all_to_all(ts, axis)[r].numpy(), np.concatenate(
            [np.split(xs[q], len(g))[j] for q in g]))
        perm = [(i, (i + 1) % len(g)) for i in range(len(g))]
        np.testing.assert_array_equal(mesh.ppermute(ts, perm, axis)[r].numpy(), xs[g[(j - 1) % len(g)]])
        np.testing.assert_allclose(mesh.pmean(ts, axis)[r].numpy(), sum(xs[q] for q in g) / len(g), rtol=1e-6)
    # positions along the axis, and the bytes each collective counted
    if isinstance(axis, str):
        assert mesh.axis_index(axis) == [mesh.coords(r)[names.index(axis)] for r in range(n)]
    mesh.reset_collective_bytes()
    mesh.psum(ts, axis)
    mesh.all_gather(ts, axis)
    assert mesh.collective_bytes == {"all-reduce": n * xs[0].nbytes, "all-gather": n * xs[0].nbytes,
                                     "all-to-all": 0, "collective-permute": 0}


def test_psum_sums_in_group_order():
    """A psum adds the group's tensors in axis order, as the flat mesh
    always has (the sharded engine's buffers depend on it)."""
    mesh = compat.make_mesh((2, 2), ("data", "model"), devices=("cpu",) * 4)
    xs = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]), torch.tensor([-1e8]),
          torch.tensor([1.0])]
    got = mesh.psum(xs, "data")  # groups (0, 2) and (1, 3)
    assert float(got[0]) == float(xs[0] + xs[2]) and float(got[1]) == 2.0


def test_placement_cuts_and_reassembles():
    mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=("cpu",) * 8)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = compat.P(("pod", "data"), "model", None)
    pl = compat.Placement(mesh, spec)
    blocks = pl.place(x)
    assert pl.shard_shape(x.shape) == (2, 3, 4)
    for r, b in enumerate(blocks):
        pod, data, model = mesh.coords(r)
        i = pod * 2 + data
        assert torch.equal(b, x[2 * i:2 * i + 2, 3 * model:3 * model + 3])
        assert b.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # a view
    assert torch.equal(pl.assemble(blocks), x)
    with pytest.raises(ValueError, match="does not split"):
        pl.place(torch.zeros(6, 6, 4))


def test_shard_map_on_a_multi_axis_mesh():
    mesh = compat.make_mesh((2, 2), ("data", "model"), devices=("cpu",) * 4)
    P = compat.P
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    w = torch.arange(6, dtype=torch.float32)

    def prog(xs, ws):
        parts = [xl * wl.sum() for xl, wl in zip(xs, ws)]
        return mesh.psum(parts, "model"), [p.sum().reshape(1) for p in parts]

    out, sums = compat.shard_map(prog, mesh=mesh, in_specs=(P("data", None), P("model")),
                                 out_specs=(P("data", None), P("data")))(x, w)
    assert torch.equal(out, x * w.sum())  # the model ranks' partial weights summed
    assert torch.equal(sums, torch.stack([(x[:2] * w[:3].sum()).sum(), (x[2:] * w[:3].sum()).sum()]))


def test_replicate_shares_one_tensor_a_device():
    mesh = compat.make_mesh((2, 2), ("data", "model"), devices=("cpu",) * 4)
    w = torch.randn(3, 3)
    assert all(t is w for t in mesh.replicate(w))


def test_meshes():
    prod = make_production_mesh(devices=("meta",) * 256)
    multi = make_production_mesh(True, devices=("meta",) * 512)
    smoke = make_smoke_mesh(devices=("cpu",))
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert smoke.shape == {"data": 1, "model": 1} and smoke.axis_names == ("data", "model")
    assert prod.coords(17) == (1, 1) and multi.coords(300) == (1, 2, 12)
    flat = make_executor_mesh(devices=("cpu",) * 3)
    assert flat.axis_name == "ex" and flat.shape == {"ex": 3}
    if not torch.cuda.is_available():
        for make in (make_production_mesh, make_smoke_mesh):
            with pytest.raises(ValueError, match="CUDA devices"):
                make()


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_port_imports_neither_jax_nor_repro():
    root = pathlib.Path(REPO)
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 50
    bad = {str(f.relative_to(root)): sorted(_imports(f) & {"jax", "jaxlib", "repro"}) for f in files}
    assert not {k: v for k, v in bad.items() if v}
