"""The port's one-shot engine against the JAX engine, on the CPU.

For every ``lcs_impl`` name, both ``community_mode``s and ``score_prune`` on
and off, the port's ``AnotherMeEngine`` (``device="cpu"``) must give the
JAX engine's ``similar_pairs`` and ``communities`` and the same scored
buffer: ``left``/``right``/``level_lcs`` equal and float32 ``mss``
bit-equal (tolerance 0; both round MSS as one forward FMA chain).  The JAX
reference runs ``lcs_impl="wavefront"``: its own parity matrix pins every
JAX impl to that one, and its Pallas interpret mode would be slow here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.data as jdata
from repro.core import centralized_similar_pairs, encode_batch, forest_tables
from repro.core import maximal_cliques as j_maximal_cliques
from repro_torch import interop
from repro_torch.api import (
    LCS_IMPLS, AnotherMeEngine, CapacityPlanner, EngineConfig, ExecutionPlan,
    NotPortedError, available_backends, get_backend, lcs_impl_fn,
)
from repro_torch.core import centralized_similar_pairs as t_centralized_similar_pairs
from repro_torch.core import encode_batch as t_encode_batch
from repro_torch.core import forest_tables as t_forest_tables
from repro_torch.core import maximal_cliques, qa1, qa2
from repro_torch.core.similarity import lcs_wavefront
from repro_torch.data import fig1_world, synthetic_setup
from repro_torch.kernels.lcs import fused as tfused
from repro_torch.kernels.lcs import kernel as tkernel

CPU = "cpu"
WORLD = dict(num_types=10, classes_per_type=5, num_places=200, seed=7)


def N(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_scored_equal(got, want):
    for field in ("left", "right", "level_lcs", "mss", "count", "overflow"):
        g, w = N(getattr(got, field)), N(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.fixture(scope="module")
def worlds():
    """(port batch, port forest, JAX batch, JAX forest) per world."""
    out = {}
    for name, n, extra in (("h3", 150, {}), ("h5", 120, dict(n_levels=5))):
        jb, jf = jdata.synthetic_setup(n, **WORLD, **extra)
        tb, tf = synthetic_setup(n, device=CPU, **WORLD, **extra)
        out[name] = (tb, tf, jb, jf)
    return out


@pytest.fixture(scope="module")
def jax_results(worlds):
    cache = {}

    def get(name, **cfg):
        key = (name, tuple(sorted(cfg.items())))
        if key not in cache:
            _, _, jb, jf = worlds[name]
            cache[key] = japi.AnotherMeEngine(jf, japi.EngineConfig(**cfg)).run(jb)
        return cache[key]

    return get


@pytest.mark.parametrize("score_prune", [False, True])
@pytest.mark.parametrize("community_mode", ["cliques", "components"])
@pytest.mark.parametrize("impl", LCS_IMPLS)
def test_engine_matches_jax(worlds, jax_results, impl, community_mode, score_prune):
    tb, tf, _, _ = worlds["h3"]
    cfg = dict(community_mode=community_mode, score_prune=score_prune)
    want = jax_results("h3", **cfg)
    got = AnotherMeEngine(tf, EngineConfig(lcs_impl=impl, **cfg), device=CPU).run(tb)
    assert got.similar_pairs == want.similar_pairs
    assert got.communities == want.communities
    assert_scored_equal(got.scored, want.scored)
    for key in ("pair_capacity", "num_candidates", "join_overflow", "num_similar",
                "num_communities") + (("num_pruned", "post_prune_capacity") if score_prune else ()):
        assert got.stats[key] == want.stats[key], key
    assert len(want.similar_pairs) > 0


@pytest.mark.parametrize("impl", ["wavefront", "kernel", "fused", "fused-pallas"])
def test_engine_matches_jax_five_levels(worlds, jax_results, impl):
    tb, tf, _, _ = worlds["h5"]
    want = jax_results("h5", rho=1.5)
    got = AnotherMeEngine(tf, EngineConfig(lcs_impl=impl, rho=1.5), device=CPU).run(tb)
    assert got.similar_pairs == want.similar_pairs and len(want.similar_pairs) > 0
    assert got.communities == want.communities
    assert_scored_equal(got.scored, want.scored)


@pytest.mark.parametrize("pair_capacity,max_retries", [(16, 3), (2, 0), (64, 1)])
def test_capacity_retry_matches_jax(worlds, jax_results, pair_capacity, max_retries):
    tb, tf, _, _ = worlds["h3"]
    cfg = dict(pair_capacity=pair_capacity, max_retries=max_retries)
    want = jax_results("h3", **cfg)
    got = AnotherMeEngine(tf, EngineConfig(lcs_impl="fused", **cfg), device=CPU).run(tb)
    assert got.stats["pair_capacity"] == want.stats["pair_capacity"]
    assert got.stats["join_overflow"] == want.stats["join_overflow"]
    assert got.similar_pairs == want.similar_pairs
    assert_scored_equal(got.scored, want.scored)


def test_betas_and_rho_options_match_jax(worlds, jax_results):
    tb, tf, _, _ = worlds["h3"]
    cfg = dict(betas=(0.5, 0.3, 0.2), rho=1.7, k=2)
    want = jax_results("h3", **cfg)
    got = AnotherMeEngine(tf, EngineConfig(lcs_impl="fused", **cfg), device=CPU).run(tb)
    assert got.similar_pairs == want.similar_pairs
    assert_scored_equal(got.scored, want.scored)


def test_fig1_story():
    jb, jf = jdata.fig1_world()
    want = japi.AnotherMeEngine(jf, japi.EngineConfig(rho=3.0)).run(jb)
    tb, tf = fig1_world(device=CPU)
    for impl in LCS_IMPLS:
        got = AnotherMeEngine(tf, EngineConfig(rho=3.0, lcs_impl=impl), device=CPU).run(tb)
        assert (0, 1) in got.similar_pairs, "Carol should find her other me!"
        assert got.similar_pairs == want.similar_pairs
        assert got.communities == want.communities
        assert_scored_equal(got.scored, want.scored)


@pytest.mark.parametrize("impl", ["wavefront", "fused"])
def test_quickstart_qa_is_exact(impl):
    """examples/quickstart.py's accuracy check on its 400-trajectory
    subsample: the port's SSH engine recovers the port's own centralized
    ground truth (all-pairs baseline) with QA1 = QA2 = 1.000, and that truth
    is the JAX package's."""
    jsub, jf = jdata.synthetic_setup(400, seed=0)
    jl, jr, _ = centralized_similar_pairs(encode_batch(jsub, forest_tables(jf)), rho=2.0)
    sub, forest = synthetic_setup(400, seed=0, device=CPU)
    cl, cr, _ = t_centralized_similar_pairs(
        t_encode_batch(sub, t_forest_tables(forest, device=CPU)), rho=2.0)
    cen = {(int(a), int(b)) for a, b in zip(cl, cr)}
    assert cen == {(int(a), int(b)) for a, b in zip(jl, jr)}
    res = AnotherMeEngine(forest, EngineConfig(backend="ssh", rho=2.0, lcs_impl=impl),
                          device=CPU).run(sub)
    assert len(cen) > 0
    assert qa1(res.communities, j_maximal_cliques(cen)) == 1.0
    assert qa1(res.communities, maximal_cliques(cen)) == 1.0
    assert qa2(res.similar_pairs, cen) == 1.0
    assert res.similar_pairs == cen


def test_interop_hands_jax_candidates_to_port_score_stage(worlds):
    """Stage-by-stage handover: the JAX join's buffer, scored by the port."""
    from repro.core.ssh import ssh_candidates as j_ssh
    from repro.core.shingling import shingles_from_types as j_sh
    from repro.core.similarity import default_betas as j_betas, score_pairs as j_score
    from repro_torch.core.encoding import encode_batch as t_encode, forest_tables as t_tables
    from repro_torch.core.similarity import default_betas as t_betas, score_pairs as t_score

    tb, tf, jb, jf = worlds["h3"]
    je = encode_batch(jb, forest_tables(jf))
    jc = j_ssh(j_sh(je.codes[:, 0, :], je.lengths, k=3, num_types=jf.num_types),
               pair_capacity=1 << 14)
    tc = interop.candidates_from_numpy(jc.left, jc.right, jc.count, jc.overflow, device=CPU)
    te = t_encode(tb, t_tables(tf, device=CPU))
    want = j_score(je.codes, je.lengths, jc.left, jc.right, j_betas(3))
    got = t_score(te.codes, te.lengths, tc.left, tc.right, t_betas(3, device=CPU),
                  impl_name="fused-pallas")
    np.testing.assert_array_equal(N(got[0]), N(want[0]))
    np.testing.assert_array_equal(N(got[1]), N(want[1]))


def test_cpu_engine_never_launches_kernels(worlds):
    tb, tf, _, _ = worlds["h3"]
    tkernel.lcs_kernel.launches = tfused.fused_gather_score.launches = 0
    for impl in ("kernel", "pallas", "fused", "fused-pallas"):
        AnotherMeEngine(tf, EngineConfig(lcs_impl=impl), device=CPU).run(tb)
    assert tkernel.lcs_kernel.launches == 0
    assert tfused.fused_gather_score.launches == 0


# ---------------------------------------------------------------------------
# typed errors and guards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan,config", [
    (ExecutionPlan(n_shards=2, devices=(CPU, CPU)), EngineConfig()),
    (ExecutionPlan(autotune=True), EngineConfig()),
    (ExecutionPlan(n_shards=2, delta_join="device", devices=(CPU, CPU)), EngineConfig()),
    (ExecutionPlan(n_shards=2, score_mode="shuffle", overlap_chunks=2, devices=(CPU, CPU)),
     EngineConfig()),
    (ExecutionPlan(n_shards=2, devices=(CPU, CPU)), EngineConfig(subtraj_window=4)),
])
def test_unported_features_raise_typed_errors(plan, config):
    """What the JAX engine runs either runs here too (the sharded plans:
    the one-shard engine's similar pairs and communities) or raises a
    typed error (autotuning)."""
    batch, forest = fig1_world(device=CPU)
    config = dataclasses.replace(config, rho=3.0)
    if plan.autotune:
        with pytest.raises(NotPortedError):
            AnotherMeEngine(forest, config, plan, device=CPU)
        return
    got = AnotherMeEngine(forest, config, plan, device=CPU).run(batch)
    want = AnotherMeEngine(forest, config, device=CPU).run(batch)
    assert got.similar_pairs == want.similar_pairs and got.communities == want.communities
    assert got.stats["shard_plan"]["n_shards"] == 2


def test_registry_and_option_errors():
    assert available_backends() == ("brp", "minhash", "ssh", "udf")
    with pytest.raises(ValueError, match=r"registered backends: \['brp', 'minhash', 'ssh', 'udf'\]"):
        get_backend("lsh-forest")
    with pytest.raises(NotPortedError):
        CapacityPlanner(autotune=True)
    assert CapacityPlanner().plan_tuning(1024, 3, 10) is None
    _, forest = fig1_world(device=CPU)
    with pytest.raises(ValueError, match="unknown lcs_impl"):
        AnotherMeEngine(forest, EngineConfig(lcs_impl="nope"), device=CPU)
    with pytest.raises(ValueError, match="n_shards"):
        AnotherMeEngine(forest, EngineConfig(), ExecutionPlan(n_shards=0), device=CPU)
    with pytest.raises(ValueError, match="table-indexed"):
        lcs_impl_fn("fused")
    batch, forest = fig1_world(device=CPU)
    eng = AnotherMeEngine(forest, EngineConfig(community_mode="bogus"), device=CPU)
    with pytest.raises(ValueError, match="community_mode"):
        eng.run(batch)


def test_plan_override_and_pairwise_impls():
    batch, forest = fig1_world(device=CPU)
    eng = AnotherMeEngine(forest, EngineConfig(rho=3.0), ExecutionPlan(lcs_impl="ref"), device=CPU)
    assert eng.config.lcs_impl == "ref"
    assert (0, 1) in eng.run(batch).similar_pairs
    a = torch.tensor([[1, 2, 3, -1]], dtype=torch.int32)
    b = torch.tensor([[2, 3, -2, -2]], dtype=torch.int32)
    for name in ("wavefront", "ref", "kernel", "pallas", "pallas-interpret"):
        assert lcs_impl_fn(name)(a, b).tolist() == lcs_wavefront(a, b).tolist() == [2]


def test_capacity_planner_policies_match_jax():
    from repro.api import CapacityPlanner as JPlanner

    tp, jp = CapacityPlanner(), JPlanner()
    for n in (0, 1, 900, 1000, 5000, 10**6):
        assert tp.initial_capacity(n) == jp.initial_capacity(n)
        assert tp.update_capacity(n) == jp.update_capacity(n)
        assert tp.grow_capacity(16, n) == jp.grow_capacity(16, n)


def test_batch_on_another_device_is_refused():
    batch, forest = fig1_world(device=CPU)
    eng = AnotherMeEngine(forest, device=CPU)
    eng.device = torch.device("meta")
    with pytest.raises(ValueError, match="engine on meta"):
        eng.run(batch)
