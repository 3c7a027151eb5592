"""The port's data pieces against the JAX package's, on the CPU.

The GeoLife surrogate (``data/geolife.py``), the stay-point detector, the
LM corpus tools (``data/tokens.py``: the vocabulary forest, anchors, the
planted-duplicate corpus, SSH dedup and the sharded batch stream), the
paper's collision-rate model and the demo encoding: the same seeds and
numpy inputs through both packages, element for element (tolerance 0).
"""
import numpy as np
import pytest
import torch

import repro.core.encoding as jenc
import repro.core.shingling as jsh
import repro.data as jdata
import repro.data.geolife as jgeo
import repro.data.tokens as jtok
from repro_torch.core import encode_places, expected_collision_rate, forest_tables
from repro_torch.data import fig1_world, geolife as tgeo, geolife_surrogate
from repro_torch.data import tokens as ttok

CPU = "cpu"
VOCAB = 49_155  # granite-3-8b's vocabulary (configs/granite_3_8b.py)


def assert_forest_equal(got, want):
    assert got.sizes == want.sizes
    assert len(got.parents) == len(want.parents)
    for g, w in zip(got.parents, want.parents):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kw", [
    dict(num_users=12, num_traj=300, seed=0),
    dict(num_users=5, num_traj=80, num_pois=400, num_types=20, classes_per_type=5,
         max_len_pad=10, seed=3),
    dict(num_users=8, num_traj=100, seed=1, fast=False),
])
def test_geolife_surrogate_matches_jax(kw):
    tb, tf = geolife_surrogate(**kw, device=CPU)
    jb, jf = jgeo.geolife_surrogate(**kw)
    for field in ("places", "lengths", "user_id"):
        got, want = getattr(tb, field), np.asarray(getattr(jb, field))
        assert got.device.type == "cpu" and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert_forest_equal(tf, jf)
    assert tgeo.EARTH_M_PER_DEG == jgeo.EARTH_M_PER_DEG


def test_stay_points_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        n = int(rng.integers(1, 60))
        xy = np.cumsum(rng.normal(scale=80.0, size=(n, 2)), axis=0)
        t = np.cumsum(rng.uniform(100.0, 900.0, size=n))
        for kw in ({}, dict(dist_thresh=120.0, time_thresh=600.0)):
            got = tgeo._stay_points(xy, t, **kw)
            want = jgeo._stay_points(xy, t, **kw)
            assert got.shape == want.shape and got.shape[1] == 2
            np.testing.assert_array_equal(got, want)


def test_vocab_forest_and_anchors_match_jax():
    for vocab in (3_000, VOCAB):
        assert_forest_equal(ttok.vocab_forest(vocab), jtok.vocab_forest(vocab))
    corpus = np.random.default_rng(2).integers(0, VOCAB, size=(7, 100)).astype(np.int32)
    for w in (16, 5):
        np.testing.assert_array_equal(ttok.anchors(corpus, w), jtok.anchors(corpus, w))


def test_synthetic_corpus_matches_jax():
    for args, kw in (((200, 64, VOCAB), dict(seed=0)),
                     ((51, 33, 5_000), dict(dup_fraction=0.4, edit_prob=0.1, seed=9))):
        got, want = ttok.synthetic_corpus(*args, **kw), jtok.synthetic_corpus(*args, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_ssh_dedup_matches_jax():
    corpus, dup = ttok.synthetic_corpus(300, 128, VOCAB, seed=0)
    keep, stats = ttok.ssh_dedup(corpus, vocab_size=VOCAB, device=CPU)
    jkeep, jstats = jtok.ssh_dedup(corpus, vocab_size=VOCAB)
    assert keep.dtype == np.bool_
    np.testing.assert_array_equal(keep, jkeep)
    assert stats == ttok.DedupStats(**vars(jstats))
    assert stats.num_dropped == int((~keep).sum()) > 0
    planted = dup >= 0
    # a dropped document is a near-copy the corpus planted
    assert (~keep)[~planted].sum() <= (~keep)[planted].sum()


def test_token_dataset_matches_jax():
    corpus, _ = ttok.synthetic_corpus(64, 17, 5_000, seed=4)
    whole = ttok.TokenDataset(corpus, global_batch=8, seed=3, device=CPU)
    for step in (0, 5):
        b = whole.batch(step)
        jb = jtok.TokenDataset(corpus, global_batch=8, seed=3).batch(step)
        for key in ("tokens", "labels"):
            assert b[key].dtype == torch.int32 and b[key].shape == (8, 16)
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(jb[key]))
            # replayable: the same step gives the same batch
            assert torch.equal(whole.batch(step)[key], b[key])
        shards = [ttok.TokenDataset(corpus, global_batch=8, n_shards=2, shard=s, seed=3,
                                    device=CPU).batch(step) for s in (0, 1)]
        for key in ("tokens", "labels"):
            assert torch.equal(torch.cat([s[key] for s in shards]), b[key])
    assert not torch.equal(whole.batch(0)["tokens"], whole.batch(1)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        ttok.TokenDataset(corpus, global_batch=7, n_shards=2, device=CPU)


def test_expected_collision_rate_matches_jax():
    for avg_len, k, q in ((16, 3, 300), (7.5, 3, 30), (10, 2, 300), (5, 5, 10), (2, 3, 30)):
        assert expected_collision_rate(avg_len, k, q) == jsh.expected_collision_rate(avg_len, k, q)


def test_encode_places_matches_jax():
    batch, forest = fig1_world(device=CPU)
    _, jforest = jdata.fig1_world()
    tables = forest_tables(forest, device=CPU)
    ids = list(range(tables.shape[1])) + batch.places[0, :3].tolist()
    want = jenc.encode_places(ids, jenc.forest_tables(jforest))
    assert encode_places(ids, tables) == want
    assert encode_places(ids, tables.numpy()) == want
