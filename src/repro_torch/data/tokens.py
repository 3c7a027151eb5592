"""LM token data pipeline with SSH near-duplicate detection (the paper's
technique as a first-class training-data feature).

The bridge: a token sequence IS a semantic trajectory.  We take W anchor
tokens per document (uniform stride), map them through a 3-level vocabulary
hierarchy (token -> cluster -> supercluster, mirroring name -> class ->
type), and run the exact AnotherMe pipeline: k-sequential shingling at the
coarsest level, SSH join, multi-level LCS similarity, communities.  Each
community of near-duplicate documents is downsampled to one representative
— shingle-based dedup as used for LM corpora, but ORDER- and
REPETITION-aware, which plain MinHash dedup is not (paper section IV.2).

Batches are deterministic in (step, shard): restarts and elastic resizes
replay the exact stream (fault-tolerance requirement).

Port of ``repro/data/tokens.py``: the hierarchy, anchors and corpus are the
same numpy arrays; ``ssh_dedup`` runs the port's ``run_anotherme`` on
``device`` with the JAX package's configuration (the default "wavefront"
scorer, connected components), and ``TokenDataset`` hands its batches out
as int32 tensors on its device (None: the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import SemanticForest
from repro_torch.core.pipeline import AnotherMeConfig, run_anotherme
from repro_torch.interop import batch_from_numpy


def vocab_forest(vocab_size: int, *, num_types: int = 300,
                 classes_per_type: int = 10) -> SemanticForest:
    # 300 types (the paper's scalability setting): with W=16 anchors the
    # SSH collision rate C(16,3)/300^3 ~ 2e-5 keeps random-doc candidate
    # pairs near-linear while near-duplicates still share ~all shingles
    """Deterministic 3-level hierarchy over the token vocabulary.

    name level = min(vocab, 10k) hash buckets of token ids; class/type by
    modular fold.  (A production system would plug in k-means over
    embeddings; the pipeline only needs SOME consistent hierarchy.)
    """
    num_names = min(vocab_size, 10_000)
    n_classes = num_types * classes_per_type
    name_to_class = (
        np.arange(num_names, dtype=np.int64) * 2654435761 % n_classes
    ).astype(np.int32)
    class_to_type = (np.arange(n_classes, dtype=np.int32) % num_types).astype(np.int32)
    # ensure surjectivity at each level
    name_to_class[:n_classes] = np.arange(n_classes)
    class_to_type[:num_types] = np.arange(num_types)
    return SemanticForest(
        parents=(class_to_type, name_to_class),
        sizes=(num_types, n_classes, num_names),
    )


def anchors(corpus: np.ndarray, num_anchors: int = 16) -> np.ndarray:
    """[N, S] token docs -> [N, W] anchor tokens (uniform stride)."""
    n, s = corpus.shape
    idx = np.linspace(0, s - 1, num_anchors).astype(np.int64)
    return corpus[:, idx]


@dataclasses.dataclass
class DedupStats:
    num_docs: int
    num_similar_pairs: int
    num_communities: int
    num_dropped: int


def ssh_dedup(
    corpus: np.ndarray,
    *,
    vocab_size: int,
    num_anchors: int = 16,
    rho: float = 8.0,
    k: int = 3,
    device=None,
) -> tuple[np.ndarray, DedupStats]:
    """Returns (keep_mask [N] bool numpy, stats).  rho is on the 0..W MSS
    scale; the pipeline runs on ``device`` (None: the card)."""
    forest = vocab_forest(vocab_size)
    a = anchors(corpus, num_anchors)
    num_names = forest.sizes[-1]
    places = (a % num_names).astype(np.int32)
    n, w = places.shape
    batch = batch_from_numpy(places, np.full((n,), w, np.int32), device=device)
    res = run_anotherme(
        batch, forest,
        AnotherMeConfig(k=k, rho=rho, community_mode="components"),
    )
    keep = np.ones(n, bool)
    dropped = 0
    for comm in res.communities:
        members = sorted(comm)
        for m in members[1:]:
            keep[m] = False
            dropped += 1
    return keep, DedupStats(
        num_docs=n,
        num_similar_pairs=len(res.similar_pairs),
        num_communities=len(res.communities),
        num_dropped=dropped,
    )


def synthetic_corpus(
    num_docs: int, seq_len: int, vocab_size: int, *,
    dup_fraction: float = 0.2, edit_prob: float = 0.05, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Docs with planted near-duplicates.  Returns (corpus, dup_source):
    dup_source[i] = j if doc i is a near-copy of doc j else -1."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, vocab_size, size=(num_docs, seq_len)).astype(np.int32)
    dup_source = np.full(num_docs, -1, np.int64)
    n_dup = int(num_docs * dup_fraction)
    originals = rng.integers(0, max(1, num_docs - n_dup), size=n_dup)
    for i, src in enumerate(originals):
        tgt = num_docs - n_dup + i
        doc = corpus[src].copy()
        edits = rng.random(seq_len) < edit_prob
        doc[edits] = rng.integers(0, vocab_size, size=edits.sum())
        corpus[tgt] = doc
        dup_source[tgt] = src
    return corpus, dup_source


class TokenDataset:
    """Deterministic sharded batch stream over a (deduped) corpus; batches
    are int32 tensors on ``device`` (None: the card)."""

    def __init__(self, corpus: np.ndarray, *, global_batch: int,
                 n_shards: int = 1, shard: int = 0, seed: int = 0, device=None):
        if global_batch % n_shards:
            raise ValueError(
                f"global_batch {global_batch} does not split into {n_shards} shards"
            )
        self.device = resolve_device(device)
        self.corpus = corpus
        self.global_batch = global_batch
        self.n_shards = n_shards
        self.shard = shard
        self.seed = seed

    def batch(self, step: int) -> dict:
        """{tokens, labels} for this shard at this step (replayable)."""
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.corpus.shape[0], size=self.global_batch)
        per = self.global_batch // self.n_shards
        mine = idx[self.shard * per : (self.shard + 1) * per]
        docs = self.corpus[mine]
        return {
            "tokens": torch.as_tensor(docs[:, :-1].astype(np.int32), device=self.device),
            "labels": torch.as_tensor(docs[:, 1:].astype(np.int32), device=self.device),
        }
