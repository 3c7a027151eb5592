"""Phase (iv): communities of common interest + the paper's QA metrics.

The centralized oracle (paper section V.1) forms **maximal cliques** over the
similarity graph (edges = pairs with MSS > rho): Bron-Kerbosch with pivoting
on the host.  The scalable path is **connected components** via min-label
propagation with pointer jumping on tensors; accuracy experiments (QA1) use
the clique definition on both sides, exactly as the paper does.

QA1 = |communities_dis ∩ communities_cen| / |communities_cen|   (Eq. 2)
QA2 = |pairs_dis ∩ pairs_cen| / |pairs_cen|                      (Eq. 3)
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.device import to_numpy as _np
from repro_torch.core.types import PAD_ID


# ---------------------------------------------------------------------------
# scalable path: connected components on tensors
# ---------------------------------------------------------------------------
def connected_components(
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    num_nodes: int,
    max_iters: int = 64,
    init_labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Min-label propagation over an edge list (PAD_ID edges ignored).

    Returns int32 [num_nodes] component labels (the min node id reachable).
    Convergence in O(diameter) rounds, accelerated by pointer jumping; the
    loop exits early on fixpoint.

    ``init_labels`` (int32 [num_nodes]) warm-starts the propagation.  The
    seed contract: ``init_labels[v]`` must be a node id in ``v``'s component
    under the CURRENT edge list with ``init_labels[v] <= v``; seeds are
    clamped to ``min(init_labels[v], v)`` so an ``arange`` seed is valid.
    """
    dev = left.device
    lo = torch.where(left == PAD_ID, num_nodes, left).long()
    hi = torch.where(right == PAD_ID, num_nodes, right).long()
    labels = torch.arange(num_nodes + 1, dtype=torch.int32, device=dev)
    if init_labels is not None:
        labels[:num_nodes] = torch.minimum(
            init_labels.to(torch.int32), labels[:num_nodes]
        )
    for _ in range(max_iters):
        m = torch.minimum(labels[lo], labels[hi])
        new = labels.scatter_reduce(0, lo, m, "amin").scatter_reduce(0, hi, m, "amin")
        new[num_nodes] = num_nodes
        # pointer jumping: label <- label[label]
        new = torch.minimum(new, new[new.long()])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels[:num_nodes]


def components_as_sets(labels, min_size: int = 2) -> set[frozenset]:
    """Host conversion: labels -> {frozenset(member ids)} of size >= min_size."""
    groups: dict[int, list[int]] = {}
    for node, lab in enumerate(_np(labels).tolist()):
        groups.setdefault(lab, []).append(node)
    return {frozenset(g) for g in groups.values() if len(g) >= min_size}


# ---------------------------------------------------------------------------
# incremental path: union-find over an accumulated edge stream
# ---------------------------------------------------------------------------
class UnionFind:
    """Incremental connected components: union by size + path compression.

    Edges arrive in micro-batches and each ``union`` costs amortized
    ~O(alpha(N)); the labeling after any prefix of unions equals
    ``connected_components`` over the same edge set (canonicalized to
    min-member labels).  Node capacity grows on demand (``add``) with
    amortized-doubling reallocation.
    """

    def __init__(self, num_nodes: int = 0):
        self._parent = np.arange(num_nodes, dtype=np.int64)
        self._size = np.ones(num_nodes, dtype=np.int64)
        self.num_nodes = num_nodes

    def add(self, num_new: int) -> None:
        """Append ``num_new`` fresh singleton nodes."""
        if num_new <= 0:
            return
        n = self.num_nodes + num_new
        if n > self._parent.shape[0]:
            cap = max(16, 1 << int(np.ceil(np.log2(n))))
            parent = np.arange(cap, dtype=np.int64)
            size = np.ones(cap, dtype=np.int64)
            parent[: self.num_nodes] = self._parent[: self.num_nodes]
            size[: self.num_nodes] = self._size[: self.num_nodes]
            self._parent, self._size = parent, size
        self.num_nodes = n

    def find(self, x: int) -> int:
        """Root of ``x`` with path halving (iterative compression)."""
        p = self._parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> bool:
        """Merge the components of ``a`` and ``b``; True if they differed."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self._size[ra] < self._size[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._size[ra] += self._size[rb]
        return True

    def labels(self) -> np.ndarray:
        """Canonical int32 [num_nodes] labels: the MIN member id per
        component — bit-compatible with :func:`connected_components`."""
        n = self.num_nodes
        roots = np.fromiter(
            (self.find(i) for i in range(n)), dtype=np.int64, count=n
        )
        canon = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(canon, roots, np.arange(n, dtype=np.int64))
        return canon[roots].astype(np.int32) if n else np.empty(0, np.int32)

    def components(self, min_size: int = 2) -> set[frozenset]:
        """{frozenset(member ids)} of size >= min_size, like
        :func:`components_as_sets`."""
        return components_as_sets(self.labels(), min_size=min_size)

    def reset_from_labels(self, labels: np.ndarray) -> None:
        """Reinitialize to the partition encoded by min-member ``labels``
        (``labels[v]`` must be the min member of ``v``'s component)."""
        labels = np.asarray(labels, np.int64).reshape(-1)
        n = labels.shape[0]
        cap = max(16, int(2 ** np.ceil(np.log2(max(n, 1)))))
        self._parent = np.arange(cap, dtype=np.int64)
        self._parent[:n] = labels
        self._size = np.ones(cap, dtype=np.int64)
        if n:
            counts = np.bincount(labels, minlength=n)
            roots = np.nonzero(counts)[0]
            self._size[roots] = counts[roots]
        self.num_nodes = n


def components_after_deletion(
    labels: np.ndarray,
    dead: Sequence[int],
    surviving_edges: Iterable[tuple[int, int]],
) -> np.ndarray:
    """Community *un*-merging: re-label after deleting the ``dead`` nodes.

    Deletion can SPLIT a component (expiring the bridge node of a path),
    which no incremental label update discovers.  Only the components that
    CONTAIN a dead node ("touched") are recomputed, from the surviving
    edges restricted to them; untouched components keep their labels.

    labels:          int [n] current min-member labels (nodes 0..n-1).
    dead:            node ids being deleted (they become self-labeled
                     singletons; the caller has already dropped every edge
                     referencing them).
    surviving_edges: the post-deletion edge set (edges inside untouched
                     components are skipped).

    Returns the new int32 [n] min-member labels, equal to a cold
    union-find fixpoint over ``surviving_edges``.
    """
    labels = np.asarray(labels, np.int64).copy()
    dead = np.asarray(sorted(set(int(x) for x in dead)), np.int64)
    if dead.size == 0:
        return labels.astype(np.int32)
    touched = np.unique(labels[dead])
    idx = np.nonzero(np.isin(labels, touched))[0]
    labels[idx] = idx  # touched components dissolve to singletons...
    uf = UnionFind()
    uf.reset_from_labels(labels)
    touched_nodes = set(idx.tolist())
    for a, b in surviving_edges:  # ...and re-form from surviving edges
        if int(a) in touched_nodes or int(b) in touched_nodes:
            uf.union(int(a), int(b))
    return uf.labels()


# ---------------------------------------------------------------------------
# exact oracle: maximal cliques (Bron-Kerbosch with pivoting)
# ---------------------------------------------------------------------------
def maximal_cliques(edges: Iterable[tuple[int, int]], min_size: int = 2) -> set[frozenset]:
    """All maximal cliques of size >= min_size.  Host-side, exact."""
    adj: dict[int, set[int]] = {}
    for a, b in edges:
        if a == b:
            continue
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    cliques: set[frozenset] = set()

    def bk(r: set, p: set, x: set):
        if not p and not x:
            if len(r) >= min_size:
                cliques.add(frozenset(r))
            return
        pivot = max(p | x, key=lambda v: len(adj.get(v, ())), default=None)
        for v in list(p - adj.get(pivot, set())):
            bk(r | {v}, p & adj[v], x & adj[v])
            p.remove(v)
            x.add(v)

    bk(set(), set(adj.keys()), set())
    return cliques


# ---------------------------------------------------------------------------
# paper metrics
# ---------------------------------------------------------------------------
def pairs_to_set(left, right) -> set[tuple[int, int]]:
    left, right = _np(left), _np(right)
    ok = left != PAD_ID
    return {
        (int(min(a, b)), int(max(a, b)))
        for a, b in zip(left[ok].tolist(), right[ok].tolist())
    }


def qa1(communities_dis: set[frozenset], communities_cen: set[frozenset]) -> float:
    """Eq. 2 — fraction of centralized communities recovered."""
    if not communities_cen:
        return 1.0
    return len(communities_dis & communities_cen) / len(communities_cen)


def qa2(pairs_dis: set[tuple], pairs_cen: set[tuple]) -> float:
    """Eq. 3 — fraction of centralized similar pairs recovered."""
    if not pairs_cen:
        return 1.0
    return len(pairs_dis & pairs_cen) / len(pairs_cen)
