"""Phase timing/stats collection, separated from phase logic.

The stages call ``repro_torch.core.device.synchronize`` on their outputs
before a phase ends, so these host-clock times include the card's work.

Stats key conventions (the JAX engine's):

  t_encode       phase (i)   semantic encoding
  t_keys         phase (ii)a join-key construction (shingles)
  t_join         phase (ii)b sort-merge join + dedup (+ overflow retries)
  t_candidates   t_keys + t_join
  t_prune        MSS upper-bound pruning (only with score_prune)
  t_score        phase (iii) similarity scoring
  t_aggregate    subtrajectory mode only: the host fold of scored window
                 pairs to trajectory pairs and the ``mss > rho`` set
  t_communities  phase (iv)  community detection
  t_total        sum of every t_* phase above
  t_shingle      legacy alias of t_keys

Sharded runs fuse the join and score phases into one program; they record
``t_plan`` (host capacity planning) and ``t_execute`` (the sharded program)
instead of ``t_join``/``t_score``, and ``t_candidates`` then covers keys +
plan + execute (``t_score`` reads 0.0: the score cost is inside
``t_execute``).
"""
from __future__ import annotations

import contextlib
import time

from repro_torch.core import trace


class Instrumentation:
    """Collects per-phase wall times and scalar stats for one run."""

    def __init__(self) -> None:
        self.stats: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase; re-entering the same name accumulates.  The phase
        is also a span named ``name`` (``core/trace.py``), so it shows in
        the profiler's traces."""
        t0 = time.perf_counter()
        try:
            with trace.span(name):
                yield
        finally:
            key = f"t_{name}"
            self.stats[key] = self.stats.get(key, 0.0) + time.perf_counter() - t0

    def record(self, **values) -> None:
        self.stats.update(values)

    def finalize(self) -> dict:
        """Derive the composite keys and return the stats dict."""
        s = self.stats
        s.setdefault("t_keys", 0.0)
        if "t_join" in s:
            s["t_candidates"] = s["t_keys"] + s["t_join"]
        elif "t_execute" in s:  # sharded: join+score fused into one program
            s["t_candidates"] = s["t_keys"] + s.get("t_plan", 0.0) + s["t_execute"]
            s.setdefault("t_score", 0.0)
        s["t_shingle"] = s["t_keys"]  # legacy alias
        s["t_total"] = sum(
            v for k, v in s.items()
            if k.startswith("t_") and k not in ("t_total", "t_candidates", "t_shingle")
        )
        return s
