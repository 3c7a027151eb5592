"""Straggler detection & mitigation hooks (host-side).

A copy of ``repro/train/straggler.py``: host Python, no arrays.

At 1000+ nodes the common failure mode is not a crash but a slow host
(thermal throttle, ECC retries, network degradation).  The watchdog keeps a
robust running estimate of step time (median + MAD) and flags steps (or
per-host heartbeats) that exceed ``threshold`` deviations.  Mitigation is
policy-driven via callbacks:

  * "log"       — record the event (always on)
  * "checkpoint"— force an early async checkpoint so a kill/reschedule of
                  the slow host loses no work
  * "evict"     — signal the caller to rebuild the mesh without the host
                  (elastic resume path; exercised in tests by resharding a
                  checkpoint onto a smaller device count)

The per-host heartbeat API mirrors what a real multi-controller deployment
reports; the single-process environment feeds it synthetic timings in
tests.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    duration: float
    median: float
    mad: float


class StragglerWatchdog:
    def __init__(self, window: int = 32, threshold: float = 5.0,
                 on_event: Callable[[StragglerEvent], None] | None = None):
        self.window = window
        self.threshold = threshold
        self.on_event = on_event
        self._durations: collections.deque = collections.deque(maxlen=window)
        self._host_durations: dict[int, collections.deque] = {}
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    # --- step timing (single-controller view) ---------------------------
    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> bool:
        assert self._t0 is not None
        dur = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, 0, dur)

    # --- generic observation (per-host heartbeats) -----------------------
    def observe(self, step: int, host: int, duration: float) -> bool:
        dq = self._host_durations.setdefault(host, collections.deque(maxlen=self.window))
        flagged = False
        if len(dq) >= 8:
            med = _median(dq)
            mad = _median([abs(d - med) for d in dq]) or med * 0.05 or 1e-3
            if duration > med + self.threshold * mad:
                ev = StragglerEvent(step, host, duration, med, mad)
                self.events.append(ev)
                if self.on_event:
                    self.on_event(ev)
                flagged = True
        dq.append(duration)
        self._durations.append(duration)
        return flagged

    def slowest_hosts(self, k: int = 3) -> list[tuple[int, float]]:
        meds = {
            h: _median(dq) for h, dq in self._host_durations.items() if dq
        }
        return sorted(meds.items(), key=lambda kv: -kv[1])[:k]


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
