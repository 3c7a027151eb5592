"""A traced stretch of a run: ``torch.profiler`` over it, its device
activity read back from the Chrome trace.

:func:`traced` runs a function under the profiler inside a
``record_function("harness")`` span, exports the trace into a temporary
directory and returns a :class:`Trace`: the device's kernels, copies and
fills as intervals, and with ``host=True`` the host's spans (the
harness's ``record_function`` labels and the torch operators) too.  The
profiler's recording of the host's operators slows the host by a second
or so a training step, so a run traces twice: host and device, whose
idle gaps are labelled by what the host was doing, and then the device's
activity alone, which the device metrics read (the window is then the
host clock's across the stretch).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's own spans, innermost first when nested
HARNESS = "harness"


@dataclasses.dataclass
class Trace:
    window: tuple | None           # (start, end) of the harness span, in the trace's microseconds
    device: list                   # (start, end, name) of every device activity
    spans: list                    # (start, end, name) of the user annotations
    ops: list                      # (start, end, name) of the host's torch operators
    wall_s: float                  # host clock across the traced stretch, after a sync

    @property
    def window_s(self) -> float:
        """The traced stretch's length: the harness span's where the host
        was traced, else the host clock's."""
        return self.wall_s if self.window is None else (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device's activity (inside the window, where
        there is one), as sorted disjoint (start, end)."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        out = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def span_seconds(self, name: str) -> float:
        """Host seconds of the ``record_function`` spans named ``name``."""
        return sum(e - s for s, e, n in self.spans if n == name) / 1e6

    def seconds_by_name(self) -> dict:
        """Device seconds of each kernel (copy, fill) name."""
        out: dict = {}
        for s, e, name in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the activities whose lowercased name holds one
        of ``patterns``."""
        pats = [p.lower() for p in patterns]
        return sum(sec for name, sec in self.seconds_by_name().items()
                   if any(p in name.lower() for p in pats))

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with nothing on the
        device (a trace of the host's activity only)."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost harness span
        and, inside it, the innermost torch operator, as ``span/op``."""
        span = _innermost(self.spans, t) or HARNESS
        op = _innermost(self.ops, t)
        return f"{span}/{op}" if op else span

    def idle_by_label(self) -> dict:
        """Idle seconds summed by :meth:`host_label` at each gap's start."""
        out: dict = {}
        for s, e in self.idle_gaps():
            label = self.host_label(s)
            out[label] = out.get(label, 0.0) + (e - s) / 1e6
        return out



def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` entries of ``{name: seconds}`` with the most seconds, as
    [name, seconds] pairs, each name cut to ``width`` characters."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(intervals: list, t: float):
    """The name of the shortest interval of ``intervals`` (sorted by start)
    that holds ``t``."""
    best = None
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    # intervals holding t start at or before it; look back over the nest
    for s, e, name in reversed(intervals[max(0, i - 64):i + 1]):
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def traced(fn, device, host: bool) -> Trace:
    """Run ``fn`` once under ``torch.profiler`` and read the trace back:
    the device's activity on a CUDA ``device``, and the host's with
    ``host`` (on the CPU, a rehearsal, the host's alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(HARNESS):
            fn()
            sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    del prof
    return parse(events, wall)


def parse(events: list, wall_s: float) -> Trace:
    """A :class:`Trace` from Chrome trace events; the window is the
    outermost ``harness`` span, where the host was traced."""
    device, spans, ops = [], [], []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((s, e, name))
        elif cat == "user_annotation":
            spans.append((s, e, name))
            if name == HARNESS and (window is None or e - s > window[1] - window[0]):
                window = (s, e)
        elif cat == "cpu_op":
            ops.append((s, e, name))
    spans = sorted(sp for sp in spans if sp[2] != HARNESS)
    return Trace(window=window, device=device, spans=spans, ops=sorted(ops), wall_s=wall_s)
