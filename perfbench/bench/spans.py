"""The program's spans over the device-only traced stretch: the totals of
``repro_torch.core.trace`` taken before that stretch and after it.

A ``program_span`` metric's reader takes :func:`before_stretch` as its own
``before_stretch(run)`` and reads :func:`device_ms` in its ``read(run)``.
A span's device time is the stream's time from the device reaching the
span's start to it reaching its end (``trace.totals()``'s ``device_ms``).
Where the program has no tracer (a checkout older than it), where the run
is not on a CUDA device, or where no span of the name closed in the
stretch, there is nothing to read: :func:`device_ms` returns None.
"""
from __future__ import annotations

import importlib


def _tracer():
    try:
        return importlib.import_module("repro_torch.core.trace")
    except ImportError:
        return None


def before_stretch(run) -> None:
    """Keep the program's span totals on ``run`` (CUDA runs only)."""
    tracer = _tracer()
    run.span_totals = tracer.totals() if tracer is not None and run.device.type == "cuda" else None


def stretch_totals(run):
    """``{path: {"calls", "device_ms", "self_device_ms", "host_ms"}}`` of
    the spans that closed after :func:`before_stretch`, or None."""
    before = getattr(run, "span_totals", None)
    tracer = _tracer()
    if before is None or tracer is None or run.trace is None:
        return None
    out = {}
    for path, after in tracer.totals().items():
        was = before.get(path)
        delta = {k: v - (was[k] if was else 0) for k, v in after.items()}
        if delta["calls"]:
            out[path] = delta
    return out


def matches(path: str, name: str, under: str | None = None) -> bool:
    """Whether ``path`` is a span named ``name`` that no span of that name
    holds (so nested ones count once), inside a span named ``under`` where
    one is given."""
    *outer, last = path.split("/")
    return last == name and name not in outer and (under is None or under in outer)


def device_ms(run, name: str, under: str | None = None):
    """Device milliseconds of the spans named ``name`` (inside ``under``)
    in the stretch, or None where there is nothing to read."""
    totals = stretch_totals(run)
    if totals is None:
        return None
    found = [t["device_ms"] for path, t in totals.items() if matches(path, name, under)]
    return sum(found) if found else None
