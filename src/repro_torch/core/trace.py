"""Spans inside the port: named stretches of the program, timed on the
device and placed on ``torch.profiler``'s clock.

    from repro_torch.core import trace

    with trace.span("attention"):
        ...

A span is on while a ``torch.profiler`` session is active (whatever its
activities) or after :func:`enable`, and off otherwise.  Off, ``span``
returns one shared ``contextlib.nullcontext`` and records nothing.  On, it
opens ``torch.profiler.record_function(name)``, so the span lands in the
profiler's trace on the clock that trace gives the kernels, and where CUDA
is available it records a pair of timing events around the span on the
current stream of the recording thread's current card.  The events come
from a pool of that card's events and are read back when :func:`totals`
is called, or, without waiting, once a span's end has completed on the
device, so the pairs left to read stay few.  A thread that drives several
cards without making each current in turn (the meshes of
``core/compat.py``) times the current card's stream alone.

Each thread keeps its own stack of open spans.  A thread with none open
nests its spans under the main thread's innermost open span: the autograd
engine's device threads, one a card, run the backwards while the main
thread waits in ``torch.autograd.grad``, so a span opened in a backward
has the span around that call as its parent.

:func:`totals` is keyed by a span's path, the open names outermost first
joined with ``/``.  Each entry has ``calls``; ``device_ms``, the stream's
time from the device reaching the span's start to it reaching its end
(the device's idle inside the span included; where CUDA is not available
the host is the device, and this is the host's time); ``self_device_ms``,
that less its child spans'; and ``host_ms``, the host clock across the
span.  Totals are cumulative from the process's start; reading them
changes nothing.  The profiler's Chrome trace is the only exporter.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()
# pairs of events waiting to be read before the oldest are looked at
_PENDING_LOOK = 256


def _current_stream(streams: dict):
    """(card index, the current stream of the calling thread's current
    card), the stream cached in ``streams``: ``torch.cuda.current_stream()``
    builds a new one at every call, which costs a span more than the rest
    of it under a profiler."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = streams.get(key)
    if stream is None:
        stream = streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return key[1], stream


def _new_event():
    return torch.cuda.Event(enable_timing=True)


class _Tracer:
    """The process's span state (one instance, :data:`_TRACER`)."""

    def __init__(self) -> None:
        self.enabled = False
        self.main: list = []           # the main thread's open spans' paths, outermost first
        self.local = threading.local()
        self.lock = threading.Lock()
        # path -> [calls, device_ms, self_device_ms, host_ms]
        self.totals: dict = {}
        # (path, parent path, card, start event, end event), in order of the end's record
        self.pending: collections.deque = collections.deque()
        self.pool: dict = {}           # card -> its events read back
        self.cuda: bool | None = None
        self.streams: dict = {}        # (stream id, card, device type) -> its torch.cuda.Stream

    def stack(self) -> list:
        """The calling thread's open spans."""
        try:
            return self.local.stack
        except AttributeError:
            main = threading.current_thread() is threading.main_thread()
            self.local.stack = self.main if main else []
            return self.local.stack

    def event(self):
        """(card, a timing event of that card recorded on the current stream
        of the thread's current card), or None without CUDA."""
        if self.cuda is None:
            self.cuda = torch.cuda.is_available()
        if not self.cuda:
            return None
        dev, stream = _current_stream(self.streams)
        with self.lock:
            pool = self.pool.get(dev)
            ev = pool.pop() if pool else _new_event()
        ev.record(stream)
        return dev, ev

    def entry(self, path: str) -> list:
        t = self.totals.get(path)
        if t is None:
            t = self.totals[path] = [0, 0.0, 0.0, 0.0]
        return t

    def add_device(self, path: str, parent, ms: float) -> None:
        t = self.entry(path)
        t[1] += ms
        t[2] += ms
        if parent is not None:
            self.entry(parent)[2] -= ms

    def close(self, path: str, parent, host_ms: float, start, end) -> None:
        with self.lock:
            t = self.entry(path)
            t[0] += 1
            t[3] += host_ms
            if start is None:
                self.add_device(path, parent, host_ms)
                return
            self.pending.append((path, parent, start[0], start[1], end[1]))
            if len(self.pending) >= _PENDING_LOOK:
                self.read_pending(wait=False)

    def read_pending(self, wait: bool) -> None:
        """Read the pending pairs, oldest first: all of them with ``wait``,
        else those whose events have completed (``self.lock`` held)."""
        while self.pending:
            path, parent, card, start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not (end.query() and start.query()):
                return
            self.pending.popleft()
            self.add_device(path, parent, start.elapsed_time(end))
            self.pool.setdefault(card, []).extend((start, end))


_TRACER = _Tracer()


class _Span:
    __slots__ = ("name", "rf", "stack", "path", "parent", "start", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        tr = _TRACER
        self.stack = stack = tr.stack()
        outer = stack or tr.main
        self.parent = outer[-1] if outer else None
        self.path = self.name if self.parent is None else f"{self.parent}/{self.name}"
        stack.append(self.path)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = tr.event()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tr = _TRACER
        host_ms = 1e3 * (time.perf_counter() - self.t0)
        end = None if self.start is None else tr.event()
        self.rf.__exit__(*exc)
        self.stack.pop()
        tr.close(self.path, self.parent, host_ms, self.start, end)
        return False


def span(name: str):
    """A context manager around the stretch named ``name`` (the module
    docstring); the shared null context while spans are off."""
    if _TRACER.enabled or torch.autograd._profiler_enabled():
        return _Span(name)
    return _OFF


def enable() -> None:
    """Record spans without a profiler session, until :func:`disable`."""
    _TRACER.enabled = True


def disable() -> None:
    """Record spans only under a profiler session again."""
    _TRACER.enabled = False


def totals() -> dict:
    """``{path: {"calls", "device_ms", "self_device_ms", "host_ms"}}`` of
    every span closed so far (waits for the device to reach the last
    span's end)."""
    with _TRACER.lock:
        _TRACER.read_pending(wait=True)
        return {path: {"calls": c, "device_ms": d, "self_device_ms": s, "host_ms": h}
                for path, (c, d, s, h) in _TRACER.totals.items()}


@contextlib.contextmanager
def counting():
    """Spans on for the block (as :func:`enable`); yields a dict that, once
    the block has closed, holds the calls of each span path closed in it."""
    before = {p: t["calls"] for p, t in totals().items()}
    was, _TRACER.enabled = _TRACER.enabled, True
    got: dict = {}
    try:
        yield got
    finally:
        _TRACER.enabled = was
        for p, t in totals().items():
            if t["calls"] != before.get(p, 0):
                got[p] = t["calls"] - before.get(p, 0)


def calls(counts: dict, name: str, under: str | None = None) -> int:
    """Calls of the spans named ``name`` (inside a span named ``under``,
    where one is given) in ``counts``, a :func:`counting` dict."""
    return sum(c for p, c in counts.items()
               if p.split("/")[-1] == name and (under is None or under in p.split("/")[:-1]))
