"""The port's spans (``repro_torch.core.trace``): off and on, their paths,
parents and self time, their place in the profiler's trace, where the LM
path opens them, and that they change no output; each card's events and
each thread's nesting kept apart, on stand-ins for two cards.  The ``cuda``
cases hold a span's device time against CUDA events placed by hand and,
with two cards, run #6's backward and a mesh's train step across them
(run on the H100 with ``-m cuda``)."""
import contextlib
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api.instrumentation import Instrumentation
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import trace
from repro_torch.launch.inputs import make_inputs
from repro_torch.models.model import init_params
from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache
from repro_torch.train.optimizer import OptConfig, leaves
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------
def test_off_returns_the_shared_null_context_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("x"), trace.span("y")
    assert a is b and isinstance(a, contextlib.nullcontext)
    before = trace.totals()
    with trace.span("off.only"):
        pass
    assert trace.totals() == before


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_on_under_a_profiler_session_or_after_enable(how):
    before = trace.totals()
    session = profile(activities=[ProfilerActivity.CPU]) if how == "profiler" else contextlib.nullcontext()
    if how == "enable":
        trace.enable()
    try:
        with session:
            s = trace.span(f"on.{how}")
            assert not isinstance(s, contextlib.nullcontext)
            with s:
                pass
    finally:
        trace.disable()
    after = trace.totals()
    assert {p: t["calls"] for p, t in after.items() if t != before.get(p)} == {f"on.{how}": 1}
    assert isinstance(trace.span("x"), contextlib.nullcontext)


def test_paths_parents_and_self_time_of_nested_spans():
    before = trace.totals()
    with trace.counting() as d:
        for _ in range(2):
            with trace.span("outer"):
                time.sleep(0.02)
                with trace.span("inner"):
                    time.sleep(0.03)
                with trace.span("other"):
                    with trace.span("inner"):
                        time.sleep(0.01)
    after = trace.totals()
    assert d == {"outer": 2, "outer/inner": 2, "outer/other": 2, "outer/other/inner": 2}

    def grew(path, key):
        return after[path][key] - before.get(path, {key: 0.0})[key]

    # a parent's self time is its time less its children's (not its grandchildren's)
    assert grew("outer", "self_device_ms") == pytest.approx(
        grew("outer", "device_ms") - grew("outer/inner", "device_ms") - grew("outer/other", "device_ms"))
    assert grew("outer/other", "self_device_ms") == pytest.approx(
        grew("outer/other", "device_ms") - grew("outer/other/inner", "device_ms"))
    assert grew("outer", "host_ms") >= 2 * 60.0
    if not torch.cuda.is_available():
        # the host is the device
        for path in ("outer", "outer/inner", "outer/other/inner"):
            assert grew(path, "device_ms") == grew(path, "host_ms")
        assert grew("outer", "self_device_ms") >= 2 * 20.0 - 1e-6


def test_totals_are_a_snapshot():
    with trace.counting():
        with trace.span("snap"):
            pass
    t = trace.totals()
    t["snap"]["calls"] = -1
    t.pop("snap")
    assert trace.totals()["snap"]["calls"] >= 1


def test_an_exception_closes_the_span():
    with trace.counting() as d:
        with pytest.raises(ValueError):
            with trace.span("raises"):
                raise ValueError("out")
        with trace.span("after"):
            pass
    assert d == {"raises": 1, "after": 1}


class _Card:
    """Stand-ins for the CUDA calls of the tracer, two cards and a current
    card for each thread: an event takes the card of the stream it is
    first recorded on and refuses another's, as a CUDA event does."""

    def __init__(self, monkeypatch):
        self.current = threading.local()
        self.recorded = []   # (event's card, stream's card)
        monkeypatch.setattr(trace, "_TRACER", trace._Tracer())
        trace._TRACER.cuda = True
        monkeypatch.setattr(trace, "_current_stream", lambda streams: (self.card(), self.card()))
        monkeypatch.setattr(trace, "_new_event", lambda: _Card.Event(self))

    def card(self) -> int:
        return getattr(self.current, "card", 0)

    class Event:
        def __init__(self, cards):
            self.cards, self.on, self.t = cards, None, None

        def record(self, stream):
            self.on = stream if self.on is None else self.on
            self.cards.recorded.append((self.on, stream))
            if self.on != stream:
                raise RuntimeError(f"Event device {self.on} does not match recording stream's device {stream}")
            self.t = time.perf_counter()

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)


def _on_card(cards, card, fn):
    """Run ``fn`` in a thread of its own whose current card is ``card``, as
    the autograd engine runs a card's backwards."""
    failed = []

    def run():
        cards.current.card = card
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - handed back to the test
            failed.append(e)

    t = threading.Thread(target=run)
    t.start()
    return t, failed


def test_each_card_records_its_own_events(monkeypatch):
    """Spans on card 0, their events read back into the pool, then spans
    on card 1's thread under the main thread's open span: no event of one
    card is recorded on the other's stream."""
    cards = _Card(monkeypatch)

    def backward():
        for _ in range(4):
            with trace.span("bwd"):
                pass

    with trace.counting() as d:
        with trace.span("step"):
            for _ in range(3):
                with trace.span("fwd"):
                    pass
            trace.totals()   # card 0's events back in the pool
            with trace.span("backward"):
                t, failed = _on_card(cards, 1, backward)
                t.join()
            with trace.span("fwd"):
                pass
    assert not failed, failed
    assert all(ev == stream for ev, stream in cards.recorded)
    assert {stream for _, stream in cards.recorded} == {0, 1}
    assert d == {"step": 1, "step/fwd": 4, "step/backward": 1, "step/backward/bwd": 4}
    assert set(trace._TRACER.pool) == {0, 1}


def test_threads_nest_their_spans_apart(monkeypatch):
    """Two cards' threads open nested spans at once: each nests under its
    own spans, and its outermost under the main thread's open span."""
    cards = _Card(monkeypatch)
    both = threading.Barrier(2)

    def backward(name):
        def run():
            for _ in range(3):
                with trace.span(name):
                    both.wait()
                    with trace.span("inner"):
                        both.wait()
        return run

    with trace.counting() as d:
        with trace.span("backward"):
            runs = [_on_card(cards, card, backward(f"bwd{card}")) for card in (0, 1)]
            for t, _ in runs:
                t.join()
    assert not any(failed for _, failed in runs)
    assert d == {"backward": 1, "backward/bwd0": 3, "backward/bwd0/inner": 3,
                 "backward/bwd1": 3, "backward/bwd1/inner": 3}
    assert all(ev == stream for ev, stream in cards.recorded)


# ---------------------------------------------------------------------------
# the LM path
# ---------------------------------------------------------------------------
def _dense():
    cfg = get_config("granite-3-8b").reduced()
    toks = torch.randint(cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0))
    return cfg, init_params(cfg, 0, CPU), toks


def test_program_spans_appear_in_the_chrome_trace(tmp_path):
    cfg, params, toks = _dense()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill_with_cache(params, toks, cfg, 32)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"layer", "attention", "rope", "rmsnorm", "ffn"} <= names
    layers = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "layer"]
    assert len(layers) == cfg.num_layers


def test_dense_prefill_opens_a_layer_span_a_layer():
    cfg, params, toks = _dense()
    with trace.counting() as d:
        prefill_with_cache(params, toks, cfg, 32)
    L = cfg.num_layers
    assert d["layer"] == L
    assert d["layer/attention"] == L and d["layer/attention/rope"] == 2 * L
    assert d["layer/rmsnorm"] == L and d["layer/ffn"] == L and d["layer/ffn/rmsnorm"] == L
    assert d["rmsnorm"] == 1   # the final norm
    assert trace.calls(d, "layer") == L


def test_decode_step_opens_a_layer_span_a_layer():
    cfg, params, toks = _dense()
    _, cache = prefill_with_cache(params, toks, cfg, 32)
    step = make_decode_step(cfg)
    with trace.counting() as d:
        step(params, cache, toks[:, :1])
    assert d["layer"] == cfg.num_layers and d["layer/attention"] == cfg.num_layers
    assert d["layer/attention/rope"] == 2 * cfg.num_layers


def _hybrid_step(accum=2):
    cfg = get_config("zamba2-2.7b").reduced()
    inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device=CPU)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), grad_accum=accum)
    params = init_params(cfg, 0, CPU)
    state = make_train_state(params, tcfg)
    return cfg, lambda: make_train_step(cfg, tcfg)(params, state, inputs)


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_hybrid_train_step_spans(remat, monkeypatch):
    """At ``grad_accum`` 2: #6's and #7's backwards once a forward launch,
    each layer recomputed under ``backward``, one AdamW update; with
    ``REPRO_REMAT=dots`` too (selective checkpointing sees the spans'
    ``record_function`` ops)."""
    monkeypatch.setenv("REPRO_REMAT", remat)
    cfg, step = _hybrid_step()
    with trace.counting() as d:
        _, _, m = step()
    assert torch.isfinite(m["loss"])
    applications = cfg.num_layers // cfg.shared_attn_every
    assert trace.calls(d, "flash_attention.bwd") == 2 * applications
    assert trace.calls(d, "ssd_intra.bwd") == 2 * cfg.num_layers
    assert trace.calls(d, "flash_attention.bwd", under="backward") == 2 * applications
    assert trace.calls(d, "layer", under="backward") == 2 * cfg.num_layers
    assert trace.calls(d, "layer", under="forward") == 2 * cfg.num_layers
    assert trace.calls(d, "ssd.scan") == 2 * 2 * cfg.num_layers   # forward and recompute
    assert d["forward"] == d["backward"] == 2
    assert d["adamw_update"] == 1 and d["grad_accumulate"] == 3


def test_outputs_are_bit_equal_with_spans_on_and_off():
    cfg, params, toks = _dense()
    off = prefill_with_cache(params, toks, cfg, 32)
    with trace.counting():
        on = prefill_with_cache(params, toks, cfg, 32)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    _, step = _hybrid_step()
    p_off, _, m_off = step()
    _, step = _hybrid_step()
    with trace.counting():
        p_on, _, m_on = step()
    assert torch.equal(m_off["loss"], m_on["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(p_off), leaves(p_on)))


def test_engine_phases_are_spans_and_keep_their_stats():
    instr = Instrumentation()
    with trace.counting() as d:
        with instr.phase("encode"):
            with instr.phase("keys"):
                pass
        with instr.phase("encode"):
            pass
    assert d == {"encode": 2, "encode/keys": 1}
    assert set(instr.stats) == {"t_encode", "t_keys"}
    with instr.phase("join"):   # spans off: the stats alone
        pass
    assert "t_join" in instr.stats


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("times a Hopper kernel: needs a CUDA device (run on the H100)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_span_device_time_matches_events_placed_by_hand(cuda):
    """A span around one #6 launch reads within 10% of a CUDA event pair
    recorded by hand around the same span, three times over (after a
    first span and launch, which build the kernel and the profiler op)."""
    from repro_torch.kernels.attention.ops import flash_attention

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 8192, 32, 128), generator=g, device=cuda, dtype=torch.bfloat16)
               for _ in range(3))
    with trace.counting():
        with trace.span("one.launch"):
            flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = trace.totals()["one.launch"]["device_ms"]
        with trace.counting():
            start.record()
            with trace.span("one.launch"):
                flash_attention(q, k, v, causal=True)
            end.record()
        span_ms = trace.totals()["one.launch"]["device_ms"] - before
        torch.cuda.synchronize()
        by_hand = start.elapsed_time(end)
        assert by_hand > 0.5
        assert abs(span_ms - by_hand) <= 0.1 * by_hand, (span_ms, by_hand)


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("drives two cards from one process: needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_spans_on_two_cards_backward():
    """#6 on two cards, the backward through both (each card's on its own
    engine thread), twice, the second time with events read back from the
    first in the pool: every span closes and times its card's stream."""
    from repro_torch.kernels.attention.ops import flash_attention

    cards = _two_cards()
    qkv = [[torch.randn((1, 1024, 8, 128), device=c, dtype=torch.bfloat16, requires_grad=True)
            for _ in range(3)] for c in cards]
    for _ in range(2):
        with trace.counting() as d:
            with trace.span("backward"):
                loss = sum(flash_attention(*t, causal=True).float().sum().to(cards[0]) for t in qkv)
                loss.backward()
    assert d == {"backward": 1, "backward/flash_attention.bwd": 2}
    assert trace.totals()["backward/flash_attention.bwd"]["device_ms"] > 0


@pytest.mark.cuda
def test_spans_on_a_two_card_mesh_train_step():
    """A hybrid train step on a mesh of two cards, spans on for two steps
    (the second takes events read back from the first): the backwards of
    both data ranks counted, the loss that of the step with spans off."""
    from repro_torch.launch.train import make_mesh_for_devices

    cards = _two_cards()
    cfg = get_config("zamba2-2.7b").reduced()
    inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device=cards[0])
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), grad_accum=2)
    step = make_train_step(cfg, tcfg, make_mesh_for_devices(devices=cards))

    def fresh_step():   # the step updates the weights in place
        params = init_params(cfg, 0, cards[0])
        return step(params, make_train_state(params, tcfg), inputs)

    _, _, m_off = fresh_step()
    for _ in range(2):
        with trace.counting() as d:
            _, _, m_on = fresh_step()
    applications = cfg.num_layers // cfg.shared_attn_every
    assert trace.calls(d, "flash_attention.bwd", under="backward") == 2 * 2 * applications
    assert trace.calls(d, "ssd_intra.bwd", under="backward") == 2 * 2 * cfg.num_layers
    assert trace.calls(d, "layer", under="backward") == 2 * 2 * cfg.num_layers
    assert torch.equal(m_off["loss"], m_on["loss"])
