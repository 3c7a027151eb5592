"""The comparison that decides ``correct`` refuses a broken timed path.

Each test drives a whole run of a tiny cell on the CPU with the port's
timed call broken underneath (the port's module attribute replaced for
the test), and sees ``correct`` come out false under the committed
limits: once for each fault the cell can have.  No cell spans chips, so
there is no exchange between chips to leave out.

The control, the reference in fp8 put in the program's place, has to
read well above the program: here at a tiny size on the CPU, and on the
card at the cells' own sizes (``cuda``).
"""
import time

import pytest
import torch

from perfbench.bench import runner, spec


def run(root, cell, seed=31_000_000_003):
    return runner.run_cell(cell, seed, 0.2, False, t_start=time.perf_counter(), device="cpu", root=root,
                           log=lambda m: None)


def _pad(t, B, dim):
    shape = list(t.shape)
    shape[dim] = B - shape[dim]
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype)], dim=dim)


def prefill_half_batch(real):
    """Half of the batch left out: its rows' answers and caches zeros."""
    def broken(params, tokens, cfg, max_len, **kw):
        B = tokens.shape[0]
        logits, cache = real(params, tokens[:B // 2], cfg, max_len, **kw)
        return _pad(logits, B, 0), {k: v if v.ndim < 2 else _pad(v, B, 1) for k, v in cache.items()}
    return broken


def prefill_answer_altered(real):
    def broken(*a, **kw):
        logits, cache = real(*a, **kw)
        return logits.roll(1, dims=0), cache
    return broken


def prefill_cache_token_altered(real):
    def broken(*a, **kw):
        logits, cache = real(*a, **kw)
        name = next(k for k in ("k", "sk") if k in cache)
        cache[name][0, :, 1] = cache[name][0, :, 0]
        return logits, cache
    return broken


@pytest.mark.parametrize("cell", ["tiny-dense-prefill", "tiny-hybrid-prefill"])
@pytest.mark.parametrize("fault", [prefill_half_batch, prefill_answer_altered, prefill_cache_token_altered])
def test_prefill_faults_are_refused(tiny_root, cell, fault, monkeypatch):
    from repro_torch.serve import serve_step

    monkeypatch.setattr(serve_step, "prefill_with_cache", fault(serve_step.prefill_with_cache))
    res = run(tiny_root, cell)
    assert not res["correct"], res["checks"]


def train_state_unchanged(make):
    def broken(cfg, tcfg, mesh=None):
        from repro_torch.models.model import loss_fn

        def step(params, state, inputs):
            with torch.no_grad():
                loss, _ = loss_fn(params, inputs, cfg)
            return params, state, {"loss": loss}
        return step
    return broken


def train_half_batch(make):
    def broken(cfg, tcfg, mesh=None):
        real = make(cfg, tcfg, mesh)

        def step(params, state, inputs):
            half = {k: v[:v.shape[0] // 2] for k, v in inputs.items()}
            return real(params, state, half)
        return step
    return broken


def train_leaf_not_moved(make):
    """An answer altered where it is produced: one layer's update of its
    largest weight left out."""
    def broken(cfg, tcfg, mesh=None):
        real = make(cfg, tcfg, mesh)

        def step(params, state, inputs):
            from perfbench.bench.weights import walk

            w = max((t for _, t in walk(params["blocks"])), key=lambda t: t[1].numel())
            keep = w[1].clone()
            params, state, m = real(params, state, inputs)
            w[1].copy_(keep)
            return params, state, m
        return step
    return broken


@pytest.mark.parametrize("cell", ["tiny-dense-train", "tiny-hybrid-train"])
@pytest.mark.parametrize("fault", [train_state_unchanged, train_half_batch, train_leaf_not_moved])
def test_train_faults_are_refused(tiny_root, cell, fault, monkeypatch):
    from repro_torch.train import train_step

    monkeypatch.setattr(train_step, "make_train_step", fault(train_step.make_train_step))
    res = run(tiny_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny-dense-prefill", "tiny-hybrid-train"])
@pytest.mark.parametrize("seed", [41, 42, 43])
def test_control_reads_well_above_the_program(tiny_root, cell, seed):
    """The fp8 control's numbers against the program's on one seed: at
    least one number three times or more the program's."""
    program = {k: v["value"] for k, v in run(tiny_root, cell, seed)["checks"].items()}
    c = spec.load_cell(cell, tiny_root)
    r = runner.Run(cell=c, seed=seed, device=torch.device("cpu"),
                   reference=spec.reference(tiny_root, c.config["reference"]))
    control = spec.driver(tiny_root, c.kind).Driver(r).control("fp8")
    assert max(control[k] / max(program[k], 1e-12) for k in program) >= 3.0, (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["granite-prefill-2k", "zamba2-train-4k"])
def test_control_fails_the_limits_on_the_card(card, cell):
    """At the cell's own size on the card, the fp8 control fails one of
    the committed limits."""
    c = spec.load_cell(cell)
    r = runner.Run(cell=c, seed=51, device=card, reference=spec.reference(c.root, c.config["reference"]))
    control = spec.driver(c.root, c.kind).Driver(r).control("fp8")
    assert any(control[k] > limit for k, limit in c.own["limits"].items()), control
