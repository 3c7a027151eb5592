"""Prefill traffic: a closed loop of prompt batches through the port's
serve step (``repro_torch.serve.serve_step.prefill_with_cache``).

The traffic file gives the batch (prompts a batch, all of one length) and
the cycle of lengths; each cycle plays those lengths in an order shuffled
by the seed, so every seed sends the same sizes.  Token ids are drawn on
the card from the seed over the vocabulary.  After each batch the harness
takes its answer, the greedy first token of every prompt, to the host.

The check: batches are drawn from the seed among the first
``within_batches`` (the first one of the longest length always among
them), one prompt of each (the first from the batch's first half, the
second from its second half, the rest anywhere); their last-token logits
and every cache entry the serve step wrote for them are kept when they
complete (in buffers made in set-up, whose bytes ``run.check_bytes``
counts: they are not the program's), and after the window the reference runs each of those prompts
alone.  ``logits_err`` is the largest relative L2 gap of a checked
prompt's logits over the vocabulary; ``cache_err`` the largest relative
L2 gap of a cache entry's vector, each layer and position apart (each
layer apart for the SSM's states).
"""
from __future__ import annotations

import random
import time

import torch
from torch.profiler import record_function

from perfbench.bench import compare, weights

TOKENS_STREAM = 0x70EC_0002
WARM_STREAM = 0x3A53_0003


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.model
        self.traffic = run.cell.traffic
        self.own = run.cell.own
        self.dev = run.device
        self.layout = run.reference.layout(self.cfg)
        self.B, self.max_len = self.traffic["batch"], self.traffic["max_len"]
        self.lengths = list(self.traffic["lengths"])
        self.rng = random.Random(run.seed)
        self.order: list = []
        self._choose_checked()

    # -- set-up ---------------------------------------------------------
    def setup(self):
        t0 = time.perf_counter()
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models.model import param_shape_structs

        self.run.log(f"program imported: {time.perf_counter() - t0:.3f} s")
        self.mcfg = ModelConfig(**self.cfg)
        weights.check_layout(self.layout, param_shape_structs(self.mcfg))
        t0 = time.perf_counter()
        self.params, _ = weights.make(self.layout, self.run.seed, self.dev)
        self.run.log(f"weights: {time.perf_counter() - t0:.3f} s")
        self.gen = weights.generator(self.run.seed, TOKENS_STREAM, self.dev)
        warm = weights.generator(self.run.seed, WARM_STREAM, self.dev)
        t0 = time.perf_counter()
        self.kept = {}
        for S in sorted(set(self.lengths)):
            toks = torch.randint(self.cfg["vocab_size"], (self.B, S), generator=warm, device=self.dev)
            logits, cache = self._prefill(toks)
            logits.argmax(-1).cpu()
            if S == self.max_len or S == max(self.lengths):
                # buffers for the checked prompts' cache rows, made here so
                # that the window's memory does not depend on the seed
                self.kept_buffers = [{k: torch.empty_like(v[:, 0]) for k, v in cache.items() if v.ndim >= 2}
                                     for _ in self.checked]
                self.kept_logits = torch.empty((len(self.checked), logits.shape[-1]), dtype=torch.float32,
                                               device=self.dev)
                self.kept_tokens = torch.empty((len(self.checked), self.max_len), dtype=toks.dtype,
                                               device=self.dev)
            del logits, cache
            self.run.log(f"warm {S}: {time.perf_counter() - t0:.3f} s")
        kept = [self.kept_logits, self.kept_tokens] + [b for bufs in self.kept_buffers for b in bufs.values()]
        self.run.check_bytes = sum(t.numel() * t.element_size() for t in kept)
        self.i = 0

    def _choose_checked(self):
        n, within = self.own["checked_batches"], self.own["within_batches"]
        first = [self.length(i) for i in range(within)]
        longest = first.index(max(self.lengths))
        rng = random.Random(self.run.seed ^ 0xC4EC)
        others = rng.sample([i for i in range(within) if i != longest], n - 1)
        half = self.B // 2
        rows = [rng.randrange(0, half), rng.randrange(half, self.B)]
        rows += [rng.randrange(self.B) for _ in range(n - 2)]
        # batch index -> (slot, row)
        self.checked = {b: (slot, rows[slot]) for slot, b in enumerate([longest] + others)}

    def length(self, i: int) -> int:
        while len(self.order) <= i:
            cycle = list(self.lengths)
            self.rng.shuffle(cycle)
            self.order.extend(cycle)
        return self.order[i]

    def _prefill(self, toks):
        from repro_torch.serve import serve_step

        return serve_step.prefill_with_cache(self.params, toks, self.mcfg, self.max_len)

    # -- the measured loop ------------------------------------------------
    def _batch(self, keep: bool):
        S = self.length(self.i)
        toks = torch.randint(self.cfg["vocab_size"], (self.B, S), generator=self.gen, device=self.dev)
        with record_function("prefill"):
            logits, cache = self._prefill(toks)
        last = logits[:, -1, :self.cfg["vocab_size"]]
        answer = torch.stack([last.argmax(-1), torch.isfinite(last).all(-1).long()])
        if keep and self.i in self.checked:
            slot, row = self.checked[self.i]
            for k, buf in self.kept_buffers[slot].items():
                buf.copy_(cache[k][:, row])
            self.kept_logits[slot].copy_(logits[row, -1])
            self.kept_tokens[slot, :S].copy_(toks[row])
            self.kept[slot] = (self.kept_tokens[slot, :S], S)
        answer = answer.cpu()
        del logits, cache, last
        self.i += 1
        return S, int(answer[1].sum())

    def _loop(self, until, keep: bool) -> dict:
        units, tokens, ok = [], 0, 0
        t0 = time.perf_counter()
        while True:
            S, n_ok = self._batch(keep)
            units.append((self.B, S))
            tokens += self.B * S
            ok += n_ok
            t = time.perf_counter() - t0
            if until(t, len(units)):
                break
        return {"seconds": t, "tokens": tokens, "units": units, "attempted": self.B * len(units),
                "failed": self.B * len(units) - ok}

    def window(self, seconds: float) -> dict:
        need = max(self.checked) + 1
        return self._loop(lambda t, n: t >= seconds and n >= need, keep=True)

    def stretch(self) -> dict:
        """One whole cycle of lengths, from the next cycle's start (the
        schedule's places skipped to reach it play no batch), so that every
        traced stretch holds the same sizes."""
        n = len(self.lengths)
        self.i = -(-self.i // n) * n
        return self._loop(lambda t, k: k >= n, keep=False)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def check(self) -> dict:
        if len(self.kept) != len(self.checked):
            return {}
        ref = self.run.reference
        got = {slot: (self.kept_logits[slot], self.kept_buffers[slot]) for slot in self.kept}
        with ref.float32_matmuls():
            return gaps(ref, self.params, self.cfg, self.kept, got)

    def prompts(self) -> dict:
        """{slot: (the checked prompt, its length)}, drawn again from the
        seed as the window draws them."""
        gen = weights.generator(self.run.seed, TOKENS_STREAM, self.dev)
        out = {}
        for i in range(max(self.checked) + 1):
            S = self.length(i)
            toks = torch.randint(self.cfg["vocab_size"], (self.B, S), generator=gen, device=self.dev)
            if i in self.checked:
                slot, row = self.checked[i]
                out[slot] = (toks[row].clone(), S)
        return out

    def control(self, precision: str) -> dict:
        """The control's numbers: the reference at ``precision`` put in the
        program's place on the checked prompts, against the float32
        reference; the program is not run."""
        ref = self.run.reference
        params, _ = weights.make(self.layout, self.run.seed, self.dev)
        prompts = self.prompts()
        with ref.float32_matmuls():
            got = {slot: ref.prefill(params, toks, self.cfg, ref.Precision(precision))
                   for slot, (toks, _) in prompts.items()}
            return gaps(ref, params, self.cfg, prompts, got)


def gaps(ref, params: dict, cfg: dict, prompts: dict, got: dict) -> dict:
    """``logits_err`` and ``cache_err`` of ``got`` ({slot: (last-token
    logits, {cache entry: one prompt's rows}) }) against the float32
    reference on ``prompts``."""
    V = cfg["vocab_size"]
    logits_err, cache_err = 0.0, 0.0
    for slot, (toks, _) in sorted(prompts.items()):
        r_logits, r_cache = ref.prefill(params, toks, cfg)
        g_logits, g_cache = got[slot]
        logits_err = max(logits_err, compare.rel_l2(g_logits[:V], r_logits))
        for name, r in r_cache.items():
            keep = 2 if name in ref.POSITIONAL else 1
            cache_err = max(cache_err, compare.worst_rel_l2(g_cache[name], r, keep))
    return {"logits_err": logits_err, "cache_err": cache_err}
