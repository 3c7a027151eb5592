"""Training traffic: steps of the port's train step
(``repro_torch.train.train_step.make_train_step``: microbatches,
``torch.autograd.grad``, float32 accumulation, AdamW) on one object built
once.

Each step takes a fresh batch: ``batch`` rows of ``seq_len + 1`` token ids
drawn on the card from the seed, the first ``seq_len`` the inputs and the
last ``seq_len`` the labels, so every row differs.  Set-up builds the
step, its model and its optimizer state, and drives it from the seed
through its first ``checked_steps`` steps, the window's own call on the
window's own feed; the window then continues the same object.

The check: the reference (``perfbench/reference/``) follows those first
steps from the same weights, made again from the seed, on the same
batches.  ``loss_gap`` is the largest relative gap of a step's loss;
``grad_norm_gap`` the worst leaf's gap between the norms of the first
step's gradient as the update takes it (the program's, worked out from its
first moment after one step: ``m / (1 - beta1)``); ``change_norm_gap`` the
worst leaf's gap between the norms of the weights' change over the checked
steps, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's (they move by rounding alone).  A gap of
two norms is taken over the larger of the reference's norm of that leaf
and of the median leaf.  A stacked weight's layers are leaves each.
"""
from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function

from perfbench.bench import compare, weights

TOKENS_STREAM = 0x7A1B_0004
# a leaf moves by rounding alone where its reference gradient is under
# this share of the median leaf's
ROUNDING_ONLY = 1e-3


def leaf_norms(tree: dict, fn) -> dict:
    """{leaf name: norm of ``fn(path, index)``}: ``fn`` gives a leaf's
    tensor (``index`` None), or layer ``index`` of a stacked weight under
    ``blocks``, named ``blocks.<path>[index]`` as the reference names its
    leaves."""
    out = {}
    for path, t in weights.walk(tree):
        name = ".".join(path)
        if path[0] == "blocks":
            for i in range(t.shape[0]):
                out[f"{name}[{i}]"] = float(torch.linalg.vector_norm(fn(path, i).float()))
        else:
            out[name] = float(torch.linalg.vector_norm(fn(path, None).float()))
    return out


def _at(tree: dict, path: tuple, i):
    for k in path:
        tree = tree[k]
    return tree if i is None else tree[i]


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.model
        self.traffic = run.cell.traffic
        self.own = run.cell.own
        self.dev = run.device
        self.layout = run.reference.layout(self.cfg)

    def setup(self):
        t0 = time.perf_counter()
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models.model import param_shape_structs
        from repro_torch.train import optimizer, train_step

        self.run.log(f"program imported: {time.perf_counter() - t0:.3f} s")
        self.mcfg = ModelConfig(**self.cfg)
        weights.check_layout(self.layout, param_shape_structs(self.mcfg))
        t0 = time.perf_counter()
        self.params, flats = weights.make(self.layout, self.run.seed, self.dev)
        opt = dict(self.traffic["optimizer"])
        self.opt = optimizer.OptConfig(**opt)
        tcfg = train_step.TrainConfig(opt=self.opt, grad_accum=self.traffic["grad_accum"])
        self.state = train_step.make_train_state(self.params, tcfg)
        self.step = train_step.make_train_step(self.mcfg, tcfg)
        self.gen = weights.generator(self.run.seed, TOKENS_STREAM, self.dev)
        start = weights.views(self.layout, [f.clone() for f in flats])
        self.run.log(f"weights and optimizer state: {time.perf_counter() - t0:.3f} s")
        del flats
        self.batches, self.losses, self.grad = [], [], None
        for k in range(self.own["checked_steps"]):
            batch = self._batch()
            self.batches.append(batch)
            t0 = time.perf_counter()
            loss = self._step(batch)
            self.run.log(f"checked step {k + 1}: {time.perf_counter() - t0:.3f} s, loss {loss}")
            self.losses.append(loss)
            if k == 0:
                mom = self.state["opt"]["moments"]
                scale = 1.0 / (1.0 - self.opt.beta1)
                self.grad = leaf_norms(self.params, lambda p, i: _at(mom, p + ("m",), i) * scale)
        self.change = leaf_norms(self.params, lambda p, i: _at(self.params, p, i).float()
                                 - _at(start, p, i).float())
        del start
        self.run.check_bytes = sum(t.numel() * t.element_size() for b in self.batches for t in b.values())

    def _batch(self) -> dict:
        B, S = self.traffic["batch"], self.traffic["seq_len"]
        rows = torch.randint(self.cfg["vocab_size"], (B, S + 1), generator=self.gen, device=self.dev)
        return {"tokens": rows[:, :-1].contiguous(), "labels": rows[:, 1:].contiguous()}

    def _step(self, batch) -> float:
        with record_function("train_step"):
            self.params, self.state, m = self.step(self.params, self.state, batch)
        return float(m["loss"])

    def _loop(self, until) -> dict:
        B, S = self.traffic["batch"], self.traffic["seq_len"]
        units, failed = [], 0
        t0 = time.perf_counter()
        while True:
            loss = self._step(self._batch())
            failed += not (loss == loss and abs(loss) != float("inf"))
            units.append((B, S))
            t = time.perf_counter() - t0
            if until(t, len(units)):
                break
        return {"seconds": t, "tokens": B * S * len(units), "units": units, "attempted": len(units),
                "failed": failed}

    def window(self, seconds: float) -> dict:
        return self._loop(lambda t, n: t >= seconds)

    def stretch(self) -> dict:
        """One step."""
        return self._loop(lambda t, n: n >= 1)

    def release(self):
        del self.params, self.state, self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, batches: list, precision: str = "float32") -> dict:
        ref = self.run.reference
        start, _ = weights.make(self.layout, self.run.seed, self.dev)
        opt = {k: self.traffic["optimizer"][k] for k in ("lr", "beta1", "beta2", "eps", "weight_decay",
                                                          "grad_clip", "warmup_steps")}
        with ref.float32_matmuls():
            return ref.train(start, batches, self.cfg, ref.AdamW(**opt), ref.Precision(precision))

    def check(self) -> dict:
        got = {"loss": self.losses, "grad": self.grad, "change": self.change}
        ref = self._reference([(b["tokens"], b["labels"]) for b in self.batches])
        self.run.log(f"leaves: {len(ref['grad'])}, moved by rounding alone: {len(rounding_only(ref))}")
        numbers = gaps(got, ref)
        for name in sorted(set(numbers) - set(self.own["limits"])):
            self.run.log(f"{name}: {numbers[name]} (not compared)")
        return numbers

    def batches_again(self) -> list:
        """The checked steps' batches, drawn again from the seed."""
        self.gen = weights.generator(self.run.seed, TOKENS_STREAM, self.dev)
        out = [self._batch() for _ in range(self.own["checked_steps"])]
        return [(b["tokens"], b["labels"]) for b in out]

    def control(self, precision: str) -> dict:
        """The control's numbers: the reference at ``precision`` put in the
        program's place, against the float32 reference; the program is
        not run."""
        batches = self.batches_again()
        return gaps(self._reference(batches, precision), self._reference(batches))

    def fault_half_batch(self) -> dict:
        """The numbers of a step that leaves out half of each batch and
        takes the mean over the rest, planted in the reference."""
        batches = self.batches_again()
        half = [(t[:t.shape[0] // 2], lab[:lab.shape[0] // 2]) for t, lab in batches]
        return gaps(self._reference(half), self._reference(batches))


def gaps(got: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_norm_gap`` and ``change_norm_gap`` of ``got``
    against ``ref`` (each {"loss": [a step], "grad": {leaf: norm},
    "change": {leaf: norm}})."""
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "grad_norm_gap": compare.worst_norm_gap(got["grad"], ref["grad"]),
        "change_norm_gap": compare.worst_norm_gap(got["change"], ref["change"], rounding_only(ref)),
    }


def rounding_only(ref: dict) -> set:
    """The leaves whose reference gradient is under ``ROUNDING_ONLY`` of
    the median leaf's: they move by rounding alone."""
    floor = ROUNDING_ONLY * statistics.median(ref["grad"].values())
    return {n for n, g in ref["grad"].items() if g < floor}
