"""The train step: loss -> grads -> (optional EF compression) -> AdamW,
with microbatched gradient accumulation.

Port of ``repro/train/train_step.py`` for one device.  The global batch is
split into ``grad_accum`` microbatches along dim 0; each one's gradient
(``torch.autograd.grad`` over the parameter leaves, in their dtypes) is
summed in float32 and the sum divided by ``grad_accum``, so activation
memory scales with the microbatch.  The forward recomputes each unit in
the backward (``models/model.py::forward``), as the reference's
``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1
    compress_grads: bool = False   # int8 error-feedback DP sync numerics


def make_train_state(params: dict, tcfg: TrainConfig) -> dict:
    state = {"opt": init_opt_state(params, tcfg.opt)}
    if tcfg.compress_grads:
        state["ef_residual"] = comp.init_residuals(params)
    return state


def _split_microbatches(inputs: dict, n: int) -> list:
    """``n`` microbatches, each a dict of row blocks of ``inputs``."""
    for name, x in inputs.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} of {name!r} not divisible by grad_accum {n}")
    return [{name: x.unflatten(0, (n, -1))[i] for name, x in inputs.items()} for i in range(n)]


def _like(tree: dict, flat: list) -> dict:
    it = iter(flat)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in node.items()}

    return build(tree)


def loss_and_grads(params: dict, inputs: dict, cfg: ModelConfig):
    """-> (loss, metrics, grads): :func:`~repro_torch.models.model.loss_fn`
    and its gradient with respect to every parameter leaf (the leaves'
    dtypes; zeros for a leaf the loss does not reach)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(_like(params, flat), inputs, cfg)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _like(params, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``train_step(params, state, inputs) -> (params, state, metrics)``;
    the params and the state are updated in place and returned."""

    def train_step(params, state, inputs):
        if tcfg.grad_accum == 1:
            loss, _, grads = loss_and_grads(params, inputs, cfg)
        else:
            g_sum, l_sum = None, torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for mb in _split_microbatches(inputs, tcfg.grad_accum):
                loss, _, grads = loss_and_grads(params, mb, cfg)
                flat = leaves(grads)
                if g_sum is None:
                    g_sum = [g.float() for g in flat]
                else:
                    for a, g in zip(g_sum, flat):
                        a += g.float()
                l_sum = l_sum + loss
                del grads, flat
            for a in g_sum:
                a /= tcfg.grad_accum
            grads = _like(params, g_sum)
            loss = l_sum / tcfg.grad_accum

        if tcfg.compress_grads:
            grads, residual = comp.ef_compress(grads, state["ef_residual"])
        params, opt_state, opt_metrics = adamw_update(params, grads, state["opt"], tcfg.opt)
        new_state = {"opt": opt_state}
        if tcfg.compress_grads:
            new_state["ef_residual"] = residual
        return params, new_state, {"loss": loss, **opt_metrics}

    return train_step
