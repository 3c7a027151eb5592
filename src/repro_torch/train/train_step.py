"""The train step: loss -> grads -> (optional EF compression) -> AdamW,
with microbatched gradient accumulation and data parallelism.

Port of ``repro/train/train_step.py``.  The global batch is split into
``grad_accum`` microbatches along dim 0; each one's gradient
(``torch.autograd.grad`` over the parameter leaves, in their dtypes) is
summed in float32 and the sum divided by ``grad_accum``, so activation
memory scales with the microbatch.  The forward recomputes each unit in
the backward (``models/model.py::forward``), as the reference's
``jax.checkpoint`` does.

With a mesh (``("data", "model")``, or ``("pod", "data", "model")``) the
step is data parallel: each microbatch is split again, into one row block
a data shard (microbatches first, then data, as the reference's sharded
batch meets its ``_split_microbatches``), and each data shard's gradient
is taken on its own rows (its ranks' device; the MoE layers expert-
parallel over its ``model`` ranks, each shard routed at its own
capacity).  Each shard's gradients are summed in float32 over the
microbatches and averaged over the data axes with one ``mesh.psum`` a
leaf; the optimizer then runs once on the shared weights.  Each shard
differentiates its cross-entropy weighted by its share of the labelled
tokens and the MoE aux loss as it is, so the average is the reference's
gradient: that of the global token mean, with the aux term's gradient
the data shards' mean (``models/moe.py``); the loss reported is the
global cross-entropy plus data shard 0's aux, the value the reference
returns.  ``compress_grads`` runs ``ef_compress`` on the averaged
gradients, as the reference does.  Without a mesh the step is one data
shard: at ``grad_accum`` = 1 its gradients go to the optimizer in their
dtypes, with no float32 copy and no ``psum``.

Spans (``core/trace.py``): ``forward`` around the loss and ``backward``
around ``torch.autograd.grad`` (the recompute's ``layer`` spans and the
kernels' backwards open under it), ``grad_accumulate`` around the float32
sums, and the optimizer's ``adamw_update``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compat, trace
from repro_torch.models.layers import dp_axes
from repro_torch.models.model import AUX_LOSS_COEF, loss_fn
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


def loss_and_grads(params: dict, inputs: dict, cfg: ModelConfig, mesh=None, *, ce_weight=None):
    """-> (loss, metrics, grads): :func:`~repro_torch.models.model.loss_fn`
    (over ``mesh`` when given) and its gradient with respect to every
    parameter leaf (the leaves' dtypes; zeros for a leaf the loss does not
    reach).  With ``ce_weight`` the gradient is that of ``ce_weight * ce +
    AUX_LOSS_COEF * aux`` (a data shard's part of a data-parallel step)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        with trace.span("forward"):
            loss, metrics = loss_fn(_like(params, flat), inputs, cfg, mesh)
            target = loss if ce_weight is None else ce_weight * metrics["ce"] + AUX_LOSS_COEF * metrics["aux"]
        with trace.span("backward"):
            grads = torch.autograd.grad(target, flat, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _like(params, list(grads))


def _data_shards(mesh, device) -> list:
    """The data shards, in dp order: for each, its ranks (one a ``model``
    coordinate), its first rank's device, and the sub-mesh its MoE layers
    run on (None at ``model`` = 1: one rank holds every expert).  Without
    a mesh, one shard on ``device``."""
    if mesh is None:
        return [((0,), device, None)]
    dp = dp_axes(mesh)
    groups = sorted(mesh.groups("model"), key=lambda g: mesh._group_position(g[0], dp))
    tp = mesh.shape["model"]
    return [(g, mesh.devices[g[0]], None if tp == 1 else compat.make_mesh(
        (1, tp), ("data", "model"), devices=[mesh.devices[r] for r in g])) for g in groups]


def _shard_grads(params: dict, inputs: dict, cfg: ModelConfig, mesh, shards: list):
    """One microbatch over the data shards -> (the loss the reference
    reports, each shard's gradient leaves).  The shards' MoE collectives
    are counted on ``mesh``."""
    n = len(shards)
    if n == 1:
        sub = shards[0][2]
        loss, _, grads = loss_and_grads(params, inputs, cfg, sub)
        if sub is not None:
            _count_on(mesh, sub)
        return loss, [leaves(grads)]
    for name, x in inputs.items():
        if x.shape[0] % n:
            raise ValueError(f"microbatch {x.shape[0]} of {name!r} not divisible by {n} data shards")
    parts = [{name: x.unflatten(0, (n, -1))[j] for name, x in inputs.items()} for j in range(n)]
    ntok = [torch.clamp((p["labels"] >= 0).sum(), min=1) for p in parts]
    total = sum(t.to(ntok[0].device) for t in ntok)
    ce_sum, aux0, per_shard = 0.0, None, []
    for j, ((_, dev, sub), part) in enumerate(zip(shards, parts)):
        on = {k: v.to(dev) for k, v in part.items()}
        weight = (ntok[j] * n / total).to(dev)
        # the shared weights: views where the shard's device is theirs
        _, metrics, grads = loss_and_grads(_like(params, [p.to(dev) for p in leaves(params)]), on, cfg,
                                           sub, ce_weight=weight)
        if sub is not None:
            _count_on(mesh, sub)
        ce_sum = ce_sum + (metrics["ce"] * metrics["ntok"]).to(ntok[0].device)
        aux0 = metrics["aux"] if aux0 is None else aux0
        per_shard.append(leaves(grads))
        del grads
    return ce_sum / total + AUX_LOSS_COEF * aux0.to(total.device), per_shard


def _count_on(mesh, sub) -> None:
    for kind, n_bytes in sub.collective_bytes.items():
        mesh.collective_bytes[kind] += n_bytes
    sub.reset_collective_bytes()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """-> ``train_step(params, state, inputs) -> (params, state, metrics)``;
    the params and the state are updated in place and returned.  With a
    ``mesh``, data parallel over its dp axes (the module docstring);
    without one, a single data shard."""

    def train_step(params, state, inputs):
        device = leaves(params)[0].device
        shards = _data_shards(mesh, device)
        n, accum = len(shards), tcfg.grad_accum
        micro = [inputs] if accum == 1 else _split_microbatches(inputs, accum)
        # one shard and one microbatch: its gradients as they are; else
        # summed in float32
        acc, l_sum = None, 0.0
        for mb in micro:
            loss, per_shard = _shard_grads(params, mb, cfg, mesh, shards)
            if n * accum == 1:
                acc = per_shard
            else:
                with trace.span("grad_accumulate"):
                    if acc is None:
                        acc = [[g.float() for g in shard] for shard in per_shard]
                    else:
                        for a_shard, g_shard in zip(acc, per_shard):
                            for a, g in zip(a_shard, g_shard):
                                a += g.float()
            l_sum = l_sum + loss
            del per_shard
        if n == 1:
            flat = acc[0]
            if accum > 1:
                with trace.span("grad_accumulate"):
                    for a in flat:
                        a /= accum
        else:
            # one psum a leaf over the data axes: each rank holds its shard's sums
            shard_of = {r: j for j, (ranks, _, _) in enumerate(shards) for r in ranks}
            dp, flat = dp_axes(mesh), []
            for i in range(len(acc[0])):
                summed = mesh.psum([acc[shard_of[r]][i] for r in range(mesh.size)], dp)[0]
                flat.append(summed.to(device) / (n * accum))
                for a_shard in acc:
                    a_shard[i] = None
        grads, loss = _like(params, flat), (l_sum if accum == 1 else l_sum / accum)

        if tcfg.compress_grads:
            grads, residual = comp.ef_compress(grads, state["ef_residual"])
        params, opt_state, opt_metrics = adamw_update(params, grads, state["opt"], tcfg.opt)
        new_state = {"opt": opt_state}
        if tcfg.compress_grads:
            new_state["ef_residual"] = residual
        return params, new_state, {"loss": loss, **opt_metrics}

    return train_step
