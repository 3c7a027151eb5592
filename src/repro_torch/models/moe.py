"""Mixture-of-Experts FFN: sort-dispatch into a capacity-bounded buffer.

Port of ``repro/models/moe.py``.  Without a mesh every expert runs on one
device: the reference's ``_local_dispatch_compute`` at one rank holding
all of them.  With a mesh (``core.compat.ShardMesh`` on ``("data",
"model")`` or ``("pod", "data", "model")``) :func:`moe_block` runs the
reference's expert parallelism rank by rank: the tokens are split by
batch over the dp axes; each ``(data, model)`` rank routes its own data
shard's tokens (redundantly across ``model``), dispatches only the
assignments that hit its E/tp experts (a view of the stacked weights:
ranks on one device share them, nothing is copied), with the capacity
from its local token count; the partial outputs, each cast to the
activations' dtype, are summed with one ``psum`` over ``model``, and the
aux loss is the ``pmean`` over ``model``.  The reference returns that aux
under ``out_specs=P()`` without a replication check, though each data
shard's value differs: JAX reads data shard 0's value, and its gradient
reaches every data shard's routing scaled by 1/dp (measured on virtual
CPU devices; ROADMAP §3).  :func:`moe_block` returns the same.

Routing is the reference's, step for step: a float32 router, softmax, the
top-k experts of each token (ties to the lower expert id, as
``jax.lax.top_k`` breaks them: a stable descending sort), gates normalised
by ``max(sum, 1e-9)``, the Switch aux loss ``E * sum(me * ce)``, and
``capacity = int(T*K/E * capacity_factor) + 1`` in Python floats, T the
rank's tokens.  Assignments are stably sorted by local expert (an
assignment to another rank's expert sorts last, as the sentinel E/tp); an
assignment's rank within its expert's run (``cummax`` of the run starts)
past the capacity is dropped: it writes into a sacrificial last row of the
``[E_loc*C + 1, d]`` buffer, which is sliced off, and contributes nothing
(its gate weight is lost, GShard style).  The grouped SwiGLU runs in the
activation dtype (SiLU in float32), and the gated outputs are
scatter-added in float32 (``index_add_``; on the card a token's <= K
contributions sum through atomics, so the result is not bit-stable from
run to run there) and cast back to the input's dtype.

Decode runs the block on one token a sequence, so there T is the batch and
the capacity is ``int(B*K/E * capacity_factor) + 1``: 1 for deepseek-v2 at
B = 4.  Assignments that collide then drop, as in the reference.
:func:`dropped_assignments` counts them (each rank its own experts'),
summed over calls since :func:`reset_dropped` (a diagnostic, not a
result); a training step's recompute of a layer does not count them again
(:func:`drops_not_counted`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compat
from repro_torch.core.compat import P
from repro_torch.models.layers import dp_axes, swiglu_mlp

# per device: a 0-d int64 tensor, the assignments dropped since the last
# reset (kept on the device so that counting costs no synchronisation)
_dropped: dict = {}


def reset_dropped() -> None:
    _dropped.clear()


@contextlib.contextmanager
def drops_not_counted():
    """Leave the dropped counts as they were on entering: a training step's
    recompute of a unit runs its MoE layers a second time, and their drops
    count once."""
    saved = dict(_dropped)
    try:
        yield
    finally:
        _dropped.clear()
        _dropped.update(saved)


def dropped_assignments() -> int:
    """Assignments dropped by capacity since :func:`reset_dropped`."""
    return sum(int(n) for n in _dropped.values())


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig, *, rank: int = 0,
          tp: int = 1) -> dict:
    """The routing of tokens ``x_flat`` [T, d] at ``rank`` of ``tp`` expert
    ranks (each holding E/tp experts): ``gates``/``experts`` [T, K]
    (float32, descending, experts int64); for the T*K assignments in
    local-expert order ``order`` (their flat index, token ``t * K + k``),
    ``slot`` (``e_loc * C + rank in run``, or ``E_loc * C`` when dropped or
    not local) and ``kept``; ``local``, the assignments to this rank's
    experts; ``capacity`` C; and ``aux``."""
    T = x_flat.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    E_loc = E // tp
    capacity = int(T * K / E * cfg.capacity_factor) + 1

    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :K], top.indices[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch eq. 4), on the full routing
    me = probs.mean(dim=0)
    ce = torch.bincount(expert_idx.reshape(-1), minlength=E).float() / (T * K)
    aux = E * torch.sum(me * ce)

    # this rank's experts only (E_loc marks another rank's)
    flat_e = expert_idx.reshape(-1)
    local = T * K
    if tp > 1:
        mine = (flat_e >= rank * E_loc) & (flat_e < (rank + 1) * E_loc)
        flat_e = torch.where(mine, flat_e - rank * E_loc, E_loc)
        local = mine.sum()

    # rank within expert via a stable sort + run starts
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    idx = torch.arange(e_sorted.shape[0], device=x_flat.device)
    start = torch.ones_like(e_sorted, dtype=torch.bool)
    start[1:] = e_sorted[1:] != e_sorted[:-1]
    run_start = torch.cummax(torch.where(start, idx, -1), dim=0).values
    pos = idx - run_start
    kept = (e_sorted < E_loc) & (pos < capacity)
    slot = torch.where(kept, e_sorted * capacity + pos, E_loc * capacity)
    return dict(gates=gate_vals, experts=expert_idx, order=order, slot=slot, kept=kept,
                local=local, capacity=capacity, aux=aux)


def dispatch_compute(x_flat: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor, cfg: ModelConfig, *, rank: int = 0,
                     tp: int = 1):
    """The reference's ``_local_dispatch_compute`` at ``rank`` of ``tp``
    expert ranks: x_flat [T, d]; the rank's experts' w_gate/w_up
    [E/tp, d, f], w_down [E/tp, f, d] -> (out [T, d] in x_flat's dtype,
    the partial sum of its experts' gated outputs; aux float32)."""
    T, d = x_flat.shape
    K = cfg.experts_per_token
    E_loc = w_gate.shape[0]
    r = route(x_flat, router_w, cfg, rank=rank, tp=tp)
    C, order, slot, kept = r["capacity"], r["order"], r["slot"], r["kept"]
    dev = x_flat.device
    n_dropped = r["local"] - kept.sum()
    _dropped[dev] = _dropped[dev] + n_dropped if dev in _dropped else n_dropped

    tok = torch.div(order, K, rounding_mode="floor")  # the token of each sorted assignment
    buf = torch.zeros((E_loc * C + 1, d), dtype=x_flat.dtype, device=dev)
    buf.index_copy_(0, slot, x_flat[tok])  # dropped rows land in the last row
    buf = buf[:-1].reshape(E_loc, C, d)

    # grouped SwiGLU
    h = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    h = F.silu(h.float()).to(buf.dtype) * u
    y = torch.bmm(h, w_down.to(buf.dtype))

    # scatter-add gated outputs back to tokens, in float32
    y_flat = y.reshape(E_loc * C, d)
    contrib = torch.where(kept[:, None], y_flat[torch.where(kept, slot, 0)], 0.0)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    out.index_add_(0, tok, contrib.float() * r["gates"].reshape(-1)[order][:, None])
    return out.to(x_flat.dtype), r["aux"]


class _DataShardZero(torch.autograd.Function):
    """The reference's unchecked ``P()`` aux: the value of data shard 0,
    the cotangent split evenly over the data shards (the transpose JAX
    takes of a claimed replication)."""

    @staticmethod
    def forward(ctx, per_shard):
        ctx.n = per_shard.shape[0]
        return per_shard[0].clone()

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.n) / ctx.n


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig, mesh=None):
    """x [B,S,d] -> ([B,S,d], aux loss).  p: ``router`` [d,E], ``w_gate``/
    ``w_up`` [E,d,f], ``w_down`` [E,f,d], and the shared experts' SwiGLU
    under the ``shared_`` prefix when the config has them.  With a
    ``mesh``, expert parallelism over its ``model`` axis and the batch
    split over its dp axes (the module docstring); the output on ``x``'s
    device."""
    B, S, d = x.shape
    if mesh is None:
        out, aux = dispatch_compute(x.reshape(B * S, d), p["router"], p["w_gate"], p["w_up"],
                                    p["w_down"], cfg)
        out = out.reshape(B, S, d)
    else:
        out, aux = _expert_parallel(x, p, cfg, mesh)
    if cfg.num_shared_experts:
        out = out + swiglu_mlp(x, p, prefix="shared_")
    return out, aux


def _expert_parallel(x, p, cfg: ModelConfig, mesh):
    dp, tp = dp_axes(mesh), mesh.shape["model"]
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over model = {tp}")
    model_of = mesh.axis_index("model")

    def shard_fn(xs, routers, w_gates, w_ups, w_downs):
        outs, auxes = [], []
        for r, xl in enumerate(xs):
            o, a = dispatch_compute(xl.reshape(-1, xl.shape[-1]), routers[r], w_gates[r], w_ups[r],
                                    w_downs[r], cfg, rank=model_of[r], tp=tp)
            outs.append(o.reshape(xl.shape))
            auxes.append(a)
        outs = mesh.psum(outs, "model")
        auxes = mesh.pmean(auxes, "model")
        return outs, [a.reshape(1) for a in auxes]

    experts = P("model", None, None)
    fn = compat.shard_map(shard_fn, mesh=mesh,
                          in_specs=(P(dp, None, None), P(None, None), experts, experts, experts),
                          out_specs=(P(dp, None, None), P(dp)))
    out, per_shard = fn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    return out.to(x.device), _DataShardZero.apply(per_shard.to(x.device))
