"""Mixture-of-Experts FFN: sort-dispatch into a capacity-bounded buffer.

Port of ``repro/models/moe.py`` for one device.  The reference runs
``_local_dispatch_compute`` once per rank of its ``model`` axis, each rank
on a partition of the experts, and sums the ranks' partial outputs; on one
device that partition is every expert and the sum is the whole, so
:func:`moe_block` takes no mesh (expert parallelism comes with the sharding
helpers).

Routing is the reference's, step for step: a float32 router, softmax, the
top-k experts of each token (ties to the lower expert id, as
``jax.lax.top_k`` breaks them: a stable descending sort), gates normalised
by ``max(sum, 1e-9)``, the Switch aux loss ``E * sum(me * ce)``, and
``capacity = int(T*K/E * capacity_factor) + 1`` in Python floats.
Assignments are stably sorted by expert; an assignment's rank within its
expert's run (``cummax`` of the run starts) past the capacity is dropped:
it writes into a sacrificial last row of the ``[E*C + 1, d]`` buffer, which
is sliced off, and contributes nothing (its gate weight is lost, GShard
style).  The grouped SwiGLU runs in the activation dtype (SiLU in float32),
and the gated outputs are scatter-added in float32 (``index_add_``; on the
card a token's <= K contributions sum through atomics, so the result is not
bit-stable from run to run there) and cast back to the input's dtype.

Decode runs the block on one token a sequence, so there T is the batch and
the capacity is ``int(B*K/E * capacity_factor) + 1``: 1 for deepseek-v2 at
B = 4.  Assignments that collide then drop, as in the reference.
:func:`dropped_assignments` counts them, summed over calls since
:func:`reset_dropped` (a diagnostic, not a result); a training step's
recompute of a layer does not count them again (:func:`drops_not_counted`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu_mlp

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


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig) -> dict:
    """The routing of tokens ``x_flat`` [T, d]: ``gates``/``experts``
    [T, K] (float32, descending, experts int64); for the T*K assignments
    in expert-sorted order ``order`` (their flat index, token ``t * K +
    k``), ``slot`` (``e * C + rank``, or ``E * C`` when dropped) and
    ``kept``; ``capacity`` C; and ``aux``."""
    T = x_flat.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
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

    # rank within expert via a stable sort + run starts
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    idx = torch.arange(e_sorted.shape[0], device=x_flat.device)
    start = torch.ones_like(e_sorted, dtype=torch.bool)
    start[1:] = e_sorted[1:] != e_sorted[:-1]
    run_start = torch.cummax(torch.where(start, idx, -1), dim=0).values
    pos = idx - run_start
    kept = (e_sorted < E) & (pos < capacity)
    slot = torch.where(kept, e_sorted * capacity + pos, E * capacity)
    return dict(gates=gate_vals, experts=expert_idx, order=order, slot=slot, kept=kept,
                capacity=capacity, aux=aux)


def dispatch_compute(x_flat: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor, cfg: ModelConfig):
    """The reference's ``_local_dispatch_compute`` at one rank holding
    every expert: x_flat [T, d]; w_gate/w_up [E, d, f], w_down [E, f, d]
    -> (out [T, d] in x_flat's dtype, aux float32)."""
    T, d = x_flat.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = route(x_flat, router_w, cfg)
    C, order, slot, kept = r["capacity"], r["order"], r["slot"], r["kept"]
    dev = x_flat.device
    n_dropped = T * K - kept.sum()
    _dropped[dev] = _dropped[dev] + n_dropped if dev in _dropped else n_dropped

    tok = torch.div(order, K, rounding_mode="floor")  # the token of each sorted assignment
    buf = torch.zeros((E * C + 1, d), dtype=x_flat.dtype, device=dev)
    buf.index_copy_(0, slot, x_flat[tok])  # dropped rows land in the last row
    buf = buf[:-1].reshape(E, C, d)

    # grouped SwiGLU
    h = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    h = F.silu(h.float()).to(buf.dtype) * u
    y = torch.bmm(h, w_down.to(buf.dtype))

    # scatter-add gated outputs back to tokens, in float32
    y_flat = y.reshape(E * C, d)
    contrib = torch.where(kept[:, None], y_flat[torch.where(kept, slot, 0)], 0.0)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    out.index_add_(0, tok, contrib.float() * r["gates"].reshape(-1)[order][:, None])
    return out.to(x_flat.dtype), r["aux"]


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """x [B,S,d] -> ([B,S,d], aux loss).  p: ``router`` [d,E], ``w_gate``/
    ``w_up`` [E,d,f], ``w_down`` [E,f,d], and the shared experts' SwiGLU
    under the ``shared_`` prefix when the config has them."""
    B, S, d = x.shape
    out, aux = dispatch_compute(x.reshape(B * S, d), p["router"], p["w_gate"], p["w_up"],
                                p["w_down"], cfg)
    out = out.reshape(B, S, d)
    if cfg.num_shared_experts:
        out = out + swiglu_mlp(x, p, prefix="shared_")
    return out, aux
