"""The perf hypotheses' variants: each one's knobs set, measured on the card
at a few layers beside its derived roofline terms.

The counterpart of ``repro/launch/perf.py``.  ``VARIANTS`` is the
reference's list, as data: three targets (kimi-k2 and zamba2 ``train_4k``,
and the paper's own workload at N = 1,048,576 trajectories of 16 places),
each variant a config or environment delta with its hypothesis.  The
reference re-lowers each variant on 256 fake devices and re-derives XLA's
three terms; the port

* derives the terms of the variant's cell on the production mesh, as
  ``launch/dryrun.py`` derives a cell's (at the variant's ``grad_accum``;
  for the paper's workload from the reference's hand-set plan for 256
  shards: :func:`anotherme_plan`, :func:`derive_anotherme`), and labels
  them ``derived``;
* measures what fits on one card, with the knob set (``REPRO_RMSNORM``,
  ``REPRO_REMAT``, ``fused_gate_up``, ``ssm_chunk``, ``ssm_bf16_intra``,
  ``REPRO_LCS_DTYPE``, the shingle ``dedup``): an LM variant's training
  step at one layer period on the reference's per-device microbatch
  (8,192 tokens: 2 sequences of 4,096), and the paper's workload through
  ``core/distributed.py``'s pipeline on 4 shards of the card at the
  reference's plan for 4 shards (the plan caps the candidate pairs: at
  this world a shard's join finds ~1.4e9 pairs, so the run times the
  capped program the reference lowered, ``capped`` says so, and its
  overflow counters are recorded).  Measured: milliseconds (host clock
  after a sync, and the device time by kernel kind), peak device memory,
  and for the sharded run the mesh's collective bytes;
* records, for a variant whose one-period training state does not fit
  the card, the derived terms only, with the bytes that kept it off
  (:func:`train_state_bytes`).

    PYTHONPATH=src python -m repro_torch.launch.perf --derive-only   # no card
    PYTHONPATH=src python -m repro_torch.launch.perf --only zamba2   # on the card

Records go to ``build/launch/perf.json`` (``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import time
import traceback

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R

RESULTS = pathlib.Path("build/launch")
CARD_BYTES = 80e9  # the H100's device memory (80 GB)

VARIANTS = [
    # ---- target 1: kimi-k2 train_4k (most collective-bound cell) ---------
    dict(name="kimi/v0-baseline", arch="kimi-k2-1t-a32b", shape="train_4k",
         env={"REPRO_RMSNORM": "ref"},
         cfg={"fused_gate_up": False}, grad_accum=8,
         hypothesis="baseline: autodiff rmsnorm leaks f32 cotangents -> "
                    "f32 TP all-reduces; split gate/up -> 2 dx psums"),
    dict(name="kimi/v1-fused-rmsnorm", arch="kimi-k2-1t-a32b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": False}, grad_accum=8,
         hypothesis="custom-VJP rmsnorm keeps f32 local -> residual psums "
                    "drop to bf16: ~2x less all-reduce + less HBM traffic"),
    dict(name="kimi/v2-fused-gateup", arch="kimi-k2-1t-a32b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": True}, grad_accum=8,
         hypothesis="fused [d,2,f] gate-up: one column matmul -> one dx "
                    "psum instead of two on the shared-expert path"),
    dict(name="kimi/v3-accum2", arch="kimi-k2-1t-a32b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": True}, grad_accum=2,
         hypothesis="4x fewer microbatches -> 4x fewer FSDP expert-weight "
                    "gathers + re-reads; activation memory grows 4x"),
    dict(name="kimi/v4-remat-dots", arch="kimi-k2-1t-a32b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused", "REPRO_REMAT": "dots"},
         cfg={"fused_gate_up": True}, grad_accum=2,
         hypothesis="save matmul outputs instead of recomputing the whole "
                    "layer: HBM bytes + FLOPs of the remat-forward drop; "
                    "per-device live memory grows"),
    # ---- target 2: zamba2 train_4k (worst MFU-bound train cell) ----------
    dict(name="zamba2/v0-baseline", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "ref"},
         cfg={"fused_gate_up": False, "ssm_chunk": 128,
              "ssm_bf16_intra": False}, grad_accum=8,
         hypothesis="baseline: SSD intra-chunk f32 [H,Q,Q] decay/score "
                    "matrices dominate HBM bytes (prop. to S*Q)"),
    dict(name="zamba2/v1-fused-rmsnorm", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": False, "ssm_chunk": 128,
              "ssm_bf16_intra": False}, grad_accum=8,
         hypothesis="bf16 residual cotangents (as kimi/v1)"),
    dict(name="zamba2/v2-chunk64", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": True, "ssm_chunk": 64,
              "ssm_bf16_intra": False}, grad_accum=8,
         hypothesis="Q 128->64 halves intra-chunk quadratic bytes "
                    "(S*Q scaling); inter-chunk scan depth doubles "
                    "(cheap: states are [H,P,N])"),
    dict(name="zamba2/v3-bf16-intra", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": True, "ssm_chunk": 64,
              "ssm_bf16_intra": True}, grad_accum=8,
         hypothesis="bf16 decay/score matrices halve the remaining "
                    "intra-chunk bytes; log-cumsum stays f32 so decay "
                    "precision is preserved"),
    dict(name="zamba2/v4-no-head-repeat", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused"},
         cfg={"fused_gate_up": True, "ssm_chunk": 64,
              "ssm_bf16_intra": True}, grad_accum=8,
         hypothesis="v2/v3 were near-refuted: the f32 jnp.repeat of B/C to "
                    "80 heads dominated HBM bytes, not the Q^2 matrices. "
                    "Compute group scores once and let H enter only via "
                    "the decay -> the [.,H,N] repeats vanish"),
    # ---- target 3: the paper's own workload --------------------------------
    dict(name="anotherme/v0-baseline", arch="anotherme", shape="N=1M",
         env={}, cfg={"dedup": True, "lcs": "wavefront"}, grad_accum=1,
         hypothesis="baseline: per-row shingle dedup costs two [N_loc,560] "
                    "sorts per shard before the join"),
    dict(name="anotherme/v1-nodedup", arch="anotherme", shape="N=1M",
         env={}, cfg={"dedup": False, "lcs": "wavefront"}, grad_accum=1,
         hypothesis="skip per-row dedup: the pair-level dedup already "
                    "guarantees exactly-once scoring; join runs grow "
                    "slightly (repeated shingles are rare at L=16,Q=300) "
                    "but two full sorts disappear"),
    dict(name="anotherme/v2-int8-lcs", arch="anotherme", shape="N=1M",
         env={"REPRO_LCS_DTYPE": "int8"}, cfg={"dedup": True,
         "lcs": "wavefront"}, grad_accum=1,
         hypothesis="the LCS wavefront's scan carry ([P*levels, L+1] "
                    "diagonals x 63 steps) crosses the scan boundary each "
                    "step; int8 diagonals (LCS <= L < 127) cut that term "
                    "4x vs int32"),
    dict(name="zamba2/v5-remat-dots", arch="zamba2-2.7b", shape="train_4k",
         env={"REPRO_RMSNORM": "fused", "REPRO_REMAT": "dots"},
         cfg={"fused_gate_up": True, "ssm_chunk": 64,
              "ssm_bf16_intra": True}, grad_accum=8,
         hypothesis="zamba2 has 11GB/dev headroom: save matmul outputs "
                    "instead of full-layer recompute — the "
                    "rematted_computation re-reads (~10% of bytes) and "
                    "their FLOPs disappear"),
]

# the reference's per-device microbatch of train_4k: 256 x 4,096 tokens over
# 16 data shards in 8 microbatches
LM_MICRO_SEQS = 2
ANOTHERME_N, ANOTHERME_L, ANOTHERME_K, ANOTHERME_TYPES = 1_048_576, 16, 3, 300


@contextlib.contextmanager
def knobs(env: dict):
    """The variant's environment knobs, restored on exit."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# LM variants
# ---------------------------------------------------------------------------
def variant_config(v: dict):
    return dataclasses.replace(get_config(v["arch"]), **v["cfg"])


def train_state_bytes(cfg, grad_accum: int) -> dict:
    """Bytes one card holds for a training step of ``cfg`` (derived):
    bfloat16 weights and one microbatch's gradients, the moments at the
    reference's ``_opt_bits`` (float32, or int8 codes and a float32 scale a
    256-block), and float32 accumulators with ``grad_accum`` > 1."""
    from repro_torch.models.model import _leaves, param_shape_structs

    n, n_blocks = 0, 0
    for _, s in _leaves(param_shape_structs(cfg)):
        n += math.prod(s.shape)
        n_blocks += math.prod(s.shape[:-1]) * -(-s.shape[-1] // 256)
    moments = 2 * (n_blocks * 256 + 4 * n_blocks) if dryrun._opt_bits(cfg) == 8 else 8 * n
    out = {"weights": 2 * n, "gradients": 2 * n, "moments": moments,
           "accumulators": 4 * n if grad_accum > 1 else 0}
    out["total"] = sum(out.values())
    return out


def run_lm(v: dict, *, device=None, measure: bool = True) -> dict:
    cfg = variant_config(v)
    rec = dryrun.derive_cell(v["arch"], v["shape"], False, cfg=cfg, grad_accum=v["grad_accum"])
    one = dataclasses.replace(cfg, num_layers=dryrun._layer_period(cfg))
    need = train_state_bytes(one, v["grad_accum"])
    rec["derived"]["one_period_train_state_bytes"] = need
    if not measure:
        return rec
    if need["total"] > CARD_BYTES:
        rec["not_measured"] = (f"one layer period's training state is {need['total']:.4g} bytes, "
                               f"past the card's {CARD_BYTES:.4g}")
        return rec
    with knobs(v["env"]):
        rec["measured"] = dryrun.measure_cell(v["arch"], v["shape"], device=device, cfg=cfg,
                                              batch=LM_MICRO_SEQS)
    return rec


# ---------------------------------------------------------------------------
# the paper's workload
# ---------------------------------------------------------------------------
def anotherme_plan(n_traj: int, n_shards: int, L: int = ANOTHERME_L, k: int = ANOTHERME_K):
    """The reference's hand-set plan for ``n_shards`` (its probe sizes the
    shingle routes from the shingle count and caps the pairs)."""
    from repro_torch.core.distributed import DistributedPlan

    local_n = n_traj // n_shards
    S = math.comb(L, k)
    return DistributedPlan(
        n_shards=n_shards, local_n=local_n,
        shingle_route_cap=int(local_n * S / n_shards * 1.3) + 64,
        local_pair_cap=1 << 18, pair_route_cap=1 << 12, scored_cap=1 << 18,
    )


def anotherme_collective_bytes(plan, L: int = ANOTHERME_L, levels: int = 3) -> dict:
    """The operand bytes, summed over the shards, of the pipeline's
    collectives under ``plan`` (replicate mode): the shingle route's
    ``all_to_all`` of int32 (key, row) buckets, the pair route's of int32
    (lo, hi) buckets, and the ``all_gather`` of each shard's int32 codes
    [local_n, levels, L]."""
    n = plan.n_shards
    return {"all-reduce": 0, "collective-permute": 0,
            "all-to-all": n * 2 * 4 * n * (plan.shingle_route_cap + plan.pair_route_cap),
            "all-gather": n * plan.local_n * levels * L * 4}


def derive_anotherme(n_shards: int = 256, n_traj: int = ANOTHERME_N, L: int = ANOTHERME_L) -> dict:
    """The derived terms of the reference's 256-shard plan, a device: its
    collective operands (:func:`anotherme_collective_bytes`), the bytes of
    the buffers the program writes and reads once (places, codes, keys,
    both routes sent and received, the joined and scored pairs, the
    gathered codes of the scored pairs), and the DP cells of the scored
    pairs' LCS as int32 operations."""
    plan = anotherme_plan(n_traj, n_shards, L)
    S, levels = math.comb(L, ANOTHERME_K), 3
    coll = anotherme_collective_bytes(plan, L, levels)
    n = plan.n_shards
    touched = (plan.local_n * L * 4 + plan.local_n * levels * L * 4 + plan.local_n * S * 4
               + 2 * 2 * 4 * n * (plan.shingle_route_cap + plan.pair_route_cap)
               + 2 * 4 * plan.local_pair_cap + 2 * 4 * plan.scored_cap
               + plan.scored_cap * 2 * levels * L * 4)
    cells = plan.scored_cap * levels * L * L
    roof = R.Roofline.from_counts(cells, touched, sum(coll.values()) / n, model_flops=0.0, chips=n,
                                  peak_flops=R.H100_INT32_OPS)
    return {"plan": dataclasses.asdict(plan), "dp_cells_per_dev": cells,
            "collective_bytes_per_dev": {k: v / n for k, v in coll.items()}, "roofline": roof.as_dict()}


def measure_anotherme(v: dict, *, device=None, n_shards: int = 4, n_traj: int = ANOTHERME_N,
                      L: int = ANOTHERME_L, world=None, plan=None) -> dict:
    """The variant through ``core/distributed.py``'s pipeline on
    ``n_shards`` shards of ``device`` at ``plan`` (default:
    :func:`anotherme_plan`'s for them).  ``world``: (places, lengths,
    tables) to reuse."""
    from repro_torch.core import compat
    from repro_torch.core.device import resolve_device
    from repro_torch.core.distributed import make_distributed_anotherme
    from repro_torch.core.similarity import default_betas
    from repro_torch.core.types import PAD_ID

    device = resolve_device(device)
    places, lengths, tables = world or anotherme_world(n_traj, L, device)
    plan = plan or anotherme_plan(n_traj, n_shards, L)
    mesh = compat.make_mesh((n_shards,), ("ex",), devices=(device,) * n_shards)
    with knobs(v["env"]):
        run = make_distributed_anotherme(mesh, plan, tables=tables, k=ANOTHERME_K,
                                         num_types=ANOTHERME_TYPES, betas=default_betas(3, device=device),
                                         dedup=v["cfg"]["dedup"], lcs_impl=v["cfg"]["lcs"])
        R.reset_peak(device)
        mesh.reset_collective_bytes()
        out = {}
        prof = R.profile_device(lambda: out.update(run(places, lengths)), device)
    overflow = out["overflow"].long().sum(dim=0).tolist()
    return {"shards": n_shards, "plan": dataclasses.asdict(plan), "peak_bytes": R.peak_bytes(device),
            "collective_bytes": dict(mesh.collective_bytes),
            "overflow (join, pair route, scored)": overflow, "capped": any(overflow),
            "scored_pairs": int((out["left"] != PAD_ID).sum()), **prof}


def anotherme_world(n_traj: int = ANOTHERME_N, L: int = ANOTHERME_L, device=None):
    """The probe's world: trajectories of ``L`` places (fig13's generator at
    a fixed length) and the forest of 300 types x 10 classes over 10,000
    places."""
    from repro_torch.core.encoding import forest_tables, make_random_forest
    from repro_torch.data.synthetic import synthetic_trajectories

    batch = synthetic_trajectories(n_traj, min_len=L, max_len=L, device=device)
    tables = forest_tables(make_random_forest(ANOTHERME_TYPES, 10, 10_000), device=device)
    return batch.places, batch.lengths, tables


def run_variant(v: dict, *, device=None, measure: bool = True, world=None) -> dict:
    t0 = time.time()
    try:
        if v["arch"] == "anotherme":
            rec = {"derived": derive_anotherme()}
            if measure:
                rec["measured"] = measure_anotherme(v, device=device, world=world)
        else:
            rec = run_lm(v, device=device, measure=measure)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - a variant's failure is its record
        traceback.print_exc()
        rec = {"status": f"error: {type(e).__name__}: {str(e)[:300]}"}
    return {"name": v["name"], "hypothesis": v["hypothesis"], "env": v["env"], "cfg": v["cfg"],
            **rec, "elapsed_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="variants whose name contains this")
    ap.add_argument("--derive-only", action="store_true", help="no card: the derived terms only")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=str(RESULTS / "perf.json"))
    args = ap.parse_args(argv)
    chosen = [v for v in VARIANTS if not args.only or args.only in v["name"]]
    world = None
    if not args.derive_only and any(v["arch"] == "anotherme" for v in chosen):
        world = anotherme_world(device=args.device)
    records = []
    for v in chosen:
        print(f"=== {v['name']} ===", flush=True)
        rec = run_variant(v, device=args.device, measure=not args.derive_only, world=world)
        records.append(rec)
        roof = rec.get("derived", {}).get("roofline", {})
        print(json.dumps({"status": rec["status"], **{k: roof.get(k) for k in (
            "compute_s", "memory_s", "collective_s")}, "measured": rec.get("measured", {}).get("wall_ms")}),
            flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    main()
