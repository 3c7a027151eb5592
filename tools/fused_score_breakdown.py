#!/usr/bin/env python3
"""Where the fused LCS scorers' time goes, on one card.

    python3 tools/fused_score_breakdown.py

Builds the engine's own pair buffers on the card — the main path's (fig13's
world, N = 1,000,000 trajectories, L = 10, 2^28 slots) and the
subtrajectory path's (N = 100,000, rows of 10-20 places, W = 8) — and times
the scorers' kernels there through the variant launchers
(``fused.launch_variant``: both routes at the path's width, and template
instantiations of the same sources that no engine path calls), CUDA events
over 10 launches an event pair, median of 5, two rounds in turns:

- ``registers``: the kernel as the engine launches it (its error against
  the plain version on the first 2^22 slots and on 2^22 slots across the
  count is printed);
- ``no_identity``: the DP on every pair, the identical ones included;
- ``stop_at_wla``: the row loop stopped at the a side's length (all rows
  when b holds a valid -1);
- ``shared``: the shared-memory route forced at the path's width;
- ``shared_no_identity``: the parent design (the shared route, the DP on
  every pair);
- ``loads_only``: the loads and stores with no DP (a wrong LCS on purpose);
- ``registers T=t``: the kernel at t threads a block;
- ``wrapper``: ``fused_gather_score`` (``fused_windowed_gather_score``) with
  its checks, one call an event pair.

Prints the card's name and power limit first, and every number as one JSON
object on the last line.  Needs nvcc and a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.api import AnotherMeEngine, EngineConfig  # noqa: E402
from repro_torch.core.encoding import encode_batch  # noqa: E402
from repro_torch.core.ssh import ssh_candidates  # noqa: E402
from repro_torch.core.subtraj import window_coords  # noqa: E402
from repro_torch.core.types import PAD_ID  # noqa: E402
from repro_torch.data import synthetic_setup  # noqa: E402
from repro_torch.kernels.lcs import fused  # noqa: E402

VARIANTS = fused.ROUTES + tuple(fused.VARIANTS)
THREADS = (64, 256, 512)


def time_ms(fn, reps=5, batch=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return sorted(times)[len(times) // 2]


def engine_buffer(dev, n, window=None, **rows):
    """The engine's candidate buffer and the scorer's operands for it."""
    batch, forest = synthetic_setup(n, num_types=300, seed=0, device=dev, **rows)
    engine = AnotherMeEngine(forest, EngineConfig(rho=2.0, lcs_impl="fused", subtraj_window=window),
                             device=dev)
    enc = encode_batch(batch, engine.tables)
    keys = engine.backend.join_keys(enc, batch, engine.backend_ctx)
    cap = engine.planner.initial_capacity(engine.backend.expected_pairs(keys))
    cand, cap = engine.planner.run_with_retry(lambda c: ssh_candidates(keys, pair_capacity=c), cap)
    del keys
    count = int(cand.count)
    if window is None:
        li = torch.where(cand.left == PAD_ID, 0, cand.left)
        ri = torch.where(cand.right == PAD_ID, 0, cand.right)
        ops = (enc.codes, enc.lengths, enc.codes, enc.lengths, li, ri, engine.betas)
    else:
        from repro_torch.core.subtraj import num_windows

        nw = num_windows(enc.codes.shape[2], window)
        ta, oa = window_coords(cand.left, nw=nw)
        tb, ob = window_coords(cand.right, nw=nw)
        ops = (enc.codes, enc.lengths, enc.codes, enc.lengths, ta, tb, oa, ob, engine.betas)
    return tuple(t.contiguous() for t in ops), count, cap


def breakdown(name, ops, count, window):
    P, H = ops[4].shape[0], ops[0].shape[1]
    lvl = torch.empty((P, H), dtype=torch.int32, device=ops[0].device)
    mss = torch.empty((P,), dtype=torch.float32, device=ops[0].device)
    kw = {} if window is None else {"window": window}
    plain = fused.fused_gather_score_plain if window is None else fused.fused_windowed_gather_score_plain
    wrapper = fused.fused_gather_score if window is None else fused.fused_windowed_gather_score
    n_ops = len(ops)

    def part(s):
        return [t[s] if 4 <= i < n_ops - 1 else t for i, t in enumerate(ops)]

    fused.launch_variant("registers", ops, lvl, mss, **kw)
    errs = []
    for s in (slice(0, 1 << 22), slice(max(0, count - (1 << 21)), count + (1 << 21))):
        want_lvl, want_mss = plain(*part(s), **kw)
        errs.append(max(float((lvl[s] - want_lvl).abs().max()), float((mss[s] - want_mss).abs().max())))
    print(f"{name}: {P} slots, count {count}; registers vs plain, max |error| on the head and across "
          f"the count: {errs}", flush=True)

    def run(variant, threads=None):
        return lambda: fused.launch_variant(variant, ops, lvl, mss, threads=threads, **kw)

    rounds = []
    for rnd in range(2):
        order = VARIANTS if rnd == 0 else VARIANTS[::-1]
        row = {v: time_ms(run(v), batch=10 if v not in ("shared", "shared_no_identity") else 3)
               for v in order}
        row.update({f"registers T={t}": time_ms(run("registers", t)) for t in THREADS})
        row["wrapper"] = time_ms(lambda: wrapper(*ops, **kw), batch=1)
        rounds.append(row)
        print(f"{name} round {rnd} (ms): " + "; ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    return dict(slots=P, count=count, max_abs_err=errs, rounds=rounds)


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_score_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    result = {"card": card}
    ops, count, cap = engine_buffer(dev, 1_000_000)
    print(f"main buffer built in {time.perf_counter() - t0:.1f} s (capacity {cap})", flush=True)
    result["fused_gather_score"] = breakdown("fused_gather_score main N=1000000", ops, count, None)
    del ops
    torch.cuda.empty_cache()
    ops, count, cap = engine_buffer(dev, 100_000, window=8, min_len=10, max_len=20)
    result["fused_windowed_gather_score"] = breakdown(
        "fused_windowed_gather_score subtraj N=100000 W=8", ops, count, 8)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
