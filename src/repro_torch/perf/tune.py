"""The LCS autotune sweep: measure the score stage's candidates and record
the winners in the tuning table (``repro_torch.perf.tuning``).

    python -m repro_torch.perf.tune --smoke [--device cpu] [--out PATH] [--repeats N]
    python -m repro_torch.perf.tune --full

Port of the JAX package's ``benchmarks/roofline.py --tune``.  For every
``(P, H, L)`` cell it builds one synthetic score-stage workload
(:func:`make_inputs`, numpy's RNG from a seed), computes the untuned LCS of
its ``[P*H, L]`` operands once, holds it against the plain version
(``kernels/lcs/kernel.lcs_plain``), then times every candidate:

  block_b          the cap on the LCS kernel's block.  Swept only where it
                   changes what runs: a cap is a candidate when the block it
                   launches at this (B, L) on this device differs from every
                   earlier candidate's (:func:`launched_block`); otherwise
                   the default 512 is kept rather than recording a
                   meaningless win.  On the CPU no kernel runs, so only 512.
  wavefront_dtype  int8 vs int32 anti-diagonal carries (int8 only where
                   L < 127, where the two are bit-identical).

Every candidate's output must be ``torch.equal`` to the untuned output
BEFORE it may win; a candidate that differs raises and nothing is written.
Timing: CUDA events around ``repeats`` calls after a warm-up on a card, the
host clock on the CPU.  Winners merge into the table loaded from the same
path for the same device kind (a stale table loads empty).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B
from repro_torch.core.similarity import repad
from repro_torch.kernels.lcs import ops as lcs_ops
from repro_torch.kernels.lcs.kernel import REGISTER_THREADS, lcs_plain, route, threads_for
from repro_torch.perf.tuning import LCSTuning, TuningTable, tuning_path

# the JAX sweep's grids: smoke covers the smoke bench's and the parity
# tests' shapes, full adds the paper-scale cells
SMOKE_GRID = ((1024, 3, 16), (4096, 3, 32))
FULL_GRID = ((1024, 3, 16), (4096, 3, 16), (4096, 3, 32), (16384, 3, 32), (4096, 5, 32))

DEFAULT_BLOCK_B = 512  # lcs_ops.lcs's default cap
BLOCK_CAPS = (128, 256, 512)


@dataclasses.dataclass(frozen=True)
class Trial:
    """One measured candidate of one cell (bit-identical to the untuned
    output: :func:`tune` raises on any other)."""

    block_b: int
    wavefront_dtype: str
    block: int | None   # threads per block launched; None: no kernel ran
    ms: float


@dataclasses.dataclass(frozen=True)
class Cell:
    """One swept cell: its shape, the recorded winner and every trial."""

    P: int
    H: int
    L: int
    winner: LCSTuning
    trials: tuple[Trial, ...]


def make_inputs(P, H, L, *, n_rows=None, seed=0, device=None):
    """A synthetic score-stage workload: a code table and a pair list.

    The JAX package's ``benchmarks/bench_score._make_inputs``, drawn in the
    same order from numpy's RNG: lengths skewed to a heavy short head, codes
    in [0, 30), pairs uniform.  Returns (codes [N, H, L], lengths [N],
    left [P], right [P], betas [H]) on ``device``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = n_rows or max(256, P // 8)
    w = 1.0 / np.arange(1, L + 1)
    lengths = rng.choice(np.arange(1, L + 1), size=N, p=w / w.sum()).astype(np.int32)
    codes = rng.integers(0, 30, size=(N, H, L)).astype(np.int32)
    pad = np.arange(L)[None, None, :] >= lengths[:, None, None]
    codes = np.where(pad, -1, codes)
    left = rng.integers(0, N, size=P).astype(np.int32)
    right = rng.integers(0, N, size=P).astype(np.int32)
    betas = np.full((H,), 1.0 / H, np.float32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (codes, lengths, left, right, betas))


def launched_block(B: int, L: int, block_b: int, device) -> int | None:
    """Threads per block that ``lcs(mode="auto", block_b=block_b)`` launches
    for B rows of width L on ``device``: the register route's fixed block,
    or the shared route's ``threads_for(L, _block_for(B, block_b))``; None
    on the CPU, where no kernel runs."""
    if torch.device(device).type != "cuda":
        return None
    if route(L) == "registers":
        return REGISTER_THREADS
    return threads_for(L, lcs_ops._block_for(B, block_b))


def block_candidates(B: int, L: int, device) -> tuple[int, ...]:
    """The default cap, then each cap of :data:`BLOCK_CAPS` that launches a
    block no earlier candidate launches."""
    cands = [DEFAULT_BLOCK_B]
    seen = {launched_block(B, L, DEFAULT_BLOCK_B, device)}
    for bb in BLOCK_CAPS:
        block = launched_block(B, L, bb, device)
        if block not in seen:
            cands.append(bb)
            seen.add(block)
    return tuple(cands)


def _time_ms(call, repeats: int, device) -> float:
    """Mean ms of ``call()`` over ``repeats`` runs after one warm-up: CUDA
    events on a card, the host clock on the CPU."""
    call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            call()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        call()
    return (time.perf_counter() - t0) * 1e3 / repeats


def tune(*, grid=None, smoke=False, full=False, repeats=3, out_path=None, device=None):
    """Sweep the LCS candidates on ``device`` (None: the card) and persist
    the winners.  ``grid`` is a sequence of (P, H, L) cells; None takes
    :data:`SMOKE_GRID` when ``smoke`` and not ``full``, else
    :data:`FULL_GRID`.  Returns (the table's path, one :class:`Cell` per
    cell)."""
    device = resolve_device(device)
    if grid is None:
        grid = SMOKE_GRID if smoke and not full else FULL_GRID
    path = Path(out_path) if out_path else tuning_path()
    table = TuningTable.load(path, device=device)
    cells = []
    for P, H, L in grid:
        codes, lengths, left, right, _ = make_inputs(P, H, L, device=device)
        a = repad(codes[left], lengths[left], PAD_CODE_A).reshape(P * H, L)
        b = repad(codes[right], lengths[right], PAD_CODE_B).reshape(P * H, L)
        ref = lcs_ops.lcs(a, b)
        if not torch.equal(ref, lcs_plain(a, b)):
            raise AssertionError(
                f"the untuned LCS diverges from the plain version at P={P} H={H} L={L}"
            )
        dtype_candidates = ("int8", "int32") if L < 127 else ("int32",)
        best, trials = None, []
        for bb in block_candidates(P * H, L, device):
            for dt_name in dtype_candidates:
                dt = torch.int8 if dt_name == "int8" else torch.int32

                def call(bb=bb, dt=dt):
                    return lcs_ops.lcs(a, b, block_b=bb, wavefront_dtype=dt)

                if not torch.equal(call(), ref):
                    raise AssertionError(
                        f"candidate block_b={bb} dtype={dt_name} diverges from the "
                        f"untuned default at P={P} H={H} L={L} — refusing to record it"
                    )
                ms = _time_ms(call, repeats, device)
                trials.append(Trial(bb, dt_name, launched_block(P * H, L, bb, device), ms))
                pps = P / (ms / 1e3)
                if best is None or pps > best[0]:
                    best = (pps, bb, dt_name)
        pps, bb, dt_name = best
        winner = LCSTuning(block_b=bb, wavefront_dtype=dt_name, pairs_per_sec=round(pps, 1))
        table.record(P, H, L, winner)
        cells.append(Cell(P, H, L, winner, tuple(trials)))
    table.save(path)
    return path, cells


def _main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="the two-cell grid (seconds)")
    ap.add_argument("--full", action="store_true", help="the paper-scale grid")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="tuning-table path (default: $REPRO_TORCH_TUNING_PATH "
                         "or <repo>/TUNING_torch.json)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()
    path, cells = tune(smoke=args.smoke, full=args.full, repeats=args.repeats,
                       out_path=args.out, device=args.device)
    for c in cells:
        for t in c.trials:
            print(f"P={c.P:<6d} H={c.H} L={c.L:<3d} block_b={t.block_b:<4d} "
                  f"dtype={t.wavefront_dtype:<5s} block={t.block} {t.ms:10.4f} ms bit-identical")
        t = c.winner
        print(f"P={c.P:<6d} H={c.H} L={c.L:<3d} -> block_b={t.block_b:<4d} "
              f"dtype={t.wavefront_dtype:<5s} {t.pairs_per_sec:>12.0f} pairs/s")
    print(f"wrote {path}")


if __name__ == "__main__":
    _main()
