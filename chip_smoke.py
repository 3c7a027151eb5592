#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``; nothing of ``repro`` or ``jax``) in
phases, and exits non-zero if any phase fails:

1. device  — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build   — compiles every kernel source with nvcc for sm_90a, in parallel.
3. kernels — each Hopper kernel against its plain PyTorch version on the
   card, bit-equal, at edge shapes and at the main path's shapes.
4. fig1    — the paper's Fig. 1 story through the fused kernel.
5. small   — a 3,000-trajectory world on the card (kernel impls) against the
   plain CPU engine: identical similar pairs, communities and scores.
6. main    — the one-shot SSH engine on the paper's scalability world
   (1,000,000 trajectories, 300 types) with ``lcs_impl="fused"``; a
   1M-pair slice of its scored buffer is re-scored by the plain version.
7. kernel  — 200,000 trajectories with ``lcs_impl="kernel"`` and "fused":
   equal similar pairs and communities.
8. timing  — each kernel and its plain version on the main path's inputs
   (CUDA events), beside the least time the card could take.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each engine run and read just after, and a path whose kernel was
never launched fails.  The second-to-last line is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# Published H100 SXM figures.  HBM bandwidth is the data sheet's.  The data
# sheet lists no int32 rate, so the rate of the LCS kernels' integer DP work
# (one operation per DP cell) is built from the H100 architecture paper:
# 132 SMs x 64 int32 lanes per SM x the 1,980 MHz boost clock, one operation
# per lane per clock = 16.7 T/s (the same count with 128 fp32 lanes and an
# FMA as 2 gives the data sheet's 67 TFLOP/s fp32).
HBM_BYTES_PER_S = 3.35e12
H100_SMS = 132
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = H100_SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ

MAIN_N = 1_000_000
KERNEL_N = 200_000
SMALL_N = 3_000
NUM_TYPES = 300
RHO = 2.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def expect_launched(counts: dict, names):
    for name in names:
        check(counts[name] > 0, f"kernel {name} was not launched on this path")


# ---------------------------------------------------------------------------
def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    log(out[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return out[0]


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas[{name}]: {line.strip()}")
    log(f"build: {len(logs)} sources in {secs:.2f} s")


def phase_kernels(torch, dev, table_shape=(MAIN_N, 3, 10), pairs=4_000_037, big_b=1_048_573):
    """Each kernel against its plain version, bit-equal."""
    import numpy as np

    from repro_torch.core.similarity import lcs_ref
    from repro_torch.kernels.lcs import fused, kernel, ops

    rng = np.random.default_rng(0)

    def rows(B, L, alphabet=6):
        la = rng.integers(1, L + 1, size=B)
        lb = rng.integers(1, L + 1, size=B)
        a = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
        b = rng.integers(0, alphabet, size=(B, L)).astype(np.int32)
        a[np.arange(L)[None, :] >= la[:, None]] = -1
        b[np.arange(L)[None, :] >= lb[:, None]] = -2
        return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)

    same = torch.full((4096, 10), 7, dtype=torch.int32, device=dev)
    cases = {
        "odd_batch_B12345_L10": rows(12_345, 10),
        "L1": rows(5_001, 1),
        "L10": rows(100_003, 10),
        "L126": rows(20_011, 126, alphabet=3),
        "identical": (same, same),
        f"random_B{big_b}_L10": rows(big_b, 10),
    }
    for name, (a, b) in cases.items():
        got = ops.lcs(a, b, mode="pallas")
        want = kernel.lcs_plain(a, b)
        check(torch.equal(got, want), f"lcs kernel != plain on {name}")
        if a.shape[0] * a.shape[1] ** 2 <= 2_000_000:
            check(torch.equal(got, lcs_ref(a, b)), f"lcs kernel != lcs_ref on {name}")
        log(f"lcs {name}: bit-equal to plain ({a.shape[0]} rows)")
    check(bool((ops.lcs(same, same, mode="pallas") == 10).all()), "identical rows must give L")

    N, H, L = table_shape
    lengths = torch.as_tensor(rng.integers(5, L + 1, size=N).astype(np.int32), device=dev)
    codes = torch.as_tensor(rng.integers(0, 30, size=table_shape).astype(np.int32), device=dev)
    pos = torch.arange(L, device=dev)
    codes = torch.where(pos < lengths[:, None, None], codes, -1)
    betas = torch.full((H,), 1.0 / H, dtype=torch.float32, device=dev)
    for P in (1, 4097, pairs):
        left = torch.as_tensor(rng.integers(0, N, size=P).astype(np.int32), device=dev)
        right = torch.as_tensor(rng.integers(0, N, size=P).astype(np.int32), device=dev)
        lvl, mss = fused.fused_gather_score(codes, lengths, codes, lengths, left, right, betas)
        want_lvl, want_mss = fused.fused_gather_score_plain(
            codes, lengths, codes, lengths, left, right, betas
        )
        check(torch.equal(lvl, want_lvl), f"fused level_lcs != plain at P={P}")
        epilogue_equal = torch.equal(mss, want_mss)
        check(epilogue_equal, f"fused kernel mss epilogue != mss_scores at P={P}")
        ex_lvl, ex_mss = fused.fused_score(codes, lengths, codes, lengths, left, right, betas,
                                           mode="pallas", exact_mss=True)
        check(torch.equal(ex_lvl, lvl) and torch.equal(ex_mss, want_mss), "exact_mss path differs")
        log(f"fused P={P} table={tuple(codes.shape)}: level_lcs bit-equal, "
            f"kernel mss epilogue (exact_mss=False) bit-equal to mss_scores: {epilogue_equal}")


def _engine(dev, forest, impl, **cfg):
    from repro_torch.api import AnotherMeEngine, EngineConfig

    return AnotherMeEngine(forest, EngineConfig(backend="ssh", lcs_impl=impl, **cfg), device=dev)


def _run_counted(engine, batch):
    """Run the engine with every launch count set to 0 just before it;
    returns (result, launch counts of this run)."""
    from repro_torch.kernels.lcs import fused, kernel

    kernel.lcs_kernel.launches = 0
    fused.fused_gather_score.launches = 0
    res = engine.run(batch)
    counts = {"lcs_kernel": kernel.lcs_kernel.launches,
              "fused_gather_score": fused.fused_gather_score.launches}
    return res, counts


def phase_fig1(dev):
    from repro_torch.data import fig1_world

    batch, forest = fig1_world(device=dev)
    res, counts = _run_counted(_engine(dev, forest, "fused", rho=3.0), batch)
    expect_launched(counts, ["fused_gather_score"])
    check((0, 1) in res.similar_pairs, "Carol should find her other me!")
    check(res.communities == {frozenset({0, 1})}, f"fig1 communities {res.communities}")
    log(f"fig1: similar {sorted(res.similar_pairs)}, launches {counts}: "
        "Carol found another her across the world")


def _same_result(got, want, what):
    import torch

    check(got.similar_pairs == want.similar_pairs, f"{what}: similar pairs differ")
    check(got.communities == want.communities, f"{what}: communities differ")
    for field in ("left", "right", "level_lcs", "mss"):
        g, w = getattr(got.scored, field).cpu(), getattr(want.scored, field).cpu()
        check(torch.equal(g, w), f"{what}: scored {field} differs")


def phase_small(torch, dev, n=SMALL_N):
    """The card's kernel impls against the plain engine on the CPU."""
    from repro_torch.data import synthetic_setup

    cpu_batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    want = _engine("cpu", forest, "wavefront", rho=RHO).run(cpu_batch)
    batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    for impl, kern in (("fused", "fused_gather_score"), ("kernel", "lcs_kernel"),
                       ("pallas", "lcs_kernel"), ("fused-pallas", "fused_gather_score")):
        res, counts = _run_counted(_engine(dev, forest, impl, rho=RHO), batch)
        expect_launched(counts, [kern])
        _same_result(res, want, f"small {impl}")
    check(len(want.similar_pairs) > 0, "small world has no similar pairs")
    log(f"small: N={n} card impls == CPU plain engine "
        f"({want.stats['num_candidates']} candidates, {len(want.similar_pairs)} similar)")


def _stats_line(tag, res, counts):
    s = res.stats
    keys = ("t_encode", "t_keys", "t_join", "t_score", "t_communities", "t_total")
    times = " ".join(f"{k}={s[k]:.3f}s" for k in keys)
    log(f"{tag}: {times}")
    log(f"{tag}: num_candidates={s['num_candidates']} pair_capacity={s['pair_capacity']} "
        f"join_overflow={s['join_overflow']} num_similar={s['num_similar']} "
        f"num_communities={s['num_communities']} launches={counts}")


def phase_main(torch, dev, n=MAIN_N, slice_pairs=1 << 20):
    from repro_torch.core.encoding import encode_batch
    from repro_torch.core.types import PAD_ID
    from repro_torch.data import synthetic_setup
    from repro_torch.kernels.lcs import fused

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    engine = _engine(dev, forest, "fused", rho=RHO)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, counts = _run_counted(engine, batch)
    wall = time.perf_counter() - t0
    expect_launched(counts, ["fused_gather_score"])
    _stats_line(f"main N={n}", res, counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    log(f"main: run wall {wall:.3f}s, peak device memory {peak:.2f} GiB")

    sc = res.scored
    P, H = sc.level_lcs.shape
    check(sc.mss.shape == (P,) and P == res.stats["pair_capacity"], "scored buffer shape")
    check(bool(torch.isfinite(sc.mss).all()), "non-finite mss")
    valid = sc.left != PAD_ID
    check(int(valid.sum()) == int(sc.count) == res.stats["num_candidates"] > 0, "pair count")
    check(bool((sc.left[valid] < sc.right[valid]).all()), "pairs not canonical")
    check(int(sc.overflow) == 0, "join overflowed")
    n_similar = int((valid & (sc.mss > RHO)).sum())
    check(n_similar == len(res.similar_pairs), "similar set disagrees with mss > rho")
    check(int(sc.level_lcs.max()) <= 10 and int(sc.level_lcs.min()) >= 0, "LCS out of range")

    # re-score a 1M-pair slice of the buffer with the plain version
    enc = encode_batch(batch, engine.tables)
    li = torch.where(sc.left == PAD_ID, 0, sc.left)
    ri = torch.where(sc.right == PAD_ID, 0, sc.right)
    s = slice(0, min(slice_pairs, P))
    want_lvl, want_mss = fused.fused_gather_score_plain(
        enc.codes, enc.lengths, enc.codes, enc.lengths, li[s], ri[s], engine.betas
    )
    check(torch.equal(sc.level_lcs[s], want_lvl), "main: level_lcs slice != plain")
    check(torch.equal(sc.mss[s], want_mss), "main: mss slice != plain")
    log(f"main: slice of {s.stop} scored pairs bit-equal to the plain version")
    main_inputs = (enc.codes, enc.lengths, li, ri, engine.betas)
    return res, counts, main_inputs


def phase_kernel_path(torch, dev, n=KERNEL_N):
    from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B, encode_batch, forest_tables
    from repro_torch.core.similarity import repad
    from repro_torch.core.types import PAD_ID
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    kres, kcounts = _run_counted(_engine(dev, forest, "kernel", rho=RHO), batch)
    expect_launched(kcounts, ["lcs_kernel"])
    _stats_line(f"kernel-path N={n} lcs_impl=kernel", kres, kcounts)
    fres, fcounts = _run_counted(_engine(dev, forest, "fused", rho=RHO), batch)
    expect_launched(fcounts, ["fused_gather_score"])
    _stats_line(f"kernel-path N={n} lcs_impl=fused", fres, fcounts)
    _same_result(kres, fres, f"N={n} kernel vs fused")
    log(f"kernel-path: lcs_impl=kernel == lcs_impl=fused at N={n}")
    # the [P*H, L] operands the "kernel" impl hands the LCS kernel
    enc = encode_batch(batch, forest_tables(forest, device=dev))
    sc = kres.scored
    li = torch.where(sc.left == PAD_ID, 0, sc.left)
    ri = torch.where(sc.right == PAD_ID, 0, sc.right)
    L = enc.codes.shape[2]
    a = repad(enc.codes[li], enc.lengths[li], PAD_CODE_A).reshape(-1, L)
    b = repad(enc.codes[ri], enc.lengths[ri], PAD_CODE_B).reshape(-1, L)
    return kcounts, (a, b)


def _time_ms(torch, fn, reps=5):
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(torch, main_inputs, main_counts, kernel_operands, kernel_counts):
    from repro_torch.kernels.lcs import fused, kernel

    entries = []
    codes, lengths, li, ri, betas = main_inputs
    P, H, L = li.shape[0], codes.shape[1], codes.shape[2]
    run = lambda: fused.fused_gather_score(codes, lengths, codes, lengths, li, ri, betas)  # noqa: E731
    ms = _time_ms(torch, run)
    lvl, mss = run()
    chunk = 1 << 22

    def plain():
        for s in range(0, P, chunk):
            fused.fused_gather_score_plain(
                codes, lengths, codes, lengths, li[s:s + chunk], ri[s:s + chunk], betas
            )

    plain_ms = _time_ms(torch, plain, reps=1)
    want_lvl, want_mss = fused.fused_gather_score_plain(
        codes, lengths, codes, lengths, li[:chunk], ri[:chunk], betas
    )
    err = max(float((lvl[:chunk] - want_lvl).abs().max()),
              float((mss[:chunk] - want_mss).abs().max()))
    # each input read once (the table and lengths are one tensor passed for
    # both sides), each output written once; one op per DP cell
    nbytes = (codes.numel() + lengths.numel() + 2 * P + H) * 4 + P * (H + 1) * 4
    bound, by = _bound_ms(nbytes, P * H * L * L)
    entries.append(dict(
        name="fused_gather_score", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_score.cu",
        replaces="src/repro/kernels/lcs/fused.py:202",
        launches=main_counts["fused_gather_score"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        path=f"main: SSH engine N={MAIN_N} lcs_impl=fused",
        shape=f"table {list(codes.shape)} pairs {P}",
    ))
    log(f"timing fused_gather_score: {ms:.3f} ms (plain {plain_ms:.3f} ms in {chunk}-pair "
        f"chunks, bound {bound:.3f} ms by {by}); library_ms: no single PyTorch call "
        "computes an LCS")

    a, b = kernel_operands
    B, L = a.shape
    run = lambda: kernel.lcs_kernel(a, b, block_b=512)  # noqa: E731
    ms = _time_ms(torch, run)
    plain_ms = _time_ms(torch, lambda: kernel.lcs_plain(a, b), reps=3)
    err = float((run() - kernel.lcs_plain(a, b)).abs().max())
    bound, by = _bound_ms(B * (2 * L * 4 + 4), B * L * L)
    entries.append(dict(
        name="lcs_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/lcs.cu",
        replaces="src/repro/kernels/lcs/kernel.py:100",
        launches=kernel_counts["lcs_kernel"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        path=f"SSH engine N={KERNEL_N} lcs_impl=kernel",
        shape=f"rows {B} x L {L}",
    ))
    log(f"timing lcs_kernel: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
        f"by {by}); library_ms: no single PyTorch call computes an LCS")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch

    check(Path(repro_torch.__file__).resolve().is_relative_to(SRC), "imported a foreign repro_torch")
    dev = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    phase_kernels(torch, dev)
    phase_fig1(dev)
    phase_small(torch, dev)
    _, main_counts, main_inputs = phase_main(torch, dev)
    kernel_counts, kernel_operands = phase_kernel_path(torch, dev)
    entries = phase_timing(torch, main_inputs, main_counts, kernel_operands, kernel_counts)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
