#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``; nothing of ``repro`` or ``jax``) in
phases, and exits non-zero if any phase fails:

1. device  — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. build   — compiles every kernel source with nvcc for sm_90a, in parallel;
   logs each source's build seconds and ptxas report, and requires HGMMA
   (wgmma) instructions in the SASS of both tensor-core libraries (flash
   attention and the SSD intra-chunk step), no spill and no serialized
   wgmma in flash attention's instantiations past head dim 128 (logging
   every instantiation's registers and spills), no shared or local memory
   instruction in the fused scorers' register kernels at the paths' widths
   and no local memory (spill) instruction in the batched LCS kernel's
   register kernels at 10 and 8 (whose DP instructions a cell it counts for
   all three).
3. kernels — each Hopper kernel against its plain PyTorch version on the
   card, bit-equal, at edge shapes and at the main path's shapes (the batched
   LCS kernel at widths either side of its routes, ragged and unaligned
   batches, and its route counts); the fused
   scorers also on identical pairs (with and without codes equal to the
   side sentinels), a PAD tail, two tables with iota indices and the
   shared-memory route.
4. fig1    — the paper's Fig. 1 story through the fused kernel.
5. small   — a 3,000-trajectory world on the card (kernel impls) against the
   plain CPU engine: identical similar pairs, communities and scores.
5a. sharded small — ``ExecutionPlan(n_shards=n, devices=(card,) * n)``, every
   shard on the card: Fig. 1 on two shards; the small world (and a
   2,000-trajectory world of 10-20 places for windows of 8) at 2, 4 and 8
   shards, "ssh", "minhash" (#5), "brp" and "udf", replicate and shuffle,
   the prune (at rho 5.5, which the bound min(len) can miss) and
   ``overlap_chunks`` 1 and 4, "fused" (#1/#3) and "kernel" (#2), and
   shrunken capacities that must retry: every per-shard output bit-equal
   to the same plan on CPU shards (plain versions), similar pairs and
   communities equal to the card's one-shard engine; no shard off the card.
6. main    — the one-shot SSH engine on the paper's scalability world
   (1,000,000 trajectories, 300 types) with ``lcs_impl="fused"``, on the
   register route; 1M-pair slices of its scored buffer, at its head and
   across its count into the PAD tail, are re-scored by the plain version;
   the score stage is split into the PAD clamp, the kernel, the
   ``exact_mss`` recompute and the host's mask and pair set.
6a. sharded — the main world on four shards of the card, replicate,
   "fused" (#1 once a shard), components: similar pairs and the scored
   (pair, level_lcs, mss) set equal the main run's; phase seconds, plan,
   retries and peak memory logged.
6b. sharded shuffle — 200,000 trajectories, shuffle mode with the prune and
   four chunks on four shards, against the one-shard engine with the prune
   (similar pairs, communities, the scored set, the pruned count).  Cut
   from 1M: past the exact-pair limit this plan takes the uniform bound,
   which retries twice at 200,000 (doubling every buffer twice); at 1M
   (82.6M scored slots a shard) the hop buckets so doubled would hold
   ~85 GB of code rows, past the card's 80 GB.
7. kernel  — 200,000 trajectories with ``lcs_impl="kernel"`` and "fused":
   equal similar pairs and communities; the LCS kernel on its register
   route.
8. subtraj — the subtrajectory mode (``subtraj_window=8``) on fig13's
   forest with trajectories of 10-20 places: 2,000 trajectories (W = 8 and
   W >= L) against the plain "wavefront" engine on the card; 100,000
   trajectories with ``lcs_impl="fused"`` (1M-pair slices of the window
   buffer, at its head and across its count, re-scored by the plain
   version); 20,000 with "kernel" against "fused" (the LCS kernel on its
   register route at W = 8).
8a. sharded subtraj — the subtrajectory world (100,000, W = 8) on four
   shards, replicate, "fused" (#3 once a shard): the folded scored buffer,
   similar pairs and communities equal the one-shard run's.
9. shingle — the public ``shingle_keys`` op (which neither engine calls) on
   the main world's type codes, counted, and the kernel against its plain
   version there, on the subtrajectory world's window view and at edge
   shapes (rows wider than 32, orders 1-9, a wrapping base, s_pad not a
   multiple of 4 and of 256).
10. timing — each kernel and its plain version on its path's inputs (CUDA
   events), beside the least time the card could take; the fused scorers
   also by the launch alone (ten an event pair), against the shared-memory
   route and the parent design in the same run, and beside the bound of
   the DP cells these inputs need; the batched LCS kernel by the launch
   alone on both kernel paths' operands against its shared route (the
   parent design) and its loads alone; the shingle kernel by the launch
   alone against the parent design and its loads and stores alone.
11. minhash kernel — the MinHash kernel against its plain version, bit-equal,
   at edge shapes, on the main world's type codes and on the subtrajectory
   world's window view.
12. baselines — the paper's baselines on the card: "minhash", "brp" and
   "udf" on the small world (and "minhash" in the subtrajectory mode)
   against the plain CPU engine; fig10's accuracy world (2,000
   trajectories): the port's centralized truth, QA1/QA2 of "ssh" (exactly
   1.000), "minhash" and "brp" (their whole results equal to the CPU
   engine's; "minhash" also through
   ``run_anotherme(candidate_fn=minhash_candidates)``), and
   ``udf_pipeline`` at fig7's 1,500 against the centralized set; "minhash"
   on the scalability world at 1,000,000 trajectories (band keys against the
   plain signatures', a slice re-scored); "brp" at 50,000 (the card's keys
   against the CPU's); the centralized baseline at 10,000 against the SSH
   engine (the paper's lossless claim); the MinHash kernel timed as the
   fused scorers are, by the launch alone too.
13. stream small — ``StreamingEngine`` on 3,000 trajectories in 5
   micro-batches (a window of 3 updates, a TTL of 2 on one batch, an
   explicit retire, a compaction) on the card against the same stream on
   the CPU with plain versions, at every update: the scored buffer slot by
   slot, the similar pairs and the communities; for "unionfind" and "jit"
   components, cliques, ``score_prune``, the "ssh", "minhash" (#5 keys) and
   "brp" backends, "fused" (#1) and "kernel" (#2), and once under
   ``REPRO_FAULT_INJECT=1``.
14. stream — fig13's world, 200,000 trajectories as 10 micro-batches of
   20,000 with a window of 4 updates (compaction from update 6 on) and 1%
   of the live ids retired after update 7, "fused", union-find components:
   the final update equals a one-shot engine run on the card over the
   survivors (similar pairs, communities and the scored (pair, level_lcs,
   mss) set, ids mapped); each update's phase seconds and resident bytes
   are logged.  A 20,000-row stream of the same shape with ("jit",
   "kernel") equals ("unionfind", "fused").
15. serve — ``QueryEngine(stream, k=10)`` over that final world answers
   1,000 fresh trajectories and 1,000 live rows, with ``serve_prune`` off
   and on, at k = 10 and with per-query k and rho, each against a
   whole-live-world brute force (every (query, live row) pair scored by #1,
   ranked with numpy ``lexsort`` by (mss desc, row asc); a 1M-pair slice
   re-scored by the plain version); prune on equals prune off; queries per
   second, rounds and cells skipped are logged.
16. stream device small — the stream small phase's streams (minus the
   cliques ones) with ``ExecutionPlan(delta_join="device")``: the join, its
   dedup and the slab on the card; at every update equal to the same
   device-join stream on the CPU and to the card's host-join stream (the
   scored buffer slot by slot, similar pairs, communities, pairs examined
   less the slab's tombstones), with no pair row crossing from the host;
   "unionfind" and "jit", ``score_prune``, "ssh", "minhash" (#5) and "brp",
   "fused" (#1) and "kernel" (#2), and ``REPRO_FAULT_INJECT=1`` with at
   least one join retry.
17. stream device — the stream phase's world and schedule with the device
   join: every update examines the host join's pairs plus the slab's
   tombstones, and the final update equals the host join's result (scored
   buffer slot by slot, similar pairs, communities) and the one-shot run
   over the survivors.  Each update logs its phase seconds, the join's
   split between the host mirror (planning and commit) and the join
   function (CUDA events), the slab, the resident bytes, the bytes and key
   rows shipped, the mirror's keys and the build counts.
18. serve device — the serve phase's query batches over that device-join
   world: every answer equals the host-join world's, and the host index is
   never probed; queries per second and probe counts are logged.
18a. stream sharded small — the stream small phase's feed on 2, 3 and 4
   shards of the card (``ExecutionPlan(n_shards=n, devices=(card,) * n)``):
   the host join in replicate and shuffle (``overlap_chunks`` 1 and 4), the
   device join in replicate and shuffle with ``score_prune``, "fused" (#1),
   "kernel" (#2) and "minhash" (#5) once; at every update equal to the
   card's one-shard stream of the same join (scored buffer slot by slot,
   similar pairs, communities, pairs examined) and to the same plan on CPU
   shards (plain versions).
18b. stream sharded — the stream phase's feed on four shards, host join,
   replicate, "fused" (#1 once a shard an update): every update examines
   the one-shard stream's pairs and the final update equals its result;
   per-update phase seconds and peak device memory logged.
18c. serve sharded — the serve phase's query batches over that world: every
   answer equals the one-shard world's; queries per second, rounds and
   cells skipped logged.
18d. stream device sharded — the same feed on four shards with the device
   join, shuffle, ``overlap_chunks=4``: every update equals the one-shard
   device join's pairs examined, the final update its result; the join's
   split (host mirror against the join program), slabs, resident bytes,
   peak memory and the output stack of the merged slabs (ms, bytes) logged.
18e. serve device sharded — the serve phase's batches over that world,
   against the one-shard world's answers.
18f. tune — the LCS sweep (``repro_torch.perf.tune``) on the card, its smoke
   grid and one cell on the LCS kernel's shared route (L = 40), into a
   scratch table: each candidate's launched block, time and bit-identity,
   the winner; the table loads back under the card's header and a
   CPU-headed table loads empty on the card.
18g. autotune — ``autotune=True`` against the untuned run on the GeoLife
   surrogate cut to 2,000 trajectories, with a table holding a record for
   the one-shot run's exact (P, H, L): one shard ("kernel", #2, and
   "fused", #1; ``plan_tuning`` returns the record), four shards of the card
   (replicate and shuffle, the runner built with the record), and a 4-update
   host-join and device-join stream: scored buffers slot by slot, similar
   pairs, communities and build counts equal.
18h. geolife — the GeoLife surrogate at the paper's full scale (182 users,
   17,621 trajectories, rho 3.0), "fused" (#1), components: phase seconds,
   pair capacity, candidates, similar pairs, peak memory, a 2^20-pair slice
   re-scored by the plain version; fig11's quick grid (60 users, 1,200) with
   "ssh" and "minhash" (#5) equal to the port's CPU run, QA1/QA2 against the
   centralized truth (ssh exactly 1.000).
18i. dedup — ``ssh_dedup`` over a 14,000-document corpus of 1,024 tokens
   with planted near-duplicates (granite-3-8b's vocabulary) on the card
   against the CPU (keep mask and stats equal; no kernel: the reference
   scores with the plain wavefront), the planted duplicates' recall, and
   ``TokenDataset`` batches on the card against the CPU's, two shards
   against one.
18j. examples — ``examples/torch_quickstart.py`` and
   ``examples/torch_find_another_me.py`` on the card, last lines checked.
19. lm kernels — flash attention (#6) and the SSD intra-chunk step (#7)
   against their plain versions at edge shapes (ragged lengths, head dims
   64/80/96/112/128/144/192/256, GQA 1 and 4, causal and not; float32 on
   the CUDA-core route, bfloat16 on the wgmma route and again on the
   CUDA-core route; SSD
   chunks 1/16/65/128, states and head dims 64 and 128, 9 heads, bfloat16
   on both of #7's routes, float32 on the CUDA-core route, ``bf16_intra``
   on the wgmma route) and the chunked SSD scan against its plain version
   on each route.
20. lm small — reduced granite-3-8b, mamba2-1.3b, zamba2-2.7b,
   deepseek-v2-236b (MoE + MLA), kimi-k2-1t-a32b (MoE) and minicpm3-4b (MLA)
   served on the card against the same run on the CPU (MoE dropped
   assignments logged), and the reduced hubert-xlarge (audio frames) and
   internvl2-76b (patches before the tokens) ``forward`` over
   ``launch/inputs.py::make_inputs``, card against CPU.
21. lm zamba2 / granite / deepseek-v2 / minicpm3 full — zamba2-2.7b,
   granite-3-8b, deepseek-v2-236b (cut from 60 layers to 4) and
   minicpm3-4b (cut from 62 layers to 31) at their full published widths (random
   bfloat16 weights from a seed) serve 4 prompts of 2,048 tokens and 32
   greedy tokens each: the prefill launches #6 9 (zamba2), 40 (granite),
   4 (deepseek-v2, MLA's head dim 192) and 31 (minicpm3) times, and #7 54
   times (zamba2), every one on its wgmma route; the first call's
   kernel operands are rerun through the plain versions; the prefill is
   held against ``forward(last_only)`` and (but for MoE) ``forward`` over
   the longer sequence, and two teacher-forced decode steps against a
   float32 ``forward`` (whose run takes the CUDA-core routes).  An MoE
   decode step runs at capacity ``int(B*K/E*1.25) + 1`` = 1 and drops
   colliding assignments, as the reference does, and a near-tied expert
   can fall either way between bfloat16 and float32: a request is held
   where, in every layer, it went to the float32 forward's experts and
   lost no assignment; the two steps run again at a capacity that drops
   nothing and are held the same way.  Every prefill and decode step's
   dropped count is logged.  Each also profiles one prefill and 8 decode
   steps (device busy and idle shares, device time by kernel kind).
22. lm timing — #6 at the models' operands (zamba2, granite, deepseek-v2,
   minicpm3), at kimi-k2's GQA head dim (112) and hubert-xlarge's
   non-causal heads (80) and at prefill_32k's length (also by the launch
   alone), beside its plain version and ``scaled_dot_product_attention``
   (and, at granite's and deepseek-v2's operands, the CUDA-core kernel, which
   at deepseek-v2's must take at least 10x the launch alone); #7 at zamba2's
   operands on both routes beside its plain version, with the tensor-core
   source's ptxas registers, spills and HGMMA count.

23. train kernels — each kernel's autograd op (the kernel forward; #6's
   hand-written bf16 backward, #7's torch-ops one) against autograd
   through its plain version in float32, on the card: #6 at [2, 4096, 32,
   80], granite's [2, 4096, 32/8, 128] and the zamba2-train-4k cell's
   [2, 4096, 32, 160] (bfloat16, causal; dq, dk, dv within 3e-2 relative
   L2), #7 at zamba2's [64, 128, 80, 64] on both routes (1e-4) and under
   ``bf16_intra`` (5e-2); the forward (with and without the logsumexp),
   #6's backward on both routes (the wgmma kernels and
   ``flash_attention_bwd``) beside its bound, and SDPA's forward +
   backward timed.
24. train small — reduced granite-3-8b, mamba2-1.3b, zamba2-2.7b and
   deepseek-v2-236b: the loss and every gradient leaf on the card against
   the CPU (5e-2; every leaf finite and nonzero; equal MoE drops), and a
   train step on the card.
25. train zamba2 full — published widths, all 54 layers, random bfloat16
   weights: every gradient leaf of a 2 x 4,096 microbatch finite and
   nonzero; 3 steps on one batch of 4 x 4,096 tokens (2 microbatches,
   float32 moments, lr 3e-4), the loss falling, #6 launched 36 and #7 216
   times a step (forward and recompute), each backward once a layer a
   microbatch; a profiled fourth step; a step with 8-bit moments and EF
   compression; the first group (6 mamba layers and the shared block) at
   published widths, its whole gradient within 5e-2 relative L2 of the
   plain versions' path.  Step seconds, tokens/s and peak memory logged.
26. train example — ``examples/torch_train_lm.py`` on the card (tiny-100m,
   SSH dedup, 16 steps): the loss falls; a resume from its checkpoint
   runs only the remaining 4 steps.

27. lm deepseek-v2 ep — deepseek-v2-236b at published widths, 2 of 60
   layers, on (1, 2) and (2, 2) meshes of the card (``devices=(card,) *
   n``): 4 prompts of 2,048 tokens (#6 on the wgmma route) and 8 decode
   steps; the (1, 2) run held
   to the one-device run (routing equal wherever a layer's input is, the
   logits of the requests routed alike within 5e-2), the (2, 2) run (each
   data shard at its own capacity) to the same mesh's plain-version path;
   drops counted; every dispatch reads the one stacked copy of the experts.
28. train zamba2 dp — zamba2-2.7b's first group at published widths, 2
   steps of 4 x 4,096 tokens data parallel on a (2, 1) mesh of the card
   against the one-device step: losses within 5e-2, parameters and first
   moments within 5e-2 relative L2.
29. dryrun — ``launch/dryrun.py``: every (arch x shape x mesh) cell
   derived on ``meta`` meshes of 256 and 512 ranks, and one cell a family
   measured on the card at one layer period (peak memory, device time by
   kernel kind).
30. perf variants — ``launch/perf.py``: every variant's derived terms; the
   zamba2 variants trained at one group on the card with each knob set,
   the kimi-k2 variants derived only (a layer's training state is past
   80 GB), the AnotherMe variants at N = 1,048,576, L = 16 on 4 shards.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each path is driven and read just after, and a path whose kernel was
never launched fails.  #6's and #7's entries also carry their training
launches (``launches_training``) and gradient figures (``training``), and
their launches on the mesh phases (``launches_mesh``).  The
second-to-last line is a JSON object with one entry per kernel; the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
# the data sheet's dense bf16 tensor-core rate and float32 rate outside the
# tensor cores (the bounds of the tensor-core kernels, and of the SSD
# kernel's CUDA-core route, whose products are float32)
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

MAIN_N = 1_000_000
KERNEL_N = 200_000
SMALL_N = 3_000
NUM_TYPES = 300
RHO = 2.0
# the subtrajectory path: fig13's forest, fig10-subtraj's window, rows of
# 10-20 places (13 windows of 8 a full row)
SUB_N = 100_000
SUB_KERNEL_N = 20_000
SUB_SMALL_N = 2_000
SUB_WINDOW = 8
SUB_ROWS = dict(min_len=10, max_len=20)
# the baselines: fig10's accuracy world at its GRID_FULL top point, fig7's
# UDF cap on fig7's world, and fig13's world cut to each join's size
FIG10_N = 2_000
FIG10_WORLD = dict(num_types=10, classes_per_type=5, num_places=500)
UDF_N = 1_500
BRP_N = 50_000
CENTRAL_N = 10_000
MINHASH_PERMS, MINHASH_BANDS = 16, 4
# int32 operations of one MinHash evaluation as the reference's formula
# counts them: 4 multiplies, 4 mods, 2 adds, 2 folds (compare + select),
# the mask select and the minimum
MINHASH_OPS_PER_HASH = 16
# LM serving: 4 requests of a 2,048-token prompt (a multiple of ssm_chunk
# = 128 and of chunked_attention's 1,024), 32 greedy tokens each; the
# decode-vs-forward check runs forward over 128 more tokens
LM_BATCH, LM_PROMPT, LM_GEN, LM_EXTRA = 4, 2048, 32, 128
LM_MAX_LEN = LM_PROMPT + LM_GEN
LM_LOGITS_ATOL = 5e-2
PREFILL_32K = 32_768
# streaming and serving (on the host join, then on the device join): fig13's
# world fed as 10 micro-batches with a window of 4 updates; a 20,000-row
# stream of the same shape for the two community paths and LCS kernels; a
# 3,000-row stream against the CPU; 1,000 queries of each kind, top 10
STREAM_N = 200_000
STREAM_BATCHES = 10
STREAM_WINDOW = 4
STREAM_KERNEL_N = 20_000
STREAM_SMALL_N = 3_000
SERVE_QUERIES = 1_000
SERVE_K = 10
# the sharded paths: shards on the one card; the prune's rho (rows hold at
# least 5 places, so the bound min(len) > 2 prunes nothing at RHO)
SHARDS = 4
PRUNE_RHO = 5.5
# tuning and autotune=True: the sweep's smoke grid plus a cell on the LCS
# kernel's shared route (L > 32); the GeoLife surrogate cut to 2,000
# trajectories for the tuned-against-untuned runs (4,000 took 10.8 s)
TUNE_SHARED_CELL = (4096, 3, 40)
AUTOTUNE_N = 2_000
# the GeoLife surrogate at the paper's full scale (fig11/12: 182 users,
# 17,621 trajectories, rho 3.0)
GEOLIFE_USERS, GEOLIFE_N, GEOLIFE_RHO = 182, 17_621, 3.0
# SSH corpus dedup: documents of 1,024 tokens over granite-3-8b's vocabulary
# (configs/granite_3_8b.py), cut from 100,000 to 14,000 documents to keep the
# script near its 600 s aim: the phase's comparison run on the CPU took 55 s
# at 20,000 documents (a pair buffer of 2^23 slots; 2^22 at 14,000), and
# unrelated documents share a 3-shingle of their 16 anchors with probability
# ~C(16,3)^2/300^3 = 1.2% (arithmetic), so the candidates grow with about the
# square of the corpus
DEDUP_N, DEDUP_SEQ, GRANITE_VOCAB = 14_000, 1_024, 49_155


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
            if line.startswith("nvcc ") or "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas[{name}]: {line.strip()}")
            elif "Performance" in line:  # e.g. wgmma serialized by ptxas
                log(f"ptxas[{name}]: {line.strip()[:200]}")
    log(f"build: {len(logs)} sources in {secs:.2f} s")
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    figures = {}
    for name in ("flash_attention_sm90", "flash_attention_bwd_sm90", "ssd_intra_sm90"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        hgmma = [line.split(";")[0].split("*/")[-1].strip() for line in sass.splitlines() if "HGMMA" in line]
        check(hgmma, f"{name}: no HGMMA instruction in its SASS")
        log(f"{name} SASS: {len(hgmma)} HGMMA instructions "
            f"({', '.join(sorted(set(h.split()[0] for h in hgmma)))})")
        text = logs.get(name, "")
        figures[name] = dict(
            hgmma=len(hgmma), kernels=_ptxas_by_kernel(text),
            build_s=float(m.group(1)) if (m := re.search(r"^nvcc \S+: ([\d.]+) s", text)) else None)
    # flash attention past head dim 128 (KS = D / 16 > 8: 3 or 4 chunks of 64
    # columns, narrower key tiles): no spill, and ptxas kept the wgmmas async
    flash = figures["flash_attention_sm90"]["kernels"]
    if "flash_attention_sm90" not in logs:  # built before this run: no ptxas report to read
        log("flash_attention_sm90: built before this run; its ptxas report is not checked")
    else:
        check("?" not in flash, f"flash_attention_sm90: a serialized wgmma outside an instantiation {flash}")
        ks = {k: _template_args(k)[0] for k in flash}
        wide = {k: v for k, v in flash.items() if ks[k] > 8}
        # eight head dims, each with and without the logsumexp (kLse)
        check(len(wide) == 16, f"flash_attention_sm90: instantiations past D = 128 {sorted(wide)}")
        for key, v in wide.items():
            check(v.get("spill_store_bytes") == 0, f"flash_attention_sm90 <{key}>: spills {v}")
            check(not v.get("serialized"), f"flash_attention_sm90 <{key}>: {v.get('serialized')}")
        log("flash_attention_sm90 ptxas (<KS, NS, kLse, NC>: registers, spill-store bytes): "
            + ", ".join(f"{k} {flash[k].get('registers')} {flash[k].get('spill_store_bytes')}"
                        for k in sorted(flash, key=ks.get))
            + "; no spill and no serialized wgmma past D = 128; built in "
            + f"{figures['flash_attention_sm90']['build_s']} s")
    # #6's backward: every kernel of every chunk count without spills or a
    # serialized wgmma
    bwd = figures["flash_attention_bwd_sm90"]["kernels"]
    if "flash_attention_bwd_sm90" not in logs:
        log("flash_attention_bwd_sm90: built before this run; its ptxas report is not checked")
    else:
        # dK/dV and dQ at each of the 16 head dims
        check(len([k for k in bwd if "_sm90_kernel<" in k]) == 32,
              f"flash_attention_bwd_sm90: instantiations {sorted(bwd)}")
        for key, v in bwd.items():
            check(v.get("spill_store_bytes") == 0, f"flash_attention_bwd_sm90 {key}: spills {v}")
            check(not v.get("serialized"), f"flash_attention_bwd_sm90 {key}: {v.get('serialized')}")
        log("flash_attention_bwd_sm90 ptxas (registers, spill-store bytes): "
            + ", ".join(f"{k} {v.get('registers')} {v.get('spill_store_bytes')}" for k, v in sorted(bwd.items()))
            + f"; no spill and no serialized wgmma; built in {figures['flash_attention_bwd_sm90']['build_s']} s")
    for name, width in (("fused_score", 10), ("fused_windowed_score", SUB_WINDOW)):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        figures[name] = _register_kernel_figures(name, sass, logs.get(name, ""), width)
    # the batched LCS kernel stages its tiles through shared memory: only
    # local memory (spills) is refused there
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target("lcs"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    figures["lcs"] = {f"W{width}": _register_kernel_figures("lcs", sass, logs.get("lcs", ""), width,
                                                             refused=("LDL", "STL"))
                      for width in (10, SUB_WINDOW)}
    # the shingle kernel at the timed order (k = 3, shuffle route): no spills
    shingle = _ptxas_by_kernel(logs.get("shingle", ""))
    path = shingle.get("shingle_rows<3,0,0>", {})
    check(path.get("spill_store_bytes", 0) == 0, f"shingle k=3: spills {path}")
    log(f"shingle ptxas at k=3, L <= 32: {path}")
    figures["shingle"] = dict(ptxas_path=path, ptxas_registers_spills={
        key: (v.get("registers"), v.get("spill_store_bytes")) for key, v in shingle.items()})
    return figures


# the register kernels' template flag of the DP (csrc/pair_dp.cuh kDp)
DP_FLAG = 4


def _sass_by_kernel(sass):
    """SASS opcodes of each register-route instantiation, keyed "W,F"."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"regsILi(\d+)ELi(\d+)E", part.split("\n", 1)[0])
        if m:
            out[f"{m.group(1)},{m.group(2)}"] = re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)
    return out


def _register_kernel_figures(name, sass, build_log, width, refused=("LDS", "STS", "LDL", "STL")):
    """ptxas's registers and spills of every register-route instantiation;
    at the path's width, the DP's SASS instructions a cell (the engine
    kernel's count less the loads-only variant's, over W * W cells: the
    row-exit branches and the sentinel test included) and a check that no
    ``refused`` memory instruction (by default shared or local) is left."""
    ops = _sass_by_kernel(sass)
    # the engine's flags are the ones instantiated at every width 1..32
    flags = {k.split(",")[1] for k in ops}
    engine_flags = [f for f in flags if all(f"{w},{f}" in ops for w in range(1, 33))]
    check(len(engine_flags) == 1, f"{name}: engine instantiations {engine_flags}")
    engine_flags = int(engine_flags[0])
    engine = ops[f"{width},{engine_flags}"]
    loads = ops[f"{width},{engine_flags & ~DP_FLAG}"]
    memory = sorted({op for op in engine if op.split(".")[0] in refused})
    check(not memory, f"{name} W={width}: {'/'.join(refused)} in the register kernel: {memory}")
    def by_opcode(listing):
        return collections.Counter(op.split(".")[0] for op in listing)

    diff = by_opcode(engine)
    diff.subtract(by_opcode(loads))
    per_cell = (len(engine) - len(loads)) / width ** 2
    ptxas = _ptxas_by_kernel(build_log)
    # the register kernel (``*_regs``, as ``_sass_by_kernel`` reads it)
    path = next((v for k, v in ptxas.items() if k.split("<")[0].endswith("_regs")
                 and _template_args(k) == [width, engine_flags]), {})
    log(f"{name} SASS at W={width}: {len(engine)} instructions ({len(loads)} loads-only), "
        f"{per_cell:.2f} a DP cell; the difference by opcode "
        f"{dict(+diff)}; no {'/'.join(refused)}; ptxas {path}")
    regs = {k: (v.get("registers"), v.get("spill_store_bytes")) for k, v in ptxas.items()}
    return dict(width=width, sass_instructions=len(engine), loads_only_instructions=len(loads),
                sass_per_cell=per_cell, sass_dp_by_opcode=dict(+diff),
                ptxas_path=path, ptxas_registers_spills=regs)


def _kernel_key(mangled):
    """A kernel's name and template arguments from its mangled name
    ("flash_bwd_dq_sm90_kernel<3,1>", namespaces left out); the mangled
    name itself where it names no function."""
    name, i = None, 3 if mangled.startswith("_ZN") else 2
    while mangled.startswith("_Z") and (m := re.compile(r"\d+").match(mangled, i)):
        name, i = mangled[m.end():m.end() + int(m.group())], m.end() + int(m.group())
    if not name:
        return mangled
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', mangled))}>"


def _template_args(key):
    """The template arguments of a ``_kernel_key``, as integers."""
    return [int(a) for a in key.partition("<")[2].rstrip(">").split(",") if a]


def _ptxas_by_kernel(text):
    """ptxas's registers, spill-store bytes and wgmma serialization warnings
    (``serialized``) for each instantiation in a build log, keyed by
    ``_kernel_key`` ("shingle_rows<3,0,0>")."""
    out, cur = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = _kernel_key(m.group(1))
            out.setdefault(cur, {})
        elif cur and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[cur]["spill_store_bytes"] = int(m.group(1))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur]["registers"] = int(m.group(1))
        if "wgmma" in line and "serialized" in line:  # the warning names its function
            m = re.search(r"function '(\S+?)'", line)
            out.setdefault(_kernel_key(m.group(1)) if m else (cur or "?"), {}).setdefault(
                "serialized", []).append(line.strip()[:200])
    return out


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
    unaligned = rows(100_004, 10)
    cases = {
        "odd_batch_B12345_L10": rows(12_345, 10),
        "L1": rows(5_001, 1),
        "L10": rows(100_003, 10),
        "L126": rows(20_011, 126, alphabet=3),
        "identical": (same, same),
        f"random_B{big_b}_L10": rows(big_b, 10),
        # either side of the routes, ragged tiles of the register route
        **{f"L{L}_B{B}": rows(B, L) for L in (1, 8, 32, 33) for B in (1, 127, 129)},
        # the widths of the GeoLife world (16) and of the tune phase's
        # shared-route cell (40)
        "L16": rows(30_011, 16),
        "L40": rows(30_011, 40),
        # rows at a 40-byte offset: the register route's scalar staging
        "unaligned_L10": (unaligned[0][1:], unaligned[1][1:]),
        # valid codes -2 in a and -1 in b, equal to the other side's pads
        "cross_sentinels_L10": tuple(torch.where(x == 0, code, x)
                                     for x, code in zip(rows(10_007, 10), (-2, -1))),
    }
    for name, (a, b) in cases.items():
        before = dict(kernel.lcs_kernel.launches_by_route)
        got = ops.lcs(a, b, mode="pallas")
        want = kernel.lcs_plain(a, b)
        check(torch.equal(got, want), f"lcs kernel != plain on {name}")
        path = kernel.route(a.shape[1])
        check(kernel.lcs_kernel.launches_by_route[path] == before[path] + 1,
              f"lcs {name}: not launched on route {path}")
        # lcs_ref never matches a negative code, as the encoder never emits one
        if a.shape[0] * a.shape[1] ** 2 <= 2_000_000 and not name.startswith("cross"):
            check(torch.equal(got, lcs_ref(a, b)), f"lcs kernel != lcs_ref on {name}")
        log(f"lcs {name}: bit-equal to plain ({a.shape[0]} rows, route {path})")
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
    _fused_edge_cases(torch, dev, rng, codes, lengths, betas)


def _hold_fused(torch, what, args, route, window=None):
    """The scorer (#1, or #3 with ``window``) against its plain version,
    bit-equal, launched once on ``route``; returns its level_lcs."""
    from repro_torch.kernels.lcs import fused

    wrapper = fused.fused_gather_score if window is None else fused.fused_windowed_gather_score
    plain = fused.fused_gather_score_plain if window is None else fused.fused_windowed_gather_score_plain
    kw = {} if window is None else {"window": window}
    before = wrapper.launches_by_route[route]
    lvl, mss = wrapper(*args, **kw)
    check(wrapper.launches_by_route[route] == before + 1, f"{what}: not launched on the {route} route")
    want_lvl, want_mss = plain(*args, **kw)
    check(torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss), f"{what}: kernel != plain")
    return lvl


def _table40(torch, dev, rng, H, n=20_000):
    """A code table of rows of 40 positions (the shared route's widths)."""
    import numpy as np

    lengths = torch.as_tensor(rng.integers(0, 41, size=n).astype(np.int32), device=dev)
    codes = torch.as_tensor(rng.integers(0, 30, size=(n, H, 40)).astype(np.int32), device=dev)
    return torch.where(torch.arange(40, device=dev) < lengths[:, None, None], codes, -1), lengths


def _fused_edge_cases(torch, dev, rng, codes, lengths, betas, P=1_000_003):
    """#1's identity pairs (with and without codes equal to the side
    sentinels), a buffer whose tail past a ragged count is clamped to the
    pair (0, 0), two distinct tables with iota indices, and both routes."""
    import numpy as np

    N, H, L = codes.shape
    idx = torch.as_tensor(rng.integers(0, N, size=P).astype(np.int32), device=dev)
    pos = torch.arange(L, device=dev)
    valid = pos < lengths[:, None, None]
    sentinels = torch.where(valid & (torch.rand(codes.shape, device=dev) < 0.25),
                            -1 - (torch.rand(codes.shape, device=dev) < 0.5).int(), codes)
    wl = lengths[idx].clamp(0, L)[:, None].expand(P, H)
    for name, table in (("identity", codes), ("identity, sentinel-valued codes", sentinels)):
        lvl = _hold_fused(torch, f"fused {name}", (table, lengths, table, lengths, idx, idx, betas),
                          "registers")
        check(torch.equal(lvl, wl), f"fused {name}: LCS != min(len, L)")
    count = P - P // 3 - 17
    left, right = (torch.as_tensor(rng.integers(0, N, size=P).astype(np.int32), device=dev) for _ in "ab")
    left[count:] = 0
    right[count:] = 0
    for name, table in (("PAD tail", codes), ("PAD tail, sentinel-valued codes", sentinels)):
        _hold_fused(torch, f"fused {name}", (table, lengths, table, lengths, left, right, betas),
                    "registers")
    iota = torch.arange(N, dtype=torch.int32, device=dev)[:P]
    other = codes.roll(1, dims=0)
    _hold_fused(torch, "fused two tables, iota", (codes, lengths, other, lengths.roll(1), iota, iota, betas),
                "registers")
    # the shared route: rows of 40 positions
    c40, len40 = _table40(torch, dev, rng, H)
    l40, r40 = (torch.as_tensor(rng.integers(0, c40.shape[0], size=100_003).astype(np.int32),
                                device=dev) for _ in "ab")
    l40[:1000] = r40[:1000]
    l40[-5000:] = r40[-5000:] = 0
    _hold_fused(torch, "fused L=40 (shared route)", (c40, len40, c40, len40, l40, r40, betas), "shared")
    log(f"fused edge cases: identity pairs ({P}; LCS = min(len, L)), with codes equal to the side "
        f"sentinels, a PAD tail from count {count} of {P}, two tables with iota indices, "
        "and L = 40 on the shared route: bit-equal to the plain version")


def phase_windowed_kernel(torch, dev, table_shape=(SUB_N, 3, 20), pairs=4_000_037):
    """The windowed fused kernel against its plain version, bit-equal, on
    window coordinates as the engine decodes them: clamped PAD_ID slots
    (trajectory 0, offset 0) and the last offset of a row among them."""
    import numpy as np

    from repro_torch.core.subtraj import num_windows
    from repro_torch.kernels.lcs import fused

    rng = np.random.default_rng(1)
    N, H, L = table_shape
    W = SUB_WINDOW
    nw = num_windows(L, W)
    lengths = torch.as_tensor(rng.integers(10, L + 1, size=N).astype(np.int32), device=dev)
    codes = torch.as_tensor(rng.integers(0, 30, size=table_shape).astype(np.int32), device=dev)
    codes = torch.where(torch.arange(L, device=dev) < lengths[:, None, None], codes, -1)
    betas = torch.full((H,), 1.0 / H, dtype=torch.float32, device=dev)
    for P in (1, 4097, pairs):
        w = rng.integers(0, N * nw, size=(2, P)).astype(np.int64)
        w[:, : P // 100] = 0                  # clamped PAD_ID slots
        w[0, P // 100: P // 50] = nw - 1      # the last offset of row 0
        w = torch.as_tensor(w, device=dev)
        ta, tb = (w[0] // nw).int(), (w[1] // nw).int()
        oa, ob = (w[0] % nw).int(), (w[1] % nw).int()
        args = (codes, lengths, codes, lengths, ta, tb, oa, ob, betas)
        lvl, mss = fused.fused_windowed_gather_score(*args, window=W)
        want_lvl, want_mss = fused.fused_windowed_gather_score_plain(*args, window=W)
        check(torch.equal(lvl, want_lvl), f"windowed level_lcs != plain at P={P}")
        check(torch.equal(mss, want_mss), f"windowed kernel mss epilogue != mss_scores at P={P}")
        if P <= 4097:
            ref_lvl, ref_mss = fused.fused_windowed_score_ref(*args, window=W)
            check(torch.equal(lvl, ref_lvl) and torch.equal(mss, ref_mss),
                  f"windowed kernel != gather-windows reference at P={P}")
        log(f"fused_windowed P={P} table={tuple(codes.shape)} W={W}: level_lcs and the "
            "kernel's mss epilogue bit-equal to the plain version")
    _windowed_edge_cases(torch, dev, rng, codes, lengths, betas)


def _windowed_edge_cases(torch, dev, rng, codes, lengths, betas, P=1_000_003):
    """#3's identical windows (with and without codes equal to the side
    sentinels: with them the kernel scores the W-wide slices, as the
    gather-windows reference does, and the plain version's whole masked
    rows differ), a PAD tail, two tables with iota indices, and the shared
    route."""
    import numpy as np

    from repro_torch.kernels.lcs import fused

    N, H, L = codes.shape
    W = SUB_WINDOW
    coord = lambda hi: torch.as_tensor(rng.integers(0, hi, size=P).astype(np.int32), device=dev)  # noqa: E731
    t, off = coord(N), coord(L)
    off[:1000] = L - 1
    wl = (lengths[t].clamp(max=L) - off).clamp(0, W)[:, None].expand(P, H)
    lvl = _hold_fused(torch, "fused_windowed identity", (codes, lengths, codes, lengths, t, t, off, off, betas),
                      "registers", window=W)
    check(torch.equal(lvl, wl), "fused_windowed identity: LCS != window length")
    valid = torch.arange(L, device=dev) < lengths[:, None, None]
    sentinels = torch.where(valid & (torch.rand(codes.shape, device=dev) < 0.25),
                            -1 - (torch.rand(codes.shape, device=dev) < 0.5).int(), codes)
    ta, tb, oa, ob = coord(N), coord(N), coord(L), coord(L)
    ta[:P // 10], oa[:P // 10] = tb[:P // 10], ob[:P // 10]
    args = (sentinels, lengths, sentinels, lengths, ta, tb, oa, ob, betas)
    got = fused.fused_windowed_gather_score(*args, window=W)
    want = fused.fused_windowed_score_ref(*args, window=W)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "fused_windowed with sentinel-valued codes != the gather-windows reference")
    same = slice(0, P // 10)
    wl_same = (lengths[tb[same]].clamp(max=L) - ob[same]).clamp(0, W)[:, None].expand(-1, H)
    check(torch.equal(got[0][same], wl_same),
          "fused_windowed identity with sentinel-valued codes: LCS != window length")
    count = P - P // 3 - 17
    for x in (ta, tb, oa, ob):
        x[count:] = 0
    _hold_fused(torch, "fused_windowed PAD tail", (codes, lengths, codes, lengths, ta, tb, oa, ob, betas),
                "registers", window=W)
    iota = torch.arange(N, dtype=torch.int32, device=dev)
    o = torch.full_like(iota, 3)
    _hold_fused(torch, "fused_windowed two tables, iota",
                (codes, lengths, codes.roll(1, dims=0), lengths.roll(1), iota, iota, o, o, betas),
                "registers", window=W)
    c40, len40 = _table40(torch, dev, rng, H)
    t40 = [torch.as_tensor(rng.integers(0, hi, size=100_003).astype(np.int32), device=dev)
           for hi in (c40.shape[0], c40.shape[0], 40, 40)]
    t40[0][:1000], t40[2][:1000] = t40[1][:1000], t40[3][:1000]
    _hold_fused(torch, "fused_windowed L=40 W=33 (shared route)", (c40, len40, c40, len40, *t40, betas),
                "shared", window=33)
    log(f"fused_windowed edge cases: identical windows ({P}; LCS = window length), codes equal to the "
        f"side sentinels (== the gather-windows reference), a PAD tail from count {count} of {P}, two "
        "tables with iota indices, and W = 33 on the shared route: bit-equal")


def _engine(dev, forest, impl, backend="ssh", **cfg):
    from repro_torch.api import AnotherMeEngine, EngineConfig

    return AnotherMeEngine(forest, EngineConfig(backend=backend, lcs_impl=impl, **cfg), device=dev)


def _wrappers():
    from repro_torch.kernels.lcs import fused, kernel
    from repro_torch.kernels.minhash import kernel as minhash
    from repro_torch.kernels.shingle import kernel as shingle
    from repro_torch.kernels.attention import kernel as attention
    from repro_torch.kernels.ssd import kernel as ssd

    return {"lcs_kernel": kernel.lcs_kernel,
            "fused_gather_score": fused.fused_gather_score,
            "fused_windowed_gather_score": fused.fused_windowed_gather_score,
            "shingle_kernel": shingle.shingle_kernel,
            "minhash_kernel": minhash.minhash_kernel,
            "flash_attention_kernel": attention.flash_attention_kernel,
            "ssd_intra": ssd.ssd_intra}


def _counted(fn):
    """Call ``fn`` with every launch count set to 0 just before it; returns
    (its result, the launch counts of this call).  #6's backward routes
    (``flash_attention_backward.launches_by_route``) are reset too, for the
    caller to read after."""
    from repro_torch.kernels.attention import kernel as attention

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    flash = wrappers["flash_attention_kernel"]
    flash.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
    flash.copies = 0
    attention.flash_attention_backward.launches_by_route = {"wgmma": 0, "torch_ops": 0}
    attention.flash_attention_backward.copies = 0
    wrappers["ssd_intra"].launches_by_route = {"wgmma": 0, "cuda_cores": 0}
    for name in ("lcs_kernel", "fused_gather_score", "fused_windowed_gather_score"):
        wrappers[name].launches_by_route = {"registers": 0, "shared": 0}
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def _run_counted(engine, batch):
    """Run the engine with every launch count set to 0 just before it;
    returns (result, launch counts of this run)."""
    return _counted(lambda: engine.run(batch))


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
    routes = dict(fused.fused_gather_score.launches_by_route)
    check(routes == {"registers": 1, "shared": 0}, f"main: #1 launched on routes {routes}")
    _stats_line(f"main N={n}", res, counts)
    log(f"main: fused_gather_score launches_by_route {routes}")
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
    # a slice across the count, into the PAD tail clamped to the pair (0, 0)
    count = int(sc.count)
    t = slice(max(0, count - slice_pairs // 2), min(P, count + slice_pairs // 2))
    want_lvl, want_mss = fused.fused_gather_score_plain(
        enc.codes, enc.lengths, enc.codes, enc.lengths, li[t], ri[t], engine.betas
    )
    check(torch.equal(sc.level_lcs[t], want_lvl) and torch.equal(sc.mss[t], want_mss),
          "main: slice across the count != plain")
    log(f"main: slices [0, {s.stop}) and [{t.start}, {t.stop}) (across the count {count}, into the "
        "PAD tail) of the scored buffer bit-equal to the plain version")
    split = _score_split(torch, sc, enc, engine.betas)
    main_inputs = (enc.codes, enc.lengths, li, ri, engine.betas)
    return res, counts, main_inputs, dict(launches_by_route=routes, score_stage_ms=split)


def _score_split(torch, sc, enc, betas):
    """The main path's score stage on the engine's own buffer, part by part:
    the PAD clamp, the kernel's wrapper (checks and launch), the
    ``exact_mss`` recompute (CUDA events, median of 3), and the host's
    ``mss > rho`` mask and similar-pair set, which follow the timed phase
    (host clock, copies from the card included)."""
    import numpy as np

    from repro_torch.core.similarity import mss_scores
    from repro_torch.core.types import PAD_ID
    from repro_torch.kernels.lcs import fused

    state = {}

    def clamp():
        state["li"] = torch.where(sc.left == PAD_ID, 0, sc.left)
        state["ri"] = torch.where(sc.right == PAD_ID, 0, sc.right)

    def kernel():
        state["lvl"], _ = fused.fused_gather_score(enc.codes, enc.lengths, enc.codes, enc.lengths,
                                                   state["li"], state["ri"], betas)

    def exact():
        state["mss"] = mss_scores(state["lvl"], betas)

    split = {name: _time_ms(torch, fn, reps=3) for name, fn in
             (("clamp", clamp), ("kernel_wrapper", kernel), ("exact_mss", exact))}
    check(torch.equal(state["mss"], sc.mss), "score split: recomputed mss != the engine's")
    t0 = time.perf_counter()
    left_np, right_np = sc.left.cpu().numpy(), sc.right.cpu().numpy()
    mask = (left_np != PAD_ID) & (sc.mss.cpu().numpy() > np.float32(RHO))
    pairs = {(int(a), int(b)) for a, b in zip(left_np[mask].tolist(), right_np[mask].tolist())}
    split["mask_and_pair_set_host"] = (time.perf_counter() - t0) * 1e3
    log("main score stage on the engine's buffer (ms): " +
        ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" ({len(pairs)} similar pairs)")
    return split


def phase_kernel_path(torch, dev, n=KERNEL_N):
    from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B, encode_batch, forest_tables
    from repro_torch.core.similarity import repad
    from repro_torch.core.types import PAD_ID
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    kres, kcounts = _run_counted(_engine(dev, forest, "kernel", rho=RHO), batch)
    expect_launched(kcounts, ["lcs_kernel"])
    routes = _lcs_routes(f"kernel-path N={n}")
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
    return kcounts, routes, (a, b)


def _lcs_routes(tag):
    """The LCS kernel's launches by route since the counts were set to 0;
    every one must be on the register route."""
    from repro_torch.kernels.lcs import kernel

    routes = dict(kernel.lcs_kernel.launches_by_route)
    check(routes["registers"] > 0 and routes["shared"] == 0,
          f"{tag}: the LCS kernel launched on routes {routes}")
    log(f"{tag}: lcs_kernel launches_by_route {routes}")
    return routes


def _sub_engine(dev, forest, impl, window=SUB_WINDOW, **cfg):
    return _engine(dev, forest, impl, rho=RHO, subtraj_window=window, **cfg)


def phase_subtraj_small(torch, dev, n=SUB_SMALL_N):
    """Windowed kernel impls against the plain engine, both on the card."""
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev, **SUB_ROWS)
    for window in (SUB_WINDOW, 64):  # W < L, and W >= L (whole trajectories)
        want = _sub_engine(dev, forest, "wavefront", window).run(batch)
        check(len(want.similar_pairs) > 0, f"subtraj small W={window}: no similar pairs")
        for impl, kern in (("fused", "fused_windowed_gather_score"), ("kernel", "lcs_kernel")):
            res, counts = _run_counted(_sub_engine(dev, forest, impl, window), batch)
            expect_launched(counts, [kern])
            _same_result(res, want, f"subtraj small W={window} {impl}")
        log(f"subtraj small: N={n} W={window}: fused and kernel == plain engine "
            f"({want.stats['num_window_pairs']} window pairs, "
            f"{want.stats['num_traj_pairs']} trajectory pairs, {len(want.similar_pairs)} similar)")


def _sub_stats_line(tag, res, counts):
    s = res.stats
    keys = ("t_encode", "t_keys", "t_join", "t_score", "t_aggregate", "t_communities",
            "t_total")
    log(f"{tag}: " + " ".join(f"{k}={s[k]:.3f}s" for k in keys))
    log(f"{tag}: num_window_pairs={s['num_window_pairs']} num_traj_pairs={s['num_traj_pairs']} "
        f"pair_capacity={s['pair_capacity']} join_overflow={s['join_overflow']} "
        f"subtraj_windows={s['subtraj_windows']} num_similar={s['num_similar']} "
        f"num_communities={s['num_communities']} launches={counts}")


def _pairs_slice(coords, s):
    """The windowed scorer's operands with the four [P] coordinate vectors
    (positions 4-7) cut to the slice ``s``."""
    return [x[s] if 4 <= i < 8 else x for i, x in enumerate(coords)]


def phase_subtraj(torch, dev, n=SUB_N, slice_pairs=1 << 20):
    """The subtrajectory engine at full size with ``lcs_impl="fused"``."""
    import numpy as np

    from repro_torch.core.encoding import encode_batch
    from repro_torch.core.similarity import mss_scores
    from repro_torch.core.ssh import ssh_candidates
    from repro_torch.core.subtraj import aggregate_window_pairs, num_windows, window_coords
    from repro_torch.core.types import PAD_ID
    from repro_torch.data import synthetic_setup
    from repro_torch.kernels.lcs import fused

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev, **SUB_ROWS)
    engine = _sub_engine(dev, forest, "fused", community_mode="components")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, counts = _run_counted(engine, batch)
    wall = time.perf_counter() - t0
    expect_launched(counts, ["fused_windowed_gather_score"])
    routes = dict(fused.fused_windowed_gather_score.launches_by_route)
    check(routes == {"registers": 1, "shared": 0}, f"subtraj: #3 launched on routes {routes}")
    _sub_stats_line(f"subtraj N={n} W={SUB_WINDOW}", res, counts)
    log(f"subtraj: fused_windowed_gather_score launches_by_route {routes}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    log(f"subtraj: run wall {wall:.3f}s, peak device memory {peak:.2f} GiB")

    sc, st = res.scored, res.stats
    T = st["num_traj_pairs"]
    check(sc.left.shape == (T,) and sc.level_lcs.shape == (T, 3) and sc.mss.shape == (T,),
          "subtraj: scored buffer shape")
    check(int(sc.count) == T > 0 and int(sc.overflow) == 0, "subtraj: pair count or overflow")
    check(bool((sc.left < sc.right).all()), "subtraj: trajectory pairs not canonical")
    check(bool(torch.isfinite(sc.mss).all()), "subtraj: non-finite mss")
    check(int(sc.level_lcs.min()) >= 0 and int(sc.level_lcs.max()) <= SUB_WINDOW,
          "subtraj: window LCS out of range")
    check(int((sc.mss > RHO).sum()) == len(res.similar_pairs) > 0,
          "subtraj: similar set disagrees with mss > rho")

    # the window buffer the engine scored (the join is deterministic): a
    # slice re-scored by the kernel and by the plain version, bit-equal; the
    # plain scores folded by max-over-windows equal the engine's row for
    # every trajectory pair whose window pairs all lie in the slice, and
    # every other window pair of the slice is under its pair's maximum
    enc = encode_batch(batch, engine.tables)
    keys = engine.backend.join_keys(enc, batch, engine.backend_ctx)
    cand = ssh_candidates(keys, pair_capacity=st["pair_capacity"])
    del keys
    check(int(cand.count) == st["num_window_pairs"], "subtraj: window buffer differs")
    nw = num_windows(enc.codes.shape[2], SUB_WINDOW)
    check(nw == st["subtraj_windows"], "subtraj: window count")
    ta, oa = window_coords(cand.left, nw=nw)
    tb, ob = window_coords(cand.right, nw=nw)
    coords = (enc.codes, enc.lengths, enc.codes, enc.lengths, ta, tb, oa, ob, engine.betas)
    s = slice(0, min(slice_pairs, ta.shape[0]))
    part = _pairs_slice(coords, s)
    lvl, mss = fused.fused_windowed_gather_score(*part, window=SUB_WINDOW)
    want_lvl, want_mss = fused.fused_windowed_gather_score_plain(*part, window=SUB_WINDOW)
    check(torch.equal(lvl, want_lvl) and torch.equal(mss, want_mss),
          "subtraj: window slice kernel != plain")
    # a slice across the count, into the PAD tail (window 0 of row 0 on both sides)
    count = int(cand.count)
    t = slice(max(0, count - slice_pairs // 2), min(ta.shape[0], count + slice_pairs // 2))
    tail = _pairs_slice(coords, t)
    got = fused.fused_windowed_gather_score(*tail, window=SUB_WINDOW)
    want = fused.fused_windowed_gather_score_plain(*tail, window=SUB_WINDOW)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "subtraj: window slice across the count kernel != plain")
    log(f"subtraj: window slice [{t.start}, {t.stop}) across the count {count}, into the PAD "
        "tail, bit-equal to the plain version")
    del got, want, tail

    def pair_keys(wl, wr):  # (traj_lo * n + traj_hi) of cross-trajectory window pairs
        valid = wl != PAD_ID
        a, b = wl[valid].long() // nw, wr[valid].long() // nw
        cross = a != b
        return torch.minimum(a, b)[cross] * n + torch.maximum(a, b)[cross]

    all_keys = pair_keys(cand.left, cand.right).sort().values
    part_keys, part_counts = pair_keys(cand.left[s], cand.right[s]).unique(return_counts=True)
    in_buffer = (torch.searchsorted(all_keys, part_keys, right=True)
                 - torch.searchsorted(all_keys, part_keys))
    whole = part_keys[in_buffer == part_counts].cpu().numpy()
    del all_keys
    fl, fr, flvl, fmss = aggregate_window_pairs(
        cand.left[s].cpu().numpy(), cand.right[s].cpu().numpy(),
        want_lvl.cpu().numpy(), mss_scores(want_lvl, engine.betas).cpu().numpy(), nw=nw)
    del cand
    fkey = fl.astype(np.int64) * n + fr
    pick = np.isin(fkey, whole)
    agg = sc.left.cpu().numpy().astype(np.int64) * n + sc.right.cpu().numpy()
    at = np.searchsorted(agg, fkey)
    check(bool((agg[np.minimum(at, T - 1)] == fkey).all()),
          "subtraj: a scored window pair has no trajectory pair")
    check(pick.sum() == whole.size > 0, "subtraj: no whole trajectory pair in the slice")
    check(np.array_equal(sc.level_lcs.cpu().numpy()[at[pick]], flvl[pick])
          and np.array_equal(sc.mss.cpu().numpy()[at[pick]], fmss[pick]),
          "subtraj: engine's fold != plain fold on the slice's whole pairs")
    check(bool((sc.mss.cpu().numpy()[at] >= fmss).all()),
          "subtraj: a window pair beats its trajectory pair's maximum")
    log(f"subtraj: slice of {s.stop} window pairs bit-equal to the plain version; "
        f"its fold equals the engine's row for {whole.size} of {fkey.size} trajectory "
        f"pairs (all their window pairs in the slice), the rest under the engine's max")
    sub_types = (enc.codes[:, 0, :], enc.lengths)
    return counts, coords, sub_types, routes, res


def phase_subtraj_kernel_path(torch, dev, n=SUB_KERNEL_N):
    from repro_torch.data import synthetic_setup

    from repro_torch.kernels.lcs import ops

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev, **SUB_ROWS)
    with _Capture(ops, "lcs_kernel") as first:  # the operands of its first launch, for timing
        kres, kcounts = _run_counted(_sub_engine(dev, forest, "kernel"), batch)
    expect_launched(kcounts, ["lcs_kernel"])
    routes = _lcs_routes(f"subtraj kernel-path N={n}")
    _sub_stats_line(f"subtraj kernel-path N={n} lcs_impl=kernel", kres, kcounts)
    fres, fcounts = _run_counted(_sub_engine(dev, forest, "fused"), batch)
    expect_launched(fcounts, ["fused_windowed_gather_score"])
    _sub_stats_line(f"subtraj kernel-path N={n} lcs_impl=fused", fres, fcounts)
    _same_result(kres, fres, f"subtraj N={n} kernel vs fused")
    log(f"subtraj kernel-path: lcs_impl=kernel == lcs_impl=fused at N={n}")
    a, b = first.args
    check(a.shape[1] == SUB_WINDOW, f"subtraj kernel-path: LCS rows of width {a.shape[1]}")
    return kcounts, routes, (a.contiguous(), b.contiguous())


def phase_shingle(torch, dev, main_types, sub_types, k=3):
    """The public shingle op, counted, on the main world's type codes; the
    kernel against its plain version there and on the window view."""
    from repro_torch.core.shingling import num_shingles, shingles_from_types, windowed_types
    from repro_torch.core.types import PAD_KEY
    from repro_torch.kernels.shingle import kernel, ops

    types, lengths = main_types
    keys, counts = _counted(lambda: ops.shingle_keys(types, lengths, k=k, num_types=NUM_TYPES))
    expect_launched(counts, ["shingle_kernel"])
    windows = windowed_types(*sub_types, window=SUB_WINDOW)
    for name, (t, ln) in (("main world", (types, lengths)), ("window view", windows)):
        S = num_shingles(t.shape[1], k)
        s_pad = -(-S // 128) * 128
        raw = kernel.shingle_kernel(t, ln, k=k, num_types=NUM_TYPES, s_pad=s_pad)
        check(torch.equal(raw, kernel.shingle_plain(t, ln, k=k, num_types=NUM_TYPES, s_pad=s_pad)),
              f"shingle kernel != plain on the {name}")
        got = keys if name == "main world" else ops.shingle_keys(t, ln, k=k, num_types=NUM_TYPES)
        check(torch.equal(got[:, :S], shingles_from_types(t, ln, k=k, num_types=NUM_TYPES)),
              f"shingle_keys != shingles_from_types on the {name}")
        check(bool((got[:, S:] == PAD_KEY).all()), f"shingle_keys padding on the {name}")
        log(f"shingle {name} {list(t.shape)} k={k}: kernel bit-equal to plain, "
            f"keys equal shingles_from_types on the first {S} of {s_pad} columns")
    _shingle_edge_cases(torch, dev)
    return counts


def _shingle_edge_cases(torch, dev):
    """The shingle kernel against its plain version, bit-equal, at edge
    shapes: (N, L, k, Q, s_pad) with rows of every length 0..L + 1."""
    import numpy as np

    from repro_torch.kernels.shingle import kernel

    rng = np.random.default_rng(4)
    cases = [
        (30_001, 40, 2, 300, 896),    # rows wider than 32: the shared-memory slice
        (30_001, 33, 2, 300, 528),    # s_pad = C(33, 2), a multiple of 4, not of 128
        (30_001, 10, 3, 2048, 128),   # 2048^3 wraps int32
        (30_001, 10, 3, 300, 121),    # s_pad not a multiple of 4: scalar stores
        (30_001, 10, 3, 300, 256),    # two chunks a row
        (30_001, 12, 9, 30, 220),     # k past the register orders: the table through L1
        (30_001, 5, 1, 7, 5),
        (30_001, 2, 3, 7, 4),         # rows shorter than k: no combination, all PAD_KEY
        # C(33, 6) = 1,107,568 columns: more 128-column chunks than the grid
        # has warps, so each warp walks chunks (few rows keep the plain small)
        (65, 33, 6, 30, 1_107_568),
    ]
    for n, L, k, Q, s_pad in cases:
        lengths = torch.as_tensor(rng.integers(0, L + 2, size=n).astype(np.int32), device=dev)
        types = torch.as_tensor(rng.integers(0, Q, size=(n, L)).astype(np.int32), device=dev)
        got = kernel.shingle_kernel(types, lengths, k=k, num_types=Q, s_pad=s_pad)
        want = kernel.shingle_plain(types, lengths, k=k, num_types=Q, s_pad=s_pad)
        check(torch.equal(got, want), f"shingle kernel != plain at N={n} L={L} k={k} Q={Q} "
              f"s_pad={s_pad}")
    log(f"shingle edge shapes (N, L, k, Q, s_pad) {cases}: bit-equal to plain")


def _time_ms(torch, fn, reps=5, batch=1):
    """Median of ``reps`` CUDA-event timings after one warm-up call, each
    over ``batch`` calls back to back (divided by ``batch``: the wrapper's
    host work then overlaps the previous launch, as on a busy stream)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _bound_ms(nbytes, ops, ops_per_s=INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fused_launch_timing(torch, operands, window=None):
    """The fused scorer's kernel alone (#1, or #3 with ``window``): the
    register route as the engine launches it and the shared route forced at
    the same width, in turns (ten launches an event pair, so no wrapper
    work counts), and the parent design (the shared route with the DP on
    every pair)."""
    from repro_torch.kernels.lcs import fused

    P, H = operands[4].shape[0], operands[0].shape[1]
    lvl = torch.empty((P, H), dtype=torch.int32, device=operands[0].device)
    mss = torch.empty((P,), dtype=torch.float32, device=operands[0].device)

    def launch(variant):
        return lambda: fused.launch_variant(variant, operands, lvl, mss, window=window)

    turns = [_time_ms(torch, launch(v), batch=10) for v in ("registers", "shared", "shared", "registers")]
    ms, shared_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return dict(launch_ms=ms, shared_route_ms=shared_ms, shared_over_registers=shared_ms / ms,
                parent_design_ms=_time_ms(torch, launch("shared_no_identity"), batch=3),
                launch_turns_ms=turns)


def _needed_cells(torch, H, wla, wlb, identical):
    """DP cells these inputs need: H * wla * wlb over the pairs that are not
    one row (window) of one table."""
    return H * int((wla.long() * wlb.long() * (~identical)).sum())


def _lcs_launch_timing(torch, a, b):
    """The batched LCS kernel alone (#2) on ``a``, ``b``: the register route
    as the engine launches it and the shared route (the parent design)
    forced at the same width, in turns, ten launches an event pair; the
    register route without its DP; and the bound of these operands."""
    from repro_torch.kernels.lcs import kernel

    B, L = a.shape
    out = torch.empty((B,), dtype=torch.int32, device=a.device)

    def launch(name):
        return lambda: kernel.launch(name, a, b, out)

    turns = [_time_ms(torch, launch(v), batch=10) for v in ("registers", "shared", "shared", "registers")]
    ms, shared_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    bound, by = _bound_ms(B * (2 * L * 4 + 4), B * L * L)
    return dict(launch_ms=ms, shared_route_ms=shared_ms, shared_over_registers=shared_ms / ms,
                loads_only_ms=_time_ms(torch, launch("loads_only"), batch=10),
                launch_turns_ms=turns, launch_bound_share=bound / ms, rows=B, width=L,
                bound_ms=bound, bound_by=by)


def phase_timing(torch, main_inputs, main_counts, main_figures, kernel_operands, kernel_counts,
                 kernel_routes, figures):
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
    # the register route runs only the DP cells these inputs need
    cells = _needed_cells(torch, H, lengths[li].clamp(0, L), lengths[ri].clamp(0, L), li == ri)
    needed, needed_by = _bound_ms(nbytes, cells)
    parts = _fused_launch_timing(torch, (codes, lengths, codes, lengths, li, ri, betas))
    entries.append(dict(
        name="fused_gather_score", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_score.cu",
        replaces="src/repro/kernels/lcs/fused.py:202",
        launches=main_counts["fused_gather_score"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        needed_bound_ms=needed, needed_bound_by=needed_by, needed_cells=cells, **parts,
        **main_figures, register_kernel=figures["fused_score"],
        path=f"main: SSH engine N={MAIN_N} lcs_impl=fused",
        shape=f"table {list(codes.shape)} pairs {P}",
    ))
    log(f"timing fused_gather_score: {ms:.3f} ms with its wrapper, one launch an event pair "
        f"(the launch alone {parts['launch_ms']:.3f} ms, ten an event pair; the shared route at "
        f"L = {L} {parts['shared_route_ms']:.3f} ms = {parts['shared_over_registers']:.2f}x; the "
        f"parent design {parts['parent_design_ms']:.3f} ms; plain {plain_ms:.3f} ms in {chunk}-pair "
        f"chunks); bound {bound:.3f} ms by {by}, needed bound {needed:.3f} ms by {needed_by} "
        f"({cells:.4g} cells); routes {main_figures['launches_by_route']}; library_ms: no single "
        "PyTorch call computes an LCS")

    a, b = kernel_operands
    B, L = a.shape
    run = lambda: kernel.lcs_kernel(a, b, block_b=512)  # noqa: E731
    ms = _time_ms(torch, run)
    plain_ms = _time_ms(torch, lambda: kernel.lcs_plain(a, b), reps=3)
    err = float((run() - kernel.lcs_plain(a, b)).abs().max())
    parts = _lcs_launch_timing(torch, a, b)
    bound, by = parts.pop("bound_ms"), parts.pop("bound_by")
    entries.append(dict(
        name="lcs_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/lcs.cu",
        replaces="src/repro/kernels/lcs/kernel.py:100",
        launches=kernel_counts["lcs_kernel"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None, **parts,
        launches_by_route=kernel_routes, register_kernel=figures["lcs"],
        path=f"SSH engine N={KERNEL_N} lcs_impl=kernel",
        shape=f"rows {B} x L {L}",
    ))
    log(f"timing lcs_kernel: {ms:.3f} ms with its wrapper, one launch an event pair (the launch "
        f"alone {parts['launch_ms']:.3f} ms, ten an event pair, {parts['launch_bound_share']:.1%} "
        f"of its bound; the shared route (the parent design) at L = {L} "
        f"{parts['shared_route_ms']:.3f} ms = {parts['shared_over_registers']:.2f}x; loads and "
        f"stores alone {parts['loads_only_ms']:.3f} ms; plain {plain_ms:.3f} ms); bound "
        f"{bound:.3f} ms by {by}; routes {kernel_routes}; library_ms: no single PyTorch call "
        "computes an LCS")
    return entries


def phase_timing_lcs_windows(torch, entries, operands, routes):
    """#2's launch alone on the subtrajectory kernel path's W = 8 windows,
    added to its entry."""
    parts = _lcs_launch_timing(torch, *operands)
    parts["launches_by_route"] = routes
    next(e for e in entries if e["name"] == "lcs_kernel")["subtraj_kernel_path"] = parts
    log(f"timing lcs_kernel at the subtraj kernel path's {parts['rows']} windows of "
        f"W = {parts['width']}: the launch alone {parts['launch_ms']:.3f} ms "
        f"({parts['launch_bound_share']:.1%} of its bound {parts['bound_ms']:.3f} ms by "
        f"{parts['bound_by']}); the shared route {parts['shared_route_ms']:.3f} ms = "
        f"{parts['shared_over_registers']:.2f}x; loads and stores alone "
        f"{parts['loads_only_ms']:.3f} ms; routes {routes}")


def phase_timing_windowed_and_shingle(torch, sub_coords, sub_counts, sub_routes, main_types,
                                      shingle_counts, figures):
    from repro_torch.kernels.lcs import fused
    from repro_torch.kernels.shingle import kernel

    entries = []
    codes, lengths, _, _, ta, tb, oa, ob, betas = sub_coords
    P, H, W = ta.shape[0], codes.shape[1], SUB_WINDOW
    run = lambda: fused.fused_windowed_gather_score(*sub_coords, window=W)  # noqa: E731
    ms = _time_ms(torch, run)
    lvl, mss = run()
    chunk = 1 << 22

    def plain():
        for s in range(0, P, chunk):
            fused.fused_windowed_gather_score_plain(
                *_pairs_slice(sub_coords, slice(s, s + chunk)), window=W
            )

    plain_ms = _time_ms(torch, plain, reps=1)
    want_lvl, want_mss = fused.fused_windowed_gather_score_plain(
        *_pairs_slice(sub_coords, slice(0, chunk)), window=W
    )
    err = max(float((lvl[:chunk] - want_lvl).abs().max()),
              float((mss[:chunk] - want_mss).abs().max()))
    # each input read once (one table and lengths for both sides, four [P]
    # coordinate vectors), each output written once; one op per DP cell
    nbytes = (codes.numel() + lengths.numel() + 4 * P + H) * 4 + P * (H + 1) * 4
    bound, by = _bound_ms(nbytes, P * H * W * W)
    L = codes.shape[2]
    wla = (lengths[ta].clamp(max=L) - oa).clamp(0, W)
    wlb = (lengths[tb].clamp(max=L) - ob).clamp(0, W)
    cells = _needed_cells(torch, H, wla, wlb, (ta == tb) & (oa == ob))
    del wla, wlb
    needed, needed_by = _bound_ms(nbytes, cells)
    parts = _fused_launch_timing(torch, tuple(sub_coords), window=W)
    entries.append(dict(
        name="fused_windowed_gather_score", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_windowed_score.cu",
        replaces="src/repro/kernels/lcs/fused.py:264",
        launches=sub_counts["fused_windowed_gather_score"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        needed_bound_ms=needed, needed_bound_by=needed_by, needed_cells=cells, **parts,
        launches_by_route=sub_routes, register_kernel=figures["fused_windowed_score"],
        path=f"subtraj: SSH engine N={SUB_N} subtraj_window={W} lcs_impl=fused",
        shape=f"table {list(codes.shape)} window pairs {P}",
    ))
    log(f"timing fused_windowed_gather_score: {ms:.3f} ms with its wrapper, one launch an event "
        f"pair (the launch alone {parts['launch_ms']:.3f} ms, ten an event pair; the shared route "
        f"at W = {W} {parts['shared_route_ms']:.3f} ms = {parts['shared_over_registers']:.2f}x; the "
        f"parent design {parts['parent_design_ms']:.3f} ms; plain {plain_ms:.3f} ms in {chunk}-pair "
        f"chunks); bound {bound:.3f} ms by {by}, needed bound {needed:.3f} ms by {needed_by} "
        f"({cells:.4g} cells); routes {sub_routes}; library_ms: no single PyTorch call computes "
        "an LCS")

    types, lengths = main_types
    N, L = types.shape
    k, s_pad = 3, 128
    opts = dict(k=k, num_types=NUM_TYPES, s_pad=s_pad)
    run = lambda: kernel.shingle_kernel(types, lengths, **opts)  # noqa: E731
    ms = _time_ms(torch, run)
    plain = lambda: kernel.shingle_plain(types, lengths, **opts)  # noqa: E731
    plain_ms = _time_ms(torch, plain, reps=3)
    err = float((run().long() - plain().long()).abs().max())
    bound, by = _bound_ms(N * (L + 1) * 4 + N * s_pad * 4, N * s_pad * k)
    # the kernel alone and the parent design in turns, ten launches an event
    # pair, and the kernel's loads and stores without its picks and pack
    out = torch.empty((N, s_pad), dtype=torch.int32, device=types.device)

    def launch(name):
        return lambda: kernel.launch(name, types, lengths, out, k=k, num_types=NUM_TYPES)

    turns = [_time_ms(torch, launch(v), batch=10) for v in ("engine", "parent", "parent", "engine")]
    launch_ms, parent_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    loads_stores_ms = _time_ms(torch, launch("loads_stores"), batch=10)
    # the card's write rate over the same output: PyTorch's fill of it (a
    # yardstick of the stores alone, not a call computing the function)
    fill_ms = _time_ms(torch, lambda: out.fill_(7), batch=10)
    entries.append(dict(
        name="shingle_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/shingle.cu",
        replaces="src/repro/kernels/shingle/kernel.py:79",
        launches=shingle_counts["shingle_kernel"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        launch_ms=launch_ms, parent_design_ms=parent_ms, parent_over_launch=parent_ms / launch_ms,
        loads_stores_ms=loads_stores_ms, fill_output_ms=fill_ms, launch_turns_ms=turns,
        launch_bound_share=bound / launch_ms,
        register_kernel=figures["shingle"],
        path=f"public op shingle_keys on the main world's type codes (N={MAIN_N}; "
             "neither engine calls it)",
        shape=f"types {list(types.shape)} k {k} s_pad {s_pad}",
    ))
    log(f"timing shingle_kernel: {ms:.3f} ms with its wrapper, one launch an event pair (the "
        f"launch alone {launch_ms:.3f} ms, ten an event pair, {bound / launch_ms:.1%} of its "
        f"bound; the parent design {parent_ms:.3f} ms = {parent_ms / launch_ms:.2f}x; loads and "
        f"stores alone {loads_stores_ms:.3f} ms; PyTorch's fill of the output {fill_ms:.3f} ms; "
        f"plain {plain_ms:.3f} ms); bound {bound:.3f} ms "
        f"by {by}; library_ms: no single PyTorch call packs shingle keys")
    return entries


def phase_minhash_kernel(torch, dev, main_types, sub_types):
    """The MinHash kernel against its plain version, bit-equal, at edge
    shapes and at the shapes the MinHash backend hands it."""
    import numpy as np

    from repro_torch.core.minhash import hash_table
    from repro_torch.core.shingling import windowed_types
    from repro_torch.kernels.minhash import kernel

    rng = np.random.default_rng(2)

    def rows(n, L, high, lo_len=1):
        t = rng.integers(0, high, size=(n, L)).astype(np.int32)
        ln = rng.integers(lo_len, L + 1, size=n).astype(np.int32)
        return torch.as_tensor(t, device=dev), torch.as_tensor(ln, device=dev)

    same = torch.full((4096, 10), 7, dtype=torch.int32, device=dev)
    cases = {
        "N1": rows(1, 10, 30), "N67": rows(67, 10, 30), "N130": rows(130, 10, 30),
        "lengths_0_and_1": rows(10_007, 10, 300, lo_len=0),
        "length_1": (rows(5_001, 12, 300)[0], torch.ones(5_001, dtype=torch.int32, device=dev)),
        "identical": (same, torch.full((4096,), 10, dtype=torch.int32, device=dev)),
        "codes_2^20": rows(100_003, 10, 1 << 20, lo_len=0),
    }
    cases["lengths_0_and_1"][1][::2] = 0
    cases["lengths_0_and_1"][1][1::4] = 1
    for name, (t, ln) in cases.items():
        for P in (1, 8, 16):
            ab = hash_table(P, 0, dev)
            got = kernel.minhash_kernel(t, ln, ab)
            check(torch.equal(got, kernel.minhash_plain(t, ln, ab)),
                  f"minhash kernel != plain on {name} num_perm={P}")
        if name == "identical":
            check(bool((got == got[0]).all()), "identical rows must give identical signatures")
        if name == "codes_2^20":
            check(float((got < 0).float().mean()) > 0.5, "the wrapped hash should be mostly negative")
        log(f"minhash {name} {list(t.shape)}: kernel bit-equal to plain at num_perm 1, 8, 16")
    ab = hash_table(MINHASH_PERMS, 0, dev)
    windows = windowed_types(*sub_types, window=SUB_WINDOW)
    for name, (t, ln) in (("main world", main_types), ("window view", windows)):
        got = kernel.minhash_kernel(t, ln, ab)
        check(torch.equal(got, kernel.minhash_plain(t, ln, ab)),
              f"minhash kernel != plain on the {name}")
        log(f"minhash {name} {list(t.shape)} num_perm={MINHASH_PERMS}: kernel bit-equal to plain")


def phase_baselines_small(torch, dev, n=SMALL_N, sub_n=SUB_SMALL_N):
    """"minhash", "brp" and "udf" on the card against the plain CPU engine."""
    from repro_torch.data import synthetic_setup

    cpu_batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    for backend in ("minhash", "brp", "udf"):
        want = _engine("cpu", forest, "wavefront", backend, rho=RHO).run(cpu_batch)
        res, counts = _run_counted(_engine(dev, forest, "fused", backend, rho=RHO), batch)
        expect_launched(counts, ["fused_gather_score"]
                        + (["minhash_kernel"] if backend == "minhash" else []))
        _same_result(res, want, f"baselines small {backend}")
        log(f"baselines small: N={n} {backend} on the card == CPU plain engine "
            f"({want.stats['num_candidates']} candidates, {len(want.similar_pairs)} similar, "
            f"launches {counts})")
    cpu_batch, forest = synthetic_setup(sub_n, num_types=NUM_TYPES, seed=0, device="cpu", **SUB_ROWS)
    batch, _ = synthetic_setup(sub_n, num_types=NUM_TYPES, seed=0, device=dev, **SUB_ROWS)
    cfg = dict(subtraj_window=SUB_WINDOW)
    want = _engine("cpu", forest, "wavefront", "minhash", rho=RHO, **cfg).run(cpu_batch)
    res, counts = _run_counted(
        _engine(dev, forest, "fused", "minhash", rho=RHO, **cfg), batch)
    expect_launched(counts, ["minhash_kernel", "fused_windowed_gather_score"])
    _same_result(res, want, "baselines small minhash subtraj")
    log(f"baselines small: N={sub_n} minhash subtraj_window={SUB_WINDOW} on the card == CPU "
        f"plain engine ({want.stats['num_window_pairs']} window pairs, "
        f"{len(want.similar_pairs)} similar)")


def _centralized(dev, batch, forest):
    """The port's centralized truth on ``dev``: (similar set, seconds)."""
    from repro_torch.core import centralized_similar_pairs, encode_batch, forest_tables

    t0 = time.perf_counter()
    cl, cr, _ = centralized_similar_pairs(
        encode_batch(batch, forest_tables(forest, device=dev)), rho=RHO)
    pairs = {(int(a), int(b)) for a, b in zip(cl.tolist(), cr.tolist())}
    return pairs, time.perf_counter() - t0


def phase_accuracy(torch, dev, n=FIG10_N, udf_n=UDF_N):
    """Fig. 10's accuracy point on the card, against the port's own
    centralized truth; the UDF pipeline at fig7's cap."""
    from repro_torch.core import (
        AnotherMeConfig, maximal_cliques, minhash_candidates, qa1, qa2, run_anotherme,
        type_codes, udf_pipeline,
    )
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, **FIG10_WORLD, seed=0, device=dev)
    cpu_batch, _ = synthetic_setup(n, **FIG10_WORLD, seed=0, device="cpu")
    cen_pairs, secs = _centralized(dev, batch, forest)
    cen_comms = maximal_cliques(cen_pairs)
    check(len(cen_pairs) > 0, "fig10: empty centralized truth")
    log(f"accuracy: fig10 N={n}: centralized on the card {len(cen_pairs)} similar pairs in "
        f"{secs:.3f}s, {len(cen_comms)} maximal cliques")
    qa = {}
    for backend in ("ssh", "minhash", "brp"):
        res, counts = _run_counted(_engine(dev, forest, "fused", backend, rho=RHO), batch)
        expect_launched(counts, ["fused_gather_score"]
                        + (["minhash_kernel"] if backend == "minhash" else []))
        qa[backend] = (qa1(res.communities, cen_comms), qa2(res.similar_pairs, cen_pairs))
        if backend == "ssh":
            check(qa[backend] == (1.0, 1.0), f"fig10: ssh QA1/QA2 {qa[backend]} != 1.000")
            check(res.similar_pairs == cen_pairs, "fig10: ssh similar set != centralized")
        else:
            cpu = _engine("cpu", forest, "wavefront", backend, rho=RHO).run(cpu_batch)
            want = (qa1(cpu.communities, cen_comms), qa2(cpu.similar_pairs, cen_pairs))
            check(qa[backend] == want, f"fig10: {backend} QA {qa[backend]} != CPU engine's {want}")
            _same_result(res, cpu, f"fig10 {backend}")
        log(f"accuracy: fig10 N={n} {backend}: QA1={qa[backend][0]:.3f} QA2={qa[backend][1]:.3f} "
            f"({res.stats['num_candidates']} candidates, {len(res.similar_pairs)} similar)")
        if backend == "minhash":
            # the legacy entry point with the core candidate function
            legacy, counts = _counted(lambda: run_anotherme(
                batch, forest, AnotherMeConfig(rho=RHO, lcs_impl="fused"),
                candidate_fn=lambda e, b: minhash_candidates(type_codes(e), b.lengths,
                                                             pair_capacity=1 << 20)))
            expect_launched(counts, ["minhash_kernel", "fused_gather_score"])
            check(legacy.similar_pairs == res.similar_pairs and legacy.communities == res.communities,
                  "fig10: run_anotherme(candidate_fn=minhash_candidates) != the minhash engine")
            log(f"accuracy: fig10 N={n} run_anotherme(candidate_fn=minhash_candidates) on the card "
                f"== the minhash engine ({len(legacy.similar_pairs)} similar, launches {counts})")
    # the "user-defined" baseline at fig7's cap, on fig7's world
    batch, forest = synthetic_setup(udf_n, seed=0, device=dev)
    cen_pairs, _ = _centralized(dev, batch, forest)
    t0 = time.perf_counter()
    similar, _ = udf_pipeline(batch.places, batch.lengths, forest)
    check(similar == cen_pairs and len(similar) > 0, "udf_pipeline != centralized similar set")
    log(f"accuracy: fig7 N={udf_n}: udf_pipeline == centralized on the card "
        f"({len(similar)} similar pairs, udf {time.perf_counter() - t0:.3f}s)")


def _rescore_slice(torch, engine, batch, res, slice_pairs, tag, rho=RHO, pads_masked=False):
    """Re-score a slice of an engine's scored buffer with the plain version.
    ``pads_masked``: the buffer's PAD slots hold a masked score (the sharded
    engine's), so only its valid slots are compared."""
    from repro_torch.core.encoding import encode_batch
    from repro_torch.core.types import PAD_ID
    from repro_torch.kernels.lcs import fused

    sc = res.scored
    enc = encode_batch(batch, engine.tables)
    valid = sc.left != PAD_ID
    check(int(valid.sum()) == int(sc.count) == res.stats["num_candidates"] > 0, f"{tag}: pair count")
    check(int(sc.overflow) == 0, f"{tag}: join overflowed")
    check(bool(torch.isfinite(sc.mss).all()), f"{tag}: non-finite mss")
    check(int((valid & (sc.mss > rho)).sum()) == len(res.similar_pairs),
          f"{tag}: similar set disagrees with mss > rho")
    s = slice(0, min(slice_pairs, sc.left.shape[0]))
    li = torch.where(sc.left[s] == PAD_ID, 0, sc.left[s])
    ri = torch.where(sc.right[s] == PAD_ID, 0, sc.right[s])
    want_lvl, want_mss = fused.fused_gather_score_plain(
        enc.codes, enc.lengths, enc.codes, enc.lengths, li, ri, engine.betas)
    keep = valid[s] if pads_masked else slice(None)
    check(torch.equal(sc.level_lcs[s][keep], want_lvl[keep])
          and torch.equal(sc.mss[s][keep], want_mss[keep]), f"{tag}: scored slice != plain")
    log(f"{tag}: slice of {s.stop} scored pairs bit-equal to the plain version"
        + (f" ({int(valid[s].sum())} valid slots)" if pads_masked else ""))
    return enc


def _scale_run(torch, dev, engine, batch, tag, kernels):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, counts = _run_counted(engine, batch)
    wall = time.perf_counter() - t0
    expect_launched(counts, kernels)
    _stats_line(tag, res, counts)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    log(f"{tag}: run wall {wall:.3f}s, peak device memory {peak:.2f} GiB")
    return res, counts


def phase_minhash_scale(torch, dev, n=MAIN_N, slice_pairs=1 << 20):
    """fig7's protocol with backend="minhash" on the scalability world."""
    from repro_torch.core.encoding import type_codes
    from repro_torch.core.minhash import minhash_band_keys
    from repro_torch.core.ssh import exact_pair_count
    from repro_torch.kernels.minhash.ref import minhash_signatures
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    engine = _engine(dev, forest, "fused", "minhash", rho=RHO,
                              community_mode="components")
    tag = f"minhash N={n}"
    res, counts = _scale_run(torch, dev, engine, batch, tag,
                             ["minhash_kernel", "fused_gather_score"])
    enc = _rescore_slice(torch, engine, batch, res, slice_pairs, tag)
    keys = engine.backend.join_keys(enc, batch, engine.backend_ctx)
    types = type_codes(enc)
    want = minhash_band_keys(minhash_signatures(types, enc.lengths), bands=MINHASH_BANDS)
    check(keys.shape == (n, MINHASH_BANDS) and torch.equal(keys, want),
          f"{tag}: band keys != minhash_band_keys of the plain signatures")
    log(f"{tag}: band keys {list(keys.shape)} bit-equal to the plain signatures' "
        f"({exact_pair_count(keys)} pre-dedup pairs)")
    return counts, (types.contiguous(), enc.lengths)


def phase_brp_scale(torch, dev, n=BRP_N, slice_pairs=1 << 20):
    """backend="brp" on the scalability world at the size its join allows;
    the card's keys against the CPU's."""
    from repro_torch.core.brp import projections, type_counts
    from repro_torch.core.encoding import encode_batch, forest_tables, type_codes
    from repro_torch.core.ssh import exact_pair_count
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    engine = _engine(dev, forest, "fused", "brp", rho=RHO, community_mode="components")
    tag = f"brp N={n}"
    res, _ = _scale_run(torch, dev, engine, batch, tag, ["fused_gather_score"])
    enc = encode_batch(batch, engine.tables)
    keys = engine.backend.join_keys(enc, batch, engine.backend_ctx).cpu()
    cpu_batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    cpu_enc = encode_batch(cpu_batch, forest_tables(forest, device="cpu"))
    want = engine.backend.join_keys(cpu_enc, cpu_batch, engine.backend_ctx)
    if not torch.equal(keys, want):
        rows = torch.nonzero((keys != want).any(dim=1)).flatten()[:20].tolist()
        r = torch.as_tensor(projections(NUM_TYPES, engine.backend.num_proj, engine.backend.seed))
        for row in rows:
            card = (type_counts(type_codes(enc)[row:row + 1], enc.lengths[row:row + 1], NUM_TYPES)
                    @ r.to(dev)).cpu()
            host = type_counts(type_codes(cpu_enc)[row:row + 1], cpu_enc.lengths[row:row + 1],
                               NUM_TYPES) @ r
            log(f"{tag}: key row {row} differs: card {keys[row].tolist()} proj "
                f"{card.flatten().tolist()}, cpu {want[row].tolist()} proj {host.flatten().tolist()}")
        check(False, f"{tag}: the card's bucket keys != the CPU's")
    log(f"{tag}: bucket keys {list(keys.shape)} on the card == the CPU's "
        f"({len(torch.unique(keys))} distinct, {exact_pair_count(keys)} pre-dedup pairs)")
    _rescore_slice(torch, engine, batch, res, slice_pairs, tag)


def phase_centralized_scale(torch, dev, n=CENTRAL_N):
    """The centralized baseline on the card against the SSH engine: the
    paper's lossless claim (QA2 = 1.000)."""
    from repro_torch.core import qa2
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    cen_pairs, cen_secs = _centralized(dev, batch, forest)
    t0 = time.perf_counter()
    res = _engine(dev, forest, "fused", rho=RHO, community_mode="components").run(batch)
    ssh_secs = time.perf_counter() - t0
    check(len(cen_pairs) > 0 and res.similar_pairs == cen_pairs,
          f"centralized N={n}: similar set != the SSH engine's")
    log(f"centralized N={n}: {n * (n - 1) // 2} pairs, {len(cen_pairs)} similar, equal to the "
        f"SSH engine's (QA2={qa2(res.similar_pairs, cen_pairs):.3f}); wall: centralized "
        f"{cen_secs:.3f}s, SSH engine {ssh_secs:.3f}s")


def phase_timing_minhash(torch, minhash_types, minhash_counts):
    from repro_torch.core.minhash import hash_table
    from repro_torch.kernels.minhash import kernel

    types, lengths = minhash_types
    N, L = types.shape
    P = MINHASH_PERMS
    ab = hash_table(P, 0, types.device)
    run = lambda: kernel.minhash_kernel(types, lengths, ab)  # noqa: E731
    ms = _time_ms(torch, run)
    plain = lambda: kernel.minhash_plain(types, lengths, ab)  # noqa: E731
    plain_ms = _time_ms(torch, plain, reps=3)
    err = float((run().long() - plain().long()).abs().max())
    # the launch alone: the raw launcher bound once, ten launches an event
    # pair (no operand checks, copies or allocation counted)
    launcher = kernel._launcher()
    types_c, lengths_c, ab_c = types.contiguous(), lengths.contiguous(), ab.contiguous()
    out = torch.empty((N, P), dtype=torch.int32, device=types.device)
    args = (types_c.data_ptr(), lengths_c.data_ptr(), ab_c.data_ptr(), out.data_ptr(), N, L, P,
            kernel._MINHASH_THREADS, torch.cuda.current_stream(types.device).cuda_stream)
    launch_ms = _time_ms(torch, lambda: launcher(*args), batch=10)
    check(torch.equal(out, plain()), "minhash launch alone: output != plain")
    # each input read once, the output written once; the hash is evaluated
    # at the rows' valid positions only
    hashes = int(lengths.clamp(0, L).sum()) * P
    bound, by = _bound_ms(N * (L + 1) * 4 + P * 8 + N * P * 4, hashes * MINHASH_OPS_PER_HASH)
    log(f"timing minhash_kernel: {ms:.3f} ms with its wrapper, one launch an event pair (the "
        f"launch alone {launch_ms:.3f} ms, ten an event pair: {bound / launch_ms:.1%} of its "
        f"bound; plain {plain_ms:.3f} ms, bound {bound:.3f} ms by {by}: {hashes} hashes x "
        f"{MINHASH_OPS_PER_HASH} int32 operations); library_ms: no single PyTorch call computes "
        "the wrapped hash and row minimum")
    return [dict(
        name="minhash_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/minhash.cu",
        replaces="src/repro/kernels/minhash/kernel.py:65",
        launches=minhash_counts["minhash_kernel"], max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        launch_ms=launch_ms, launch_bound_share=bound / launch_ms,
        path=f"minhash: MinHash engine N={MAIN_N} (keys phase)",
        shape=f"types {list(types.shape)} num_perm {P}",
    )]


# ---------------------------------------------------------------------------
# streaming ingestion and top-k serving over the host-join world
# ---------------------------------------------------------------------------
def _stream(dev, forest, impl, components_impl="unionfind", backend="ssh", window=None,
            delta_join="host", n=1, mode="replicate", oc=1, autotune=False, **cfg):
    """A streaming engine on ``dev``; ``n > 1`` places its n shards there."""
    from repro_torch.api import EngineConfig, ExecutionPlan, StreamingEngine

    cfg.setdefault("community_mode", "components")
    cfg.setdefault("rho", RHO)
    plan = ExecutionPlan(delta_join=delta_join, n_shards=n, devices=(dev,) * n, score_mode=mode,
                         overlap_chunks=oc, autotune=autotune)
    return StreamingEngine(forest, EngineConfig(backend=backend, lcs_impl=impl, **cfg), plan,
                           components_impl=components_impl, window=window, device=dev)


def _live_ids(stream):
    """Global ids of the rows alive in a streaming engine's world."""
    import numpy as np

    span = stream.n - stream._base
    return np.nonzero(stream._alive_np[:span])[0] + stream._base


def _micro_batches(batch, n_batches):
    from repro_torch.core.types import TrajectoryBatch

    step = batch.num_trajectories // n_batches
    for u in range(n_batches):
        s = slice(u * step, (u + 1) * step)
        yield TrajectoryBatch(places=batch.places[s], lengths=batch.lengths[s],
                              user_id=batch.user_id[s])


def _same_stream_result(got, want, what):
    """Two streaming results equal: the scored buffer slot by slot, the
    similar pairs and the communities."""
    _same_result(got, want, what)
    check(got.stats["num_candidates"] == want.stats["num_candidates"], f"{what}: candidate count")


STREAM_PHASE_KEYS = ("t_expire", "t_keys", "t_ingest", "t_delta_join", "t_score", "t_communities")
STREAM_UPDATE_KEYS = ("t_total", "resident_bytes", "num_delta_pairs", "world_live",
                      "pairs_examined", "num_candidates", "driver_bytes_in")


def _stream_line(tag, u, res):
    s = res.stats
    log(f"{tag} update {u}: " + " ".join(f"{k}={s.get(k, 0.0):.3f}s" for k in STREAM_PHASE_KEYS)
        + f" t_total={s['t_total']:.3f}s world_live={s['world_live']} world_base={s['world_base']} "
        f"world_capacity={s['world_capacity']} resident_bytes={s['resident_bytes']} "
        f"num_delta_pairs={s['num_delta_pairs']} num_candidates={s['num_candidates']} "
        f"num_similar={s['num_similar']} num_expired={s['num_expired']} "
        f"compactions={s['compactions']} dead_fraction={s['dead_fraction']:.3f}")


def _feed(stream, batch, n_batches, *, retire_after=None, ttl_of=None, tag=None, per_update=None):
    """Feed ``batch`` as ``n_batches`` micro-batches; after update
    ``retire_after`` retire every 100th live id (1%).  Returns the last
    result and the ids retired."""
    retired = []
    res = None
    for u, mb in enumerate(_micro_batches(batch, n_batches)):
        res = stream.update(mb, ttl=ttl_of(u) if ttl_of else None)
        if per_update is not None:
            per_update(u, res)
        if tag is not None:
            _stream_line(tag, u, res)
        if u == retire_after:
            retired = _live_ids(stream)[::100].tolist()
            check(stream.retire(retired) == len(retired), f"{tag}: retire count")
    return res, retired


def phase_stream_small(torch, dev, n=STREAM_SMALL_N, n_batches=5):
    """The streaming engine on the card against the same stream on the CPU
    (plain versions): every update's scored buffer slot by slot, similar
    pairs and communities, over TTL, a window, an explicit retire and a
    compaction, per community path, prune, backend and fault injection."""
    import os

    from repro_torch.data import synthetic_setup

    t0 = time.perf_counter()
    cpu_batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    # the prune runs take rho = 5.5, so the bound (betas_sum * min length,
    # lengths 5-10) prunes the pairs with a row of 5 places
    prune = dict(score_prune=True, rho=5.5)
    runs = (  # (tag, backend, card impl, components_impl, extra config, fault injection)
        ("ssh unionfind fused", "ssh", "fused", "unionfind", {}, False),
        ("ssh jit kernel prune", "ssh", "kernel", "jit", prune, False),
        ("ssh cliques fused", "ssh", "fused", "unionfind", dict(community_mode="cliques"), False),
        ("ssh cliques fused prune", "ssh", "fused", "unionfind",
         dict(community_mode="cliques", **prune), False),
        ("minhash unionfind fused", "minhash", "fused", "unionfind", {}, False),
        ("brp jit kernel", "brp", "kernel", "jit", {}, False),
        ("ssh unionfind fused REPRO_FAULT_INJECT=1", "ssh", "fused", "unionfind", {}, True),
    )
    launches = collections.Counter()
    for tag, backend, impl, cimpl, cfg, fault in runs:
        want_stream = _stream("cpu", forest, "wavefront", cimpl, backend, window=3, **cfg)
        wants = []
        _feed(want_stream, cpu_batch, n_batches, retire_after=2, ttl_of=lambda u: 2 if u == 1 else None,
              per_update=lambda u, r: wants.append(r))
        stream = _stream(dev, forest, impl, cimpl, backend, window=3, **cfg)

        def check_update(u, res, tag=tag, wants=wants):
            _same_stream_result(res, wants[u], f"stream small {tag} update {u}")

        if fault:
            os.environ["REPRO_FAULT_INJECT"] = "1"
        try:
            (res, _), counts = _counted(lambda: _feed(
                stream, batch, n_batches, retire_after=2, ttl_of=lambda u: 2 if u == 1 else None,
                per_update=check_update))
        finally:
            os.environ.pop("REPRO_FAULT_INJECT", None)
        expect_launched(counts, ["fused_gather_score" if impl == "fused" else "lcs_kernel"]
                        + (["minhash_kernel"] if backend == "minhash" else []))
        check(res.stats["compactions"] >= 1 and res.stats["retired_total"] > 0,
              f"stream small {tag}: no compaction ({res.stats['compactions']})")
        scored = max(w.stats["num_candidates"] for w in wants)
        similar = max(len(w.similar_pairs) for w in wants)
        pruned = sum(w.stats.get("num_pruned", 0) for w in wants)
        check(scored > 0, f"stream small {tag}: nothing scored")
        check(similar > 0 or backend != "ssh" or cfg, f"stream small {tag}: no similar pairs")
        check(pruned > 0 or not cfg.get("score_prune"), f"stream small {tag}: nothing pruned")
        launches.update(counts)
        log(f"stream small {tag}: N={n} in {n_batches} updates (window 3, ttl 2, retire, "
            f"{res.stats['compactions']} compactions): card == CPU plain at every update (at most "
            f"{scored} scored and {similar} similar at once, {pruned} pruned; last update "
            f"{len(res.communities)} communities); launches {counts}")
    secs = time.perf_counter() - t0
    log(f"stream small: {len(runs)} streams in {secs:.1f} s")
    return dict(launches), secs


def _one_shot_over(torch, dev, forest, batch, live, impl="fused"):
    """A one-shot engine run on the card over the rows ``live`` of
    ``batch``; its ids map back through ``live``."""
    from repro_torch.core.types import TrajectoryBatch

    idx = torch.as_tensor(live, device=dev)
    sub = TrajectoryBatch(places=batch.places[idx], lengths=batch.lengths[idx],
                          user_id=torch.arange(len(live), dtype=torch.int32, device=dev))
    return _engine(dev, forest, impl, rho=RHO, community_mode="components").run(sub)


def _scored_sorted(sc, ids=None):
    """(pairs packed as lo << 32 | hi, level_lcs, mss) of a scored buffer's
    valid slots, sorted by pair; ``ids`` maps local ids to global."""
    import numpy as np

    from repro_torch.core.types import PAD_ID

    left, right = sc.left.cpu().numpy(), sc.right.cpu().numpy()
    ok = left != PAD_ID
    left, right = left[ok].astype(np.int64), right[ok].astype(np.int64)
    if ids is not None:
        left, right = ids[left], ids[right]
    packed = (left << 32) | right
    order = np.argsort(packed, kind="stable")
    return packed[order], sc.level_lcs.cpu().numpy()[ok][order], sc.mss.cpu().numpy()[ok][order]


def phase_stream(torch, dev, n=STREAM_N, n_batches=STREAM_BATCHES, kernel_n=STREAM_KERNEL_N):
    """fig13's world fed as 10 micro-batches with a window of 4 updates
    (compaction from update 6 on, a 1% retire after update 7): the final
    result equals a one-shot run on the card over the survivors; a 20,000-row
    stream of the same shape with ("jit", "kernel") equals ("unionfind",
    "fused")."""
    import numpy as np

    from repro_torch.data import synthetic_setup

    t0 = time.perf_counter()
    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    stream = _stream(dev, forest, "fused", "unionfind", window=STREAM_WINDOW)
    updates = []
    t_feed = time.perf_counter()
    (res, retired), counts = _counted(lambda: _feed(
        stream, batch, n_batches, retire_after=7, tag=f"stream N={n}",
        per_update=lambda u, r: updates.append(
            {k: r.stats.get(k, 0.0) for k in STREAM_PHASE_KEYS + STREAM_UPDATE_KEYS})))
    feed_s = time.perf_counter() - t_feed
    expect_launched(counts, ["fused_gather_score"])
    check(stream.compactions >= 1, f"stream: no compaction ({stream.compactions})")
    check(len(retired) > 0, "stream: nothing retired")
    live = _live_ids(stream)
    check(len(live) == res.stats["world_live"], "stream: live count")
    want = _one_shot_over(torch, dev, forest, batch, live)
    check({(int(live[a]), int(live[b])) for a, b in want.similar_pairs} == res.similar_pairs,
          "stream: similar pairs != the one-shot run over the survivors")
    check({frozenset(int(live[i]) for i in c) for c in want.communities} == res.communities,
          "stream: communities != the one-shot run over the survivors")
    got_p, got_l, got_m = _scored_sorted(res.scored)
    want_p, want_l, want_m = _scored_sorted(want.scored, live.astype(np.int64))
    check(np.array_equal(got_p, want_p) and np.array_equal(got_l, want_l)
          and np.array_equal(got_m, want_m),
          "stream: scored (pair, level_lcs, mss) set != the one-shot run over the survivors")
    log(f"stream N={n}: {n_batches} updates in {feed_s:.3f} s, {stream.compactions} compactions, "
        f"{len(retired)} retired after update 7, {len(live)} survivors; == one-shot over the "
        f"survivors ({len(got_p)} scored pairs, {len(res.similar_pairs)} similar, "
        f"{len(res.communities)} communities); launches {counts}")
    sums = {k: sum(u[k] for u in updates) for k in STREAM_PHASE_KEYS + ("t_total",)}
    log(f"stream N={n} phase sums over the updates: "
        + " ".join(f"{k}={v:.3f}s" for k, v in sums.items()))

    kbatch, kforest = synthetic_setup(kernel_n, num_types=NUM_TYPES, seed=0, device=dev)
    results, kcounts = {}, {}
    for impl, cimpl in (("kernel", "jit"), ("fused", "unionfind")):
        s = _stream(dev, kforest, impl, cimpl, window=STREAM_WINDOW)
        (results[impl], _), kcounts[impl] = _counted(
            lambda s=s: _feed(s, kbatch, n_batches, retire_after=7))
        check(s.compactions >= 1, f"stream N={kernel_n} {impl}: no compaction")
    expect_launched(kcounts["kernel"], ["lcs_kernel"])
    expect_launched(kcounts["fused"], ["fused_gather_score"])
    _same_stream_result(results["kernel"], results["fused"], f"stream N={kernel_n} kernel/jit vs fused/unionfind")
    check(len(results["fused"].similar_pairs) > 0, f"stream N={kernel_n}: no similar pairs")
    secs = time.perf_counter() - t0
    log(f"stream N={kernel_n}: (jit, kernel) == (unionfind, fused) ({results['fused'].stats['num_candidates']} "
        f"scored, {len(results['fused'].similar_pairs)} similar); launches {kcounts}")
    log(f"stream: phase in {secs:.1f} s")
    return stream, batch, forest, dict(counts=counts, kernel_counts=kcounts, updates=updates,
                                       feed_s=feed_s, phase_s=secs, final=res, one_shot=want,
                                       live=live, retired=retired)


def _brute_hits(torch, stream, world, q_places, q_lengths, rho_min, slice_pairs=1 << 20,
                block=128):
    """Whole-live-world brute force: every (query, live row) pair scored by
    #1 (``fused_score``, the engine's dispatch); returns the (query, global
    row, mss) of the pairs with mss > ``rho_min``, and how many of the first
    pairs were re-scored by the plain version (``slice_pairs``)."""
    import numpy as np

    from repro_torch.core.encoding import encode_codes
    from repro_torch.core.types import PAD_PLACE
    from repro_torch.kernels.lcs import fused

    dev = stream.device
    live = _live_ids(stream)
    idx = torch.as_tensor(live, device=dev)
    L = max(world.places.shape[1], q_places.shape[1])
    pad = lambda p: torch.nn.functional.pad(p, (0, L - p.shape[1]), value=PAD_PLACE)  # noqa: E731
    w_codes = encode_codes(pad(world.places[idx]), stream.tables)
    w_len = world.lengths[idx]
    q_codes = encode_codes(pad(q_places), stream.tables)
    Q, n = q_codes.shape[0], len(live)
    hits, rescored = [], 0
    for q0 in range(0, Q, block):
        qb = min(block, Q - q0)
        left = torch.arange(q0, q0 + qb, dtype=torch.int32, device=dev).repeat_interleave(n)
        right = torch.arange(n, dtype=torch.int32, device=dev).repeat(qb)
        lvl, mss = fused.fused_score(q_codes, q_lengths, w_codes, w_len, left, right, stream.betas)
        if rescored < slice_pairs:
            s = slice(0, slice_pairs - rescored)
            p_lvl, p_mss = fused.fused_gather_score_plain(q_codes, q_lengths, w_codes, w_len,
                                                          left[s], right[s], stream.betas)
            check(torch.equal(p_lvl, lvl[s]) and torch.equal(p_mss, mss[s]),
                  "brute force: #1 != its plain version on a slice")
            rescored += p_lvl.shape[0]
        m = mss > rho_min
        hits.append((left[m].cpu().numpy(), right[m].cpu().numpy(), mss[m].cpu().numpy()))
    q = np.concatenate([h[0] for h in hits])
    row = live[np.concatenate([h[1] for h in hits])].astype(np.int64)
    return q, row, np.concatenate([h[2] for h in hits]), rescored


def _rank_topk(q, row, mss, k_vec, rho_vec):
    """The brute force's top-k: matches above each query's rho ranked with
    numpy ``lexsort`` by (mss desc, row asc); [Q, k_max] ids (PAD_ID in
    empty slots) and mss (-1.0)."""
    import numpy as np

    from repro_torch.core.types import PAD_ID

    ok = mss > rho_vec[q]
    q, row, mss = q[ok], row[ok], mss[ok]
    order = np.lexsort((row, -mss, q))
    q, row, mss = q[order], row[order], mss[order]
    Q = k_vec.shape[0]
    ids = np.full((Q, int(k_vec.max())), PAD_ID, np.int32)
    out = np.full(ids.shape, -1.0, np.float32)
    starts = np.searchsorted(q, np.arange(Q))
    ends = np.searchsorted(q, np.arange(Q), side="right")
    for i in range(Q):
        take = min(int(k_vec[i]), int(ends[i] - starts[i]))
        ids[i, :take] = row[starts[i]:starts[i] + take]
        out[i, :take] = mss[starts[i]:starts[i] + take]
    return ids, out


def phase_serve(torch, dev, stream, world, n_queries=SERVE_QUERIES, k=SERVE_K):
    """``QueryEngine`` over the stream phase's final world: 1,000 fresh
    trajectories and 1,000 live rows, prune off and on, with default and
    per-query k and rho, against a whole-live-world brute force."""
    import numpy as np

    from repro_torch.api import QueryEngine
    from repro_torch.data.synthetic import synthetic_trajectories

    t0 = time.perf_counter()
    fresh = synthetic_trajectories(n_queries, seed=7, device=dev)
    live = _live_ids(stream)
    pick = torch.as_tensor(live[np.linspace(0, len(live) - 1, n_queries).astype(np.int64)], device=dev)
    rng = np.random.default_rng(3)
    k_vec = rng.choice([0, 1, 5, 10, 40], size=n_queries).astype(np.int32)
    rho_vec = rng.choice([2.0, 2.5, 3.0], size=n_queries).astype(np.float32)
    default = (np.full(n_queries, k, np.int32), np.full(n_queries, RHO, np.float32))
    figures, launches, cases = [], collections.Counter(), []
    for qname, (qp, ql) in (("fresh", (fresh.places, fresh.lengths)),
                            ("live", (world.places[pick], world.lengths[pick]))):
        from repro_torch.core.types import TrajectoryBatch

        qbatch = TrajectoryBatch(places=qp, lengths=ql,
                                 user_id=torch.arange(n_queries, dtype=torch.int32, device=dev))
        hq, hrow, hmss, rescored = _brute_hits(torch, stream, world, qp, ql,
                                                min(RHO, float(rho_vec.min())))
        for kname, (kv, rv) in (("k=10", default), ("per-query k, rho", (k_vec, rho_vec))):
            want_ids, want_mss = _rank_topk(hq, hrow, hmss, kv, rv)
            got = {}
            for prune in (False, True):
                qe = QueryEngine(stream, k=k, serve_prune=prune)
                kw = {} if kname == "k=10" else dict(k=kv, rho=rv)
                tq = time.perf_counter()
                res, counts = _counted(lambda: qe.query(qbatch, **kw))
                wall = time.perf_counter() - tq
                expect_launched(counts, ["fused_gather_score"])
                launches.update(counts)
                check(np.array_equal(res.match_ids, want_ids) and np.array_equal(res.mss, want_mss),
                      f"serve {qname} {kname} prune={prune}: top-k != the brute force")
                got[prune] = res
                cases.append((qname, kname, prune, qbatch, kw, res))
                s = res.stats
                figures.append(dict(queries=qname, k=kname, prune=prune, wall_s=wall,
                                    qps=n_queries / wall, candidates=s["candidates"],
                                    rounds_run=s["rounds_run"], rounds_skipped=s["rounds_skipped"],
                                    cells_skipped=s["cells_skipped"]))
                log(f"serve {qname} {kname} prune={prune}: {n_queries} queries in {wall:.3f} s = "
                    f"{n_queries / wall:.1f} queries/s; candidates {s['candidates']} "
                    f"(probe examined {s['probe_examined']}), rounds_run {s['rounds_run']}, "
                    f"rounds_skipped {s['rounds_skipped']}, cells_skipped {s['cells_skipped']}; "
                    f"{int((res.match_ids != 2**31 - 1).sum())} matches == the brute force "
                    f"({len(hq)} brute-force pairs above {min(RHO, float(rho_vec.min()))}, {rescored} "
                    f"re-scored by the plain version); "
                    f"launches {counts}")
            check(np.array_equal(got[False].match_ids, got[True].match_ids)
                  and np.array_equal(got[False].mss, got[True].mss),
                  f"serve {qname} {kname}: prune on != prune off")
    secs = time.perf_counter() - t0
    log(f"serve: phase in {secs:.1f} s over a world of {len(live)} live rows")
    return dict(launches), figures, secs, cases

# ---------------------------------------------------------------------------
# the device-resident join (delta_join="device") and serving over its slab
# ---------------------------------------------------------------------------
def _tombstones_examined(stream, mb):
    """Slab tombstones the device join examined for micro-batch ``mb`` (just
    ingested): each of its rows' keys meets every resident tombstone of that
    key, counted from the join's count mirror.  The host join drops a
    retired row from its buckets at once, so its ``pairs_examined`` is the
    device join's less these until a compaction reclaims them."""
    import numpy as np

    from repro_torch.core.device_index import flat_row_keys

    dead = stream._join_stats.dead_counts
    if not dead or not mb.num_trajectories:
        return 0
    k_flat, _ = flat_row_keys(stream._new_row_keys(mb.places.cpu().numpy(), mb.lengths.cpu().numpy()))
    dk = np.fromiter(dead.keys(), np.int64, len(dead))
    dc = np.fromiter(dead.values(), np.int64, len(dead))
    order = np.argsort(dk)
    dk, dc = dk[order], dc[order]
    idx = np.minimum(np.searchsorted(dk, k_flat), len(dk) - 1)
    hit = dk[idx] == k_flat
    return int(dc[idx[hit]].sum())


def _same_device_update(got, want, what, tombstones=0):
    """A device-join update equals ``want`` (another stream of the same
    rows): the scored buffer slot by slot, similar pairs, communities, and
    pairs examined (less the ``tombstones`` examined, where ``want`` is a
    host join), and no pair crossed from the host."""
    _same_stream_result(got, want, what)
    check(got.stats["pairs_examined"] == want.stats["pairs_examined"] + tombstones,
          f"{what}: pairs examined {got.stats['pairs_examined']} != {want.stats['pairs_examined']} "
          f"+ {tombstones} tombstones")
    check(got.stats["driver_pair_rows"] == 0, f"{what}: {got.stats['driver_pair_rows']} pair rows "
          "crossed from the host")


def phase_stream_device_small(torch, dev, n=STREAM_SMALL_N, n_batches=5):
    """The stream small phase's streams with ``delta_join="device"``: on the
    card against the same device-join stream on the CPU (plain versions)
    and against the card's host-join stream, at every update."""
    import os

    from repro_torch.data import synthetic_setup

    t0 = time.perf_counter()
    cpu_batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    prune = dict(score_prune=True, rho=5.5)
    runs = (  # (tag, backend, card impl, components_impl, extra config, fault injection)
        ("ssh unionfind fused", "ssh", "fused", "unionfind", {}, False),
        ("ssh jit kernel prune", "ssh", "kernel", "jit", prune, False),
        ("minhash unionfind fused prune", "minhash", "fused", "unionfind", prune, False),
        ("brp jit kernel", "brp", "kernel", "jit", {}, False),
        ("ssh unionfind fused REPRO_FAULT_INJECT=1", "ssh", "fused", "unionfind", {}, True),
    )
    feed = dict(retire_after=2, ttl_of=lambda u: 2 if u == 1 else None)
    launches = collections.Counter()
    for tag, backend, impl, cimpl, cfg, fault in runs:
        if fault:
            os.environ["REPRO_FAULT_INJECT"] = "1"
        try:
            wants, hosts, attempts, tombs = [], [], [], []
            _feed(_stream("cpu", forest, "wavefront", cimpl, backend, window=3, delta_join="device",
                          **cfg), cpu_batch, n_batches, per_update=lambda u, r: wants.append(r), **feed)
            _feed(_stream(dev, forest, impl, cimpl, backend, window=3, **cfg), batch, n_batches,
                  per_update=lambda u, r: hosts.append(r), **feed)
            stream = _stream(dev, forest, impl, cimpl, backend, window=3, delta_join="device", **cfg)

            mbs = list(_micro_batches(batch, n_batches))

            def check_update(u, res, tag=tag, stream=stream, mbs=mbs):
                _same_device_update(res, wants[u], f"stream device small {tag} update {u} (vs CPU)")
                tombs.append(_tombstones_examined(stream, mbs[u]))
                _same_device_update(res, hosts[u], f"stream device small {tag} update {u} (vs host join)",
                                    tombs[-1])
                attempts.append(stream.join_timing["attempts"])

            (res, _), counts = _counted(lambda: _feed(stream, batch, n_batches,
                                                      per_update=check_update, **feed))
        finally:
            os.environ.pop("REPRO_FAULT_INJECT", None)
        expect_launched(counts, ["fused_gather_score" if impl == "fused" else "lcs_kernel"]
                        + (["minhash_kernel"] if backend == "minhash" else []))
        check(res.stats["compactions"] >= 1 and res.stats["retired_total"] > 0,
              f"stream device small {tag}: no compaction ({res.stats['compactions']})")
        check(max(w.stats["num_candidates"] for w in wants) > 0, f"stream device small {tag}: nothing scored")
        pruned = sum(w.stats.get("num_pruned", 0) for w in wants)
        check(pruned > 0 or not cfg.get("score_prune"), f"stream device small {tag}: nothing pruned")
        retries = sum(a - 1 for a in attempts if a)
        check(retries > 0 or not fault, f"stream device small {tag}: no join retry fired")
        launches.update(counts)
        log(f"stream device small {tag}: N={n} in {n_batches} updates: card == CPU device join == card "
            f"host join at every update ({pruned} pruned, {retries} join retries, {sum(tombs)} "
            f"tombstones examined, slab "
            f"{stream._slab_cap} slots, {res.stats['compactions']} compactions); launches {counts}")
    secs = time.perf_counter() - t0
    log(f"stream device small: {len(runs)} streams in {secs:.1f} s")
    return dict(launches), secs


STREAM_DEVICE_KEYS = ("world_capacity", "resident_bytes", "driver_bytes_in", "driver_key_rows",
                      "driver_mirror_keys", "join_traces", "score_traces", "join_pair_cap",
                      "score_pair_cap", "pairs_examined", "num_delta_pairs")


def phase_stream_device(torch, dev, batch, forest, host, n_batches=STREAM_BATCHES):
    """The stream phase's world and schedule with ``delta_join="device"``:
    every update examines what the host join's did, and the final update
    equals the host join's result and the one-shot run over the survivors.
    Logs each update's phase seconds, the join's split between the host
    mirror (planning and commit) and the join function (CUDA events), the
    slab and the resident bytes."""
    import numpy as np

    t0 = time.perf_counter()
    stream = _stream(dev, forest, "fused", "unionfind", window=STREAM_WINDOW, delta_join="device")
    updates = []
    mbs = list(_micro_batches(batch, n_batches))
    # t_score's host part: copying the scored slots back and ordering them
    # (timed after a sync, so the score function's card work is not in it)
    collect = {"s": 0.0}
    real_collect = stream._collect_scored

    def timed_collect(out):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = real_collect(out)
        collect["s"] += time.perf_counter() - t
        return got

    stream._collect_scored = timed_collect

    def per_update(u, r):
        s = r.stats
        check(s["driver_pair_rows"] == 0, f"stream device update {u}: pair rows crossed from the host")
        tombs = _tombstones_examined(stream, mbs[u])
        check(s["pairs_examined"] == host["updates"][u]["pairs_examined"] + tombs,
              f"stream device update {u}: pairs examined {s['pairs_examined']} != the host join's "
              f"{host['updates'][u]['pairs_examined']} + {tombs} tombstones")
        check(s["num_candidates"] == host["updates"][u]["num_candidates"],
              f"stream device update {u}: scored count != the host join's")
        row = {k: s.get(k, 0.0) for k in STREAM_PHASE_KEYS + ("t_total",) + STREAM_DEVICE_KEYS}
        row.update(tombstones_examined=tombs, host_pairs_examined=host["updates"][u]["pairs_examined"],
                   slab_cap=stream._slab_cap, mirror_s=stream.join_timing["mirror_s"],
                   join_program_ms=stream.join_timing["program_ms"],
                   join_attempts=stream.join_timing["attempts"], collect_s=collect["s"])
        collect["s"] = 0.0
        updates.append(row)
        _stream_line(f"stream device N={batch.num_trajectories}", u, r)
        log(f"stream device update {u}: delta_join split: host mirror {row['mirror_s']:.3f} s, join "
            f"function {row['join_program_ms']:.3f} ms ({row['join_attempts']} runs); slab "
            f"{row['slab_cap']} slots, t_score's host collect {row['collect_s']:.3f} s, pairs_examined {s['pairs_examined']} (host join "
            f"{row['host_pairs_examined']} + {tombs} tombstones), resident_bytes "
            f"{s['resident_bytes']}, driver_bytes_in "
            f"{s['driver_bytes_in']}, driver_key_rows {s['driver_key_rows']}, driver_mirror_keys "
            f"{s['driver_mirror_keys']}, join_traces {s['join_traces']}, score_traces "
            f"{s['score_traces']}, join_pair_cap {s['join_pair_cap']}, score_pair_cap "
            f"{s['score_pair_cap']}")

    t_feed = time.perf_counter()
    (res, retired), counts = _counted(lambda: _feed(stream, batch, n_batches, retire_after=7,
                                                    per_update=per_update))
    feed_s = time.perf_counter() - t_feed
    expect_launched(counts, ["fused_gather_score"])
    check(retired == host["retired"], "stream device: retired other ids than the host join")
    check(stream.compactions >= 1, "stream device: no compaction")
    _same_stream_result(res, host["final"], "stream device final update vs the host join")
    live = host["live"]
    check(np.array_equal(_live_ids(stream), live), "stream device: survivors != the host join's")
    want = host["one_shot"]
    check({(int(live[a]), int(live[b])) for a, b in want.similar_pairs} == res.similar_pairs,
          "stream device: similar pairs != the one-shot run over the survivors")
    check({frozenset(int(live[i]) for i in c) for c in want.communities} == res.communities,
          "stream device: communities != the one-shot run over the survivors")
    got_p, got_l, got_m = _scored_sorted(res.scored)
    want_p, want_l, want_m = _scored_sorted(want.scored, live.astype(np.int64))
    check(np.array_equal(got_p, want_p) and np.array_equal(got_l, want_l)
          and np.array_equal(got_m, want_m),
          "stream device: scored (pair, level_lcs, mss) set != the one-shot run over the survivors")
    check(stream._index.num_keys_inserted == 0, "stream device: the host BucketIndex was used")
    sums = {k: sum(u[k] for u in updates)
            for k in STREAM_PHASE_KEYS + ("t_total", "mirror_s", "collect_s")}
    sums["join_program_s"] = sum(u["join_program_ms"] for u in updates) / 1e3
    host_sums = {k: sum(u[k] for u in host["updates"]) for k in STREAM_PHASE_KEYS + ("t_total",)}
    secs = time.perf_counter() - t0
    log(f"stream device N={batch.num_trajectories}: {n_batches} updates in {feed_s:.3f} s (host join "
        f"{host['feed_s']:.3f} s), {stream.compactions} compactions, {len(retired)} retired; final "
        f"update == the host join's (scored slot by slot, {len(res.similar_pairs)} similar, "
        f"{len(res.communities)} communities) == the one-shot run over the {len(live)} survivors; "
        f"launches {counts}")
    log("stream device phase sums: " + " ".join(f"{k}={v:.3f}s" for k, v in sums.items()))
    log("stream host phase sums: " + " ".join(f"{k}={v:.3f}s" for k, v in host_sums.items()))
    log(f"stream device: phase in {secs:.1f} s")
    return stream, dict(counts=counts, updates=updates, feed_s=feed_s, phase_s=secs, final=res,
                        retired=retired)


def phase_serve_world(torch, dev, stream, cases, name):
    """The serve phase's query batches over another world of the same rows
    (the device join's, or a sharded one): every answer equals the
    one-shard host-join world's; over a device-join world the host index is
    never probed.  Logs queries per second, candidates, probe counts and the
    REPOSE rounds and cells skipped."""
    import numpy as np

    from repro_torch.api import QueryEngine
    from repro_torch.core import stream_index

    t0 = time.perf_counter()
    slab = stream.delta_join == "device"
    check(not slab or stream._index.num_keys_inserted == 0, f"{name}: the host index holds entries")
    probes = []
    real = stream_index.BucketIndex.probe
    stream_index.BucketIndex.probe = lambda self, *a, **kw: (probes.append(1), real(self, *a, **kw))[1]
    figures, launches = [], collections.Counter()
    try:
        for qname, kname, prune, qbatch, kw, want in cases:
            qe = QueryEngine(stream, k=SERVE_K, serve_prune=prune)
            tq = time.perf_counter()
            res, counts = _counted(lambda: qe.query(qbatch, **kw))
            wall = time.perf_counter() - tq
            expect_launched(counts, ["fused_gather_score"])
            launches.update(counts)
            check(np.array_equal(res.match_ids, want.match_ids) and np.array_equal(res.mss, want.mss),
                  f"{name} {qname} {kname} prune={prune}: top-k != the one-shard host join's")
            n_q, s = len(res.match_ids), res.stats
            figures.append(dict(queries=qname, k=kname, prune=prune, wall_s=wall, qps=n_q / wall,
                                candidates=s["candidates"], probe_examined=s["probe_examined"],
                                host_candidates=want.stats["candidates"],
                                rounds_run=s["rounds_run"], rounds_skipped=s["rounds_skipped"],
                                cells_skipped=s["cells_skipped"]))
            log(f"{name} {qname} {kname} prune={prune}: {n_q} queries in {wall:.3f} s = "
                f"{n_q / wall:.1f} queries/s; candidates {s['candidates']} (host join "
                f"{want.stats['candidates']}), probe examined {s['probe_examined']} (host join "
                f"{want.stats['probe_examined']}), probe_traces {s['probe_traces']}, rounds_run "
                f"{s['rounds_run']}, rounds_skipped {s['rounds_skipped']}, cells_skipped "
                f"{s['cells_skipped']}; == the one-shard host join's answers; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
    finally:
        stream_index.BucketIndex.probe = real
    check(not (slab and probes), f"{name}: BucketIndex.probe was called {len(probes)} times")
    secs = time.perf_counter() - t0
    log(f"{name}: phase in {secs:.1f} s over {stream.plan.n_shards} shards"
        + (", host index never probed" if slab else ""))
    return dict(launches), figures, secs

# ---------------------------------------------------------------------------
# sharded streaming and serving: StreamingEngine on n shards of the card
# ---------------------------------------------------------------------------
# (n_shards, delta join, score_mode, overlap_chunks, lcs_impl, backend, score_prune,
#  the kernels the card's stream must launch)
STREAM_SHARDED_SMALL = (
    (2, "host", "replicate", 1, "fused", "ssh", False, ["fused_gather_score"]),
    (3, "host", "shuffle", 1, "kernel", "ssh", True, ["lcs_kernel"]),
    (4, "host", "shuffle", 4, "fused", "ssh", False, ["fused_gather_score"]),
    (4, "device", "replicate", 1, "fused", "minhash", False, ["minhash_kernel", "fused_gather_score"]),
    (4, "device", "shuffle", 4, "fused", "ssh", True, ["fused_gather_score"]),
    (3, "device", "shuffle", 1, "kernel", "ssh", False, ["lcs_kernel"]),
    (2, "device", "replicate", 1, "kernel", "ssh", True, ["lcs_kernel"]),
)


def _on_card(stream):
    kinds = {d.type for d in stream._eng.mesh().devices}
    check(kinds == {"cuda"}, f"shards placed on {kinds}")


def phase_stream_sharded_small(torch, dev, n=STREAM_SMALL_N, n_batches=5):
    """The stream small phase's feed (window 3, a TTL of 2, a retire, a
    compaction) on 2, 3 and 4 shards of the card, both joins, both score
    modes: at every update equal to the card's one-shard stream of the same
    join (scored buffer slot by slot, similar pairs, communities, pairs
    examined) and to the same plan on CPU shards (plain versions)."""
    from repro_torch.data import synthetic_setup

    t0 = time.perf_counter()
    cpu_batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device="cpu")
    batch, _ = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    feed = dict(retire_after=2, ttl_of=lambda u: 2 if u == 1 else None)
    one_shard, launches = {}, collections.Counter()
    for shards, join, mode, oc, impl, backend, prune, kernels in STREAM_SHARDED_SMALL:
        tag = f"stream sharded small n_shards={shards} {join} join {mode} overlap_chunks={oc} {impl} {backend} prune={prune}"
        cfg = dict(score_prune=True, rho=PRUNE_RHO) if prune else {}
        key = (join, backend, prune)
        if key not in one_shard:
            one_shard[key] = []
            _feed(_stream(dev, forest, "fused", backend=backend, window=3, delta_join=join, **cfg),
                  batch, n_batches, per_update=lambda u, r, k=key: one_shard[k].append(r), **feed)
        cpus = []
        _feed(_stream("cpu", forest, impl, backend=backend, window=3, delta_join=join, n=shards,
                      mode=mode, oc=oc, **cfg),
              cpu_batch, n_batches, per_update=lambda u, r: cpus.append(r), **feed)
        stream = _stream(dev, forest, impl, backend=backend, window=3, delta_join=join, n=shards,
                         mode=mode, oc=oc, **cfg)
        _on_card(stream)

        def check_update(u, res, tag=tag, key=key, cpus=cpus):
            one = one_shard[key][u]
            _same_stream_result(res, one, f"{tag} update {u} (vs one shard)")
            check(res.stats["pairs_examined"] == one.stats["pairs_examined"],
                  f"{tag} update {u}: pairs examined != one shard's")
            _same_stream_result(res, cpus[u], f"{tag} update {u} (vs CPU shards)")
            check(res.stats["join_overflow"] == 0, f"{tag} update {u}: overflow")

        (res, _), counts = _counted(lambda: _feed(stream, batch, n_batches, per_update=check_update,
                                                  **feed))
        expect_launched(counts, kernels)
        check(res.stats["compactions"] >= 1 and stream._base % shards == 0,
              f"{tag}: compactions {res.stats['compactions']}, base {stream._base}")
        pruned = sum(r.stats.get("num_pruned", 0) for r in one_shard[key])
        check(pruned > 0 or not prune, f"{tag}: nothing pruned")
        check(max(r.stats["num_candidates"] for r in cpus) > 0, f"{tag}: nothing scored")
        launches.update(counts)
        log(f"{tag}: N={n} in {n_batches} updates == the card's one-shard stream == CPU shards at "
            f"every update ({res.stats['num_candidates']} scored, {pruned} pruned, "
            f"{res.stats['compactions']} compactions, base {stream._base}); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
    secs = time.perf_counter() - t0
    log(f"stream sharded small: {len(STREAM_SHARDED_SMALL)} plans in {secs:.1f} s")
    return dict(launches), secs


def _sharded_feed(torch, dev, stream, batch, n_batches, tag, one, extra=None):
    """Feed fig13's schedule into a sharded stream, checking each update's
    pairs examined against the one-shard stream's; returns the last result,
    the retired ids, launch counts, per-update rows, feed seconds and peak
    device memory (GiB)."""
    updates = []

    def per_update(u, r):
        s = r.stats
        check(s["pairs_examined"] == one["updates"][u]["pairs_examined"],
              f"{tag} update {u}: pairs examined {s['pairs_examined']} != one shard's "
              f"{one['updates'][u]['pairs_examined']}")
        check(s["join_overflow"] == 0, f"{tag} update {u}: overflow")
        row = {k: s.get(k, 0.0) for k in STREAM_PHASE_KEYS + STREAM_UPDATE_KEYS}
        if extra is not None:
            row.update(extra(u, r))
        updates.append(row)

    torch.cuda.reset_peak_memory_stats(dev)
    t_feed = time.perf_counter()
    (res, retired), counts = _counted(lambda: _feed(stream, batch, n_batches, retire_after=7,
                                                    tag=tag, per_update=per_update))
    feed_s = time.perf_counter() - t_feed
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(retired == one["retired"], f"{tag}: retired other ids than one shard")
    _same_stream_result(res, one["final"], f"{tag}: final update vs one shard")
    check(stream.compactions >= 1 and stream._base % stream.plan.n_shards == 0,
          f"{tag}: compactions {stream.compactions}, base {stream._base}")
    sums = {k: sum(u[k] for u in updates) for k in STREAM_PHASE_KEYS + ("t_total",)}
    log(f"{tag}: {n_batches} updates in {feed_s:.3f} s (one shard {one['feed_s']:.3f} s), "
        f"{stream.compactions} compactions, base {stream._base}, {len(retired)} retired; final "
        f"update == one shard's (scored slot by slot, {len(res.similar_pairs)} similar, "
        f"{len(res.communities)} communities); peak device memory {peak:.2f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"{tag} phase sums: " + " ".join(f"{k}={v:.3f}s" for k, v in sums.items()))
    return res, counts, updates, feed_s, peak


def phase_stream_sharded(torch, dev, batch, forest, host, n_batches=STREAM_BATCHES, shards=SHARDS):
    """fig13's stream (10 x 20,000, window 4, 1% retired after update 7) on
    four shards of the card, host join, replicate, "fused": every update
    examines the one-shard host join's pairs, and the final update equals
    its result."""
    t0 = time.perf_counter()
    stream = _stream(dev, forest, "fused", window=STREAM_WINDOW, n=shards)
    _on_card(stream)
    tag = f"stream sharded N={batch.num_trajectories} n_shards={shards} host join replicate"
    res, counts, updates, feed_s, peak = _sharded_feed(torch, dev, stream, batch, n_batches, tag,
                                                       host)
    expect_launched(counts, ["fused_gather_score"])
    check(counts["fused_gather_score"] == shards * n_batches,
          f"{tag}: #1 launched {counts['fused_gather_score']} times (one a shard an update)")
    secs = time.perf_counter() - t0
    log(f"stream sharded: phase in {secs:.1f} s")
    return stream, dict(counts=counts, updates=updates, feed_s=feed_s, phase_s=secs, peak_gib=peak)


def _stack_ms(torch, stream, reps=5):
    """CUDA-event median of the join program's output stack of the merged
    slabs (``mesh.stack`` of the shards' keys and rows), at the stream's
    slab; returns (ms, bytes it writes)."""
    mesh, n = stream._eng.mesh(), stream.plan.n_shards
    keys = list(stream._slab_keys.reshape(n, -1).clone())
    rows = list(stream._slab_rows.reshape(n, -1).clone())
    times = []
    for _ in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        mesh.stack(keys)
        mesh.stack(rows)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:]), 2 * stream._slab_keys.numel() * 4


def phase_stream_device_sharded(torch, dev, batch, forest, device, n_batches=STREAM_BATCHES,
                                shards=SHARDS, chunks=4):
    """fig13's stream on four shards of the card, device join, shuffle,
    ``overlap_chunks=4``, "fused": every update examines the one-shard device
    join's pairs, and the final update equals its result.  Logs each update's
    join split (host mirror against the join program), slab, resident bytes,
    and the output stack of the merged slabs."""
    t0 = time.perf_counter()
    stream = _stream(dev, forest, "fused", window=STREAM_WINDOW, delta_join="device", n=shards,
                     mode="shuffle", oc=chunks)
    _on_card(stream)
    tag = (f"stream device sharded N={batch.num_trajectories} n_shards={shards} device join "
           f"shuffle overlap_chunks={chunks}")

    def extra(u, r):
        t = stream.join_timing
        row = dict(mirror_s=t["mirror_s"], join_program_ms=t["program_ms"],
                   join_attempts=t["attempts"], slab_cap=stream._slab_cap,
                   **{k: r.stats.get(k, 0) for k in STREAM_DEVICE_KEYS})
        check(r.stats["driver_pair_rows"] == 0, f"{tag} update {u}: pair rows crossed from the host")
        log(f"{tag} update {u}: delta_join split: host mirror {t['mirror_s']:.3f} s, join program "
            f"{t['program_ms']:.3f} ms ({t['attempts']} runs); slab {stream._slab_cap} slots a shard, "
            f"resident_bytes {r.stats['resident_bytes']}, score_pair_cap {r.stats['score_pair_cap']}, "
            f"join_pair_cap {r.stats['join_pair_cap']}, score_traces {r.stats['score_traces']}, "
            f"join_traces {r.stats['join_traces']}")
        return row

    res, counts, updates, feed_s, peak = _sharded_feed(torch, dev, stream, batch, n_batches, tag,
                                                       device, extra)
    expect_launched(counts, ["fused_gather_score"])
    check(stream._index.num_keys_inserted == 0, f"{tag}: the host BucketIndex was used")
    stack_ms, stack_bytes = _stack_ms(torch, stream)
    mirror = sum(u["mirror_s"] for u in updates)
    program = sum(u["join_program_ms"] for u in updates) / 1e3
    secs = time.perf_counter() - t0
    log(f"{tag}: delta_join split over the updates: host mirror {mirror:.3f} s, join program "
        f"{program:.3f} s (one shard: {sum(u['mirror_s'] for u in device['updates']):.3f} s, "
        f"{sum(u['join_program_ms'] for u in device['updates']) / 1e3:.3f} s); the merged slabs' "
        f"output stack {stack_ms:.3f} ms for {stack_bytes} bytes (slab {stream._slab_cap} slots a "
        f"shard)")
    log(f"stream device sharded: phase in {secs:.1f} s")
    return stream, dict(counts=counts, updates=updates, feed_s=feed_s, phase_s=secs, peak_gib=peak,
                        mirror_s=mirror, join_program_s=program, stack_ms=stack_ms,
                        stack_bytes=stack_bytes)


# ---------------------------------------------------------------------------
# the one-shot sharded pipeline: ExecutionPlan(n_shards=n, devices=(card,) * n)
class _ShardOutputs:
    """Records the per-shard outputs of the sharded program's last run in
    an engine (what the sharded stage gets back from its runner)."""

    def __enter__(self):
        from repro_torch.api import engine

        self.stage = engine._ShardedEncodeJoinScoreStage
        self.real = self.stage._execute
        self.out = None

        def spy(stage, *args, **kwargs):
            got = self.real(stage, *args, **kwargs)
            self.out = got[0]
            return got

        self.stage._execute = spy
        return self

    def __exit__(self, *exc):
        self.stage._execute = self.real


def _sharded_engine(dev, forest, impl, n, backend="ssh", mode="replicate", oc=1, slack=1.3,
                    **cfg):
    from repro_torch.api import AnotherMeEngine, EngineConfig, ExecutionPlan

    plan = ExecutionPlan(n_shards=n, devices=(dev,) * n, score_mode=mode, overlap_chunks=oc,
                         shard_slack=slack)
    cfg.setdefault("rho", RHO)
    return AnotherMeEngine(forest, EngineConfig(backend=backend, lcs_impl=impl, **cfg),
                           plan, device=dev)


def _run_sharded(engine, batch):
    """Run a sharded engine with the launch counts at 0 just before; returns
    (result, per-shard outputs, launch counts).  Every shard must lie on
    the engine's device type (no shard quietly on the CPU)."""
    with _ShardOutputs() as cap:
        res, counts = _run_counted(engine, batch)
    kinds = {d.type for d in engine.mesh().devices}
    check(kinds == {engine.device.type}, f"shards placed on {kinds}, the engine on {engine.device}")
    return res, cap.out, counts


def _merge_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


# (n_shards, backend, score_mode, overlap_chunks, score_prune, window, lcs_impl, shard_slack,
#  the kernels the card's run must launch)
SHARDED_SMALL = (
    (2, "ssh", "replicate", 1, False, None, "fused", 1.3, ["fused_gather_score"]),
    (4, "ssh", "shuffle", 4, True, None, "fused", 1.3, ["fused_gather_score"]),
    (8, "ssh", "shuffle", 1, False, None, "kernel", 1.3, ["lcs_kernel"]),
    (4, "ssh", "replicate", 1, True, None, "kernel", 1.3, ["lcs_kernel"]),
    (4, "minhash", "replicate", 1, False, None, "fused", 1.3,
     ["minhash_kernel", "fused_gather_score"]),
    (8, "minhash", "shuffle", 4, True, None, "fused", 1.3, ["minhash_kernel", "fused_gather_score"]),
    (4, "brp", "shuffle", 1, False, None, "fused", 1.3, ["fused_gather_score"]),
    (4, "udf", "replicate", 1, False, None, "fused", 1.3, ["fused_gather_score"]),
    (4, "ssh", "replicate", 1, False, SUB_WINDOW, "fused", 1.3, ["fused_windowed_gather_score"]),
    (8, "ssh", "shuffle", 4, True, SUB_WINDOW, "fused", 1.3, ["fused_windowed_gather_score"]),
    (2, "ssh", "replicate", 1, False, SUB_WINDOW, "kernel", 1.3, ["lcs_kernel"]),
    (4, "ssh", "replicate", 1, False, None, "fused", 0.2, ["fused_gather_score"]),  # retries
)


def phase_sharded_small(torch, dev, n=SMALL_N, sub_n=SUB_SMALL_N):
    """Sharded plans with every shard on the card: Fig. 1 at two shards, and
    a 3,000-trajectory world (a 2,000-trajectory one of 10-20 places for
    windows of 8) at 2, 4 and 8 shards, every backend, both score modes,
    the prune, chunks, "fused" and "kernel", and shrunken capacities that
    retry.  Each card run's per-shard outputs are bit-equal to the same
    plan on CPU shards (plain versions); its similar pairs and communities
    equal the card's one-shard engine's."""
    from repro_torch.data import fig1_world, synthetic_setup

    batch, forest = fig1_world(device=dev)
    one = _engine(dev, forest, "fused", rho=3.0).run(batch)
    res, _, counts = _run_sharded(_sharded_engine(dev, forest, "fused", 2, rho=3.0), batch)
    expect_launched(counts, ["fused_gather_score"])
    check((0, 1) in res.similar_pairs and res.communities == one.communities,
          "sharded fig1: Carol should find her other me on two shards")
    total = dict(counts)
    worlds = {}
    for dev_ in ("cpu", dev):
        worlds[str(dev_), False] = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev_)
        worlds[str(dev_), True] = synthetic_setup(sub_n, num_types=NUM_TYPES, seed=0,
                                                  device=dev_, **SUB_ROWS)
    one_shard = {}
    for shards, backend, mode, oc, prune, window, impl, slack, kernels in SHARDED_SMALL:
        tag = (f"sharded small n_shards={shards} {backend} {mode} overlap_chunks={oc} "
               f"prune={prune} W={window} {impl} slack={slack}")
        # with the prune on, a rho the bound min(len) can miss (rows hold
        # at least 5 places, so rho = 2 would prune nothing)
        rho = PRUNE_RHO if prune else RHO
        cfg = dict(backend=backend, mode=mode, oc=oc, slack=slack, score_prune=prune, rho=rho,
                   subtraj_window=window, community_mode="components")
        batch, forest = worlds[str(dev), window is not None]
        eng = _sharded_engine(dev, forest, impl, shards, **cfg)
        res, out, counts = _run_sharded(eng, batch)
        expect_launched(counts, kernels)
        _merge_counts(total, counts)
        cpu_batch, _ = worlds["cpu", window is not None]
        want, want_out, _ = _run_sharded(_sharded_engine("cpu", forest, impl, shards, **cfg),
                                         cpu_batch)
        for field, v in want_out.items():
            check(torch.equal(out[field].cpu(), v), f"{tag}: per-shard {field} != CPU shards")
        check(res.stats["join_overflow"] == 0 and res.stats["shard_plan"] == want.stats["shard_plan"],
              f"{tag}: plan or overflow differs from the CPU's")
        key = (backend, prune, window)
        if key not in one_shard:
            one_shard[key] = _engine(dev, forest, "fused", backend=backend, rho=rho,
                                     score_prune=prune, subtraj_window=window,
                                     community_mode="components").run(batch)
        ref = one_shard[key]
        check(res.similar_pairs == ref.similar_pairs and res.communities == ref.communities,
              f"{tag}: similar pairs or communities != the one-shard engine's")
        # the order-blind baselines find few similar pairs at 300 types
        check(res.stats["num_candidates"] > 0
              and (len(ref.similar_pairs) > 0 or backend in ("minhash", "brp") or prune),
              f"{tag}: no candidates or no similar pairs")
        check(not prune or res.stats["num_pruned"] > 0, f"{tag}: the prune dropped nothing")
        if slack < 1:
            check(eng.last_shard_retries > 0, f"{tag}: shrunken capacities did not retry")
        log(f"{tag}: == CPU shards and the one-shard engine ({res.stats['num_candidates']} "
            f"candidates, {len(res.similar_pairs)} similar, retries {eng.last_shard_retries}, "
            f"launches { {k: v for k, v in counts.items() if v} })")
    return total


SHARD_PHASE_KEYS = ("t_keys", "t_plan", "t_execute", "t_communities", "t_total")


def _sharded_line(torch, dev, tag, engine, res, counts, wall):
    s = res.stats
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    keys = [k for k in SHARD_PHASE_KEYS + ("t_aggregate",) if k in s]
    fig = {"phases_s": {k: s[k] for k in keys}, "shard_plan": s["shard_plan"],
           "retries": engine.last_shard_retries, "wall_s": wall, "peak_gib": peak,
           "num_candidates": s["num_candidates"], "num_similar": s["num_similar"],
           "num_communities": s["num_communities"],
           "launches": {k: v for k, v in counts.items() if v}}
    for k in ("num_pruned", "num_traj_pairs", "num_window_pairs"):
        if k in s:
            fig[k] = s[k]
    log(f"{tag}: " + " ".join(f"{k}={s[k]:.3f}s" for k in keys))
    log(f"{tag}: run wall {wall:.3f}s, peak device memory {peak:.2f} GiB, retries "
        f"{engine.last_shard_retries}, plan {s['shard_plan']}, launches {fig['launches']}")
    return fig


def _scored_set_on_card(torch, sc):
    """(pairs packed as lo << 32 | hi, level_lcs, mss) of a scored buffer's
    valid slots, sorted by pair, on the card."""
    from repro_torch.core.types import PAD_ID

    valid = sc.left != PAD_ID
    packed = (sc.left[valid].long() << 32) | sc.right[valid].long()
    packed, order = torch.sort(packed)
    return packed, sc.level_lcs[valid][order], sc.mss[valid][order]


def _same_scored_set(torch, got, want, tag):
    g, w = _scored_set_on_card(torch, got), _scored_set_on_card(torch, want)
    for name, a, b in zip(("pairs", "level_lcs", "mss"), g, w):
        check(a.shape == b.shape and torch.equal(a, b), f"{tag}: scored {name} set differs")
    return int(g[0].shape[0])


def _timed_sharded(torch, dev, engine, batch):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, counts = _run_counted(engine, batch)
    return res, counts, time.perf_counter() - t0


def phase_sharded(torch, dev, main_res, n=MAIN_N, shards=SHARDS):
    """fig13's world at 1,000,000 trajectories on four shards of the card,
    replicate, "fused" (#1 once a shard), components: the similar pairs and
    the scored (pair, level_lcs, mss) set equal the one-shard main run's."""
    from repro_torch.data import synthetic_setup
    from repro_torch.kernels.lcs import fused

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    engine = _sharded_engine(dev, forest, "fused", shards, community_mode="components")
    res, counts, wall = _timed_sharded(torch, dev, engine, batch)
    routes = dict(fused.fused_gather_score.launches_by_route)
    launches = shards * (engine.last_shard_retries + 1)  # one a shard a run
    check(counts["fused_gather_score"] == launches
          and routes == {"registers": launches, "shared": 0},
          f"sharded: #1 launched {counts['fused_gather_score']} times on routes {routes}")
    fig = _sharded_line(torch, dev, f"sharded N={n} n_shards={shards} replicate fused", engine,
                        res, counts, wall)
    check(res.stats["join_overflow"] == 0, "sharded: overflow")
    check(bool(torch.isfinite(res.scored.mss).all()), "sharded: non-finite mss")
    check(res.similar_pairs == main_res.similar_pairs, "sharded: similar pairs != one shard's")
    scored = _same_scored_set(torch, res.scored, main_res.scored, "sharded")
    log(f"sharded: {len(res.similar_pairs)} similar pairs and the scored set of {scored} "
        f"(pair, level_lcs, mss) equal the one-shard run's; {len(res.communities)} components")
    return counts, fig


def phase_sharded_shuffle(torch, dev, n=KERNEL_N, shards=SHARDS, chunks=4):
    """Shuffle mode with the prune and four chunks on four shards of the card
    against the one-shard engine with the prune: similar pairs,
    communities and the scored set."""
    from repro_torch.data import synthetic_setup

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev)
    engine = _sharded_engine(dev, forest, "fused", shards, mode="shuffle", oc=chunks,
                             score_prune=True, rho=PRUNE_RHO, community_mode="components")
    res, counts, wall = _timed_sharded(torch, dev, engine, batch)
    # past the exact-pair limit the plan takes the uniform bound, and a
    # chunk's resting buffer can overflow (owner(right) leans to the last
    # shards): a retry doubles every capacity and scores again
    runs = engine.last_shard_retries + 1
    check(counts["fused_gather_score"] == shards * chunks * runs,
          f"sharded shuffle: #1 launched {counts['fused_gather_score']} times in {runs} runs")
    fig = _sharded_line(torch, dev, f"sharded shuffle N={n} n_shards={shards} "
                        f"overlap_chunks={chunks} prune fused", engine, res, counts, wall)
    want = _engine(dev, forest, "fused", rho=PRUNE_RHO, score_prune=True,
                   community_mode="components").run(batch)
    check(res.stats["join_overflow"] == 0, "sharded shuffle: overflow")
    check(res.stats["num_pruned"] > 0, "sharded shuffle: the prune dropped nothing")
    check(res.stats["num_pruned"] == want.stats["num_pruned"], "sharded shuffle: pruned count")
    check(res.similar_pairs == want.similar_pairs and res.communities == want.communities,
          "sharded shuffle: similar pairs or communities != one shard's")
    scored = _same_scored_set(torch, res.scored, want.scored, "sharded shuffle")
    log(f"sharded shuffle: == the one-shard engine with the prune ({scored} scored pairs, "
        f"{res.stats['num_pruned']} pruned, {len(res.similar_pairs)} similar)")
    return counts, fig


def phase_sharded_subtraj(torch, dev, sub_res, n=SUB_N, shards=SHARDS):
    """The subtrajectory mode (W = 8) at 100,000 trajectories on four shards
    of the card, replicate, "fused" (#3 once a shard), against the one-shard
    subtrajectory run: the folded scored buffer, similar pairs and
    communities."""
    from repro_torch.data import synthetic_setup
    from repro_torch.kernels.lcs import fused

    batch, forest = synthetic_setup(n, num_types=NUM_TYPES, seed=0, device=dev, **SUB_ROWS)
    engine = _sharded_engine(dev, forest, "fused", shards, subtraj_window=SUB_WINDOW,
                             community_mode="components")
    res, counts, wall = _timed_sharded(torch, dev, engine, batch)
    routes = dict(fused.fused_windowed_gather_score.launches_by_route)
    launches = shards * (engine.last_shard_retries + 1)  # one a shard a run
    check(counts["fused_windowed_gather_score"] == launches
          and routes == {"registers": launches, "shared": 0},
          f"sharded subtraj: #3 launched on routes {routes}")
    fig = _sharded_line(torch, dev, f"sharded subtraj N={n} W={SUB_WINDOW} n_shards={shards}",
                        engine, res, counts, wall)
    check(res.stats["join_overflow"] == 0, "sharded subtraj: overflow")
    check(res.stats["num_window_pairs"] == sub_res.stats["num_window_pairs"],
          "sharded subtraj: window pair count differs")
    for field in ("left", "right", "level_lcs", "mss"):
        check(torch.equal(getattr(res.scored, field), getattr(sub_res.scored, field)),
              f"sharded subtraj: folded {field} != the one-shard run's")
    check(res.similar_pairs == sub_res.similar_pairs and res.communities == sub_res.communities,
          "sharded subtraj: similar pairs or communities != one shard's")
    log(f"sharded subtraj: == the one-shard run ({res.stats['num_traj_pairs']} trajectory pairs "
        f"from {res.stats['num_window_pairs']} window pairs, {len(res.similar_pairs)} similar)")
    return counts, fig



# ---------------------------------------------------------------------------
# tuning, autotune=True, the GeoLife world, SSH corpus dedup, the examples
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _tuning_table_at(path):
    """Point the port's tuning table at ``path`` (a scratch file, never the
    repo's) for the duration of the block."""
    import os

    old = os.environ.get("REPRO_TORCH_TUNING_PATH")
    os.environ["REPRO_TORCH_TUNING_PATH"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_TUNING_PATH")
        else:
            os.environ["REPRO_TORCH_TUNING_PATH"] = old


def phase_tune(torch, dev, scratch):
    """The sweep (``repro_torch.perf.tune``) on the card: its smoke grid
    plus one shared-route cell, into a scratch table; every candidate
    bit-identical, the table's header the card's, a CPU table empty here."""
    import json as _json

    from repro_torch.core.encoding import PAD_CODE_A, PAD_CODE_B
    from repro_torch.core.similarity import repad
    from repro_torch.kernels.lcs import kernel, ops
    from repro_torch.perf import LCSTuning, TuningTable, tune

    path = scratch / "TUNING_torch.json"
    grid = tune.SMOKE_GRID + (TUNE_SHARED_CELL,)
    (path_out, cells), counts = _counted(
        lambda: tune.tune(grid=grid, device=dev, out_path=path, repeats=5))
    routes = dict(kernel.lcs_kernel.launches_by_route)
    expect_launched(counts, ["lcs_kernel"])
    check(routes["registers"] > 0 and routes["shared"] > 0,
          f"tune: the LCS kernel launched on routes {routes}")
    kinds, sweep = {}, []
    for c in cells:
        # tune held its untuned reference against lcs_plain and every
        # candidate against that reference; hold the winner's launch
        # against the plain version here too, at the cell's own operands
        codes, lengths, left, right, _ = tune.make_inputs(c.P, c.H, c.L, device=dev)
        a = repad(codes[left], lengths[left], PAD_CODE_A).reshape(c.P * c.H, c.L)
        b = repad(codes[right], lengths[right], PAD_CODE_B).reshape(c.P * c.H, c.L)
        dt = torch.int8 if c.winner.wavefront_dtype == "int8" else torch.int32
        got = ops.lcs(a, b, block_b=c.winner.block_b, wavefront_dtype=dt)
        check(torch.equal(got, kernel.lcs_plain(a, b)),
              f"tune: the winner at P={c.P} H={c.H} L={c.L} != lcs_plain")
        for t in c.trials:  # tune raises on a candidate that is not bit-identical
            log(f"tune: P={c.P} H={c.H} L={c.L} block_b={t.block_b} dtype={t.wavefront_dtype} "
                f"launched block={t.block} {t.ms:.4f} ms bit-identical")
        log(f"tune: P={c.P} H={c.H} L={c.L} winner block_b={c.winner.block_b} "
            f"dtype={c.winner.wavefront_dtype} {c.winner.pairs_per_sec:.0f} pairs/s; "
            f"the winner's launch == lcs_plain on the cell's {c.P * c.H} rows")
        kinds[(c.P, c.L)] = sorted({t.block_b for t in c.trials})
        sweep.append(dict(P=c.P, H=c.H, L=c.L, route=kernel.route(c.L),
                          winner=[c.winner.block_b, c.winner.wavefront_dtype],
                          trials=[[t.block_b, t.wavefront_dtype, t.block, t.ms]
                                  for t in c.trials]))
    card = torch.cuda.get_device_name(dev)
    raw = _json.loads(path_out.read_text())
    check(raw["device_kind"] == card and raw["torch_version"] == torch.__version__,
          f"tune: table header {raw['device_kind']!r} {raw['torch_version']!r}")
    table = TuningTable.load(path_out, device=dev)
    check(len(table.entries) == len(grid) and all(
        table.lookup(c.P, c.H, c.L) == c.winner for c in cells), "tune: table does not load back")
    cpu = TuningTable(device="cpu")
    cpu.record(1024, 3, 16, LCSTuning(128, "int32"))
    cpu_path = cpu.save(scratch / "cpu.json")
    check(TuningTable.load(cpu_path, device=dev).entries == {},
          "tune: a CPU-headed table loaded on the card")
    log(f"tune: {len(cells)} cells, block caps swept {kinds}, table header {card!r} loads back, "
        f"a CPU table loads empty; lcs_kernel launches_by_route {routes}")
    log(json.dumps({"tune": sweep}))
    return counts


def _nonzero(counts):
    return {name: c for name, c in counts.items() if c}


def _tuned_equals_untuned(make_engine, batch, what):
    """``make_engine(autotune)`` builds an engine; its tuned run (counted)
    must equal its untuned run.  Returns (tuned result, tuned engine, the
    tuned run's launch counts)."""
    want = make_engine(False).run(batch)
    engine = make_engine(True)
    got, counts = _run_counted(engine, batch)
    _same_result(got, want, what)
    return got, engine, counts


def phase_autotune(torch, dev, scratch, n=AUTOTUNE_N, n_updates=4, slice_pairs=1 << 20):
    """``autotune=True`` on every engine path, on the GeoLife world, against
    the untuned run, with a table holding a record for the one-shot run's
    exact (P, H, L): one shard ("kernel" and "fused"), four shards of the
    card (replicate and shuffle), a host-join and a device-join stream.
    Scored buffers slot for slot, similar pairs and communities equal; a
    slice of the one-shard and the replicate "kernel" buffers re-scored by
    the plain version."""
    from repro_torch.api import AnotherMeEngine, EngineConfig, ExecutionPlan
    from repro_torch.data import geolife_surrogate
    from repro_torch.kernels.lcs import kernel
    from repro_torch.perf import LCSTuning, TuningTable

    batch, forest = geolife_surrogate(num_users=GEOLIFE_USERS, num_traj=n, seed=0, device=dev)
    H, L = forest.num_levels, int(batch.places.shape[1])
    cfg = dict(rho=GEOLIFE_RHO, community_mode="components")
    probe = _engine(dev, forest, "kernel", **cfg).run(batch)
    P = probe.stats["pair_capacity"]
    # a record unlike the defaults (block cap 128, int32 diagonals); on the
    # card neither changes what runs at this width
    record = LCSTuning(block_b=128, wavefront_dtype="int32")
    table = TuningTable(device=dev)
    table.record(P, H, L, record)
    path = table.save(scratch / "TUNING_autotune.json")
    counts = collections.Counter()
    with _tuning_table_at(path):
        for impl in ("kernel", "fused"):
            def one_shot(autotune, impl=impl):
                return AnotherMeEngine(forest, EngineConfig(lcs_impl=impl, **cfg),
                                       ExecutionPlan(autotune=autotune), device=dev)

            res, eng, c = _tuned_equals_untuned(one_shot, batch, f"autotune one-shot {impl}")
            routes = dict(kernel.lcs_kernel.launches_by_route)
            counts.update(c)
            if impl == "kernel":  # #2 at L = 16 (register route) against the plain version
                _rescore_slice(torch, eng, batch, res, slice_pairs,
                               f"autotune one-shot kernel N={n}", rho=GEOLIFE_RHO)
            got = eng.planner.plan_tuning(P, H, L, device=dev)
            check(got == record, f"autotune: plan_tuning({P}, {H}, {L}) = {got}, not the record")
            log(f"autotune: one-shot {impl} N={n} P={P} H={H} L={L}: tuned == untuned "
                f"({res.stats['num_candidates']} candidates, {len(res.similar_pairs)} similar), "
                f"plan_tuning -> {got}, launches {_nonzero(c)}, lcs_kernel launches_by_route "
                f"{routes}")
        for mode in ("replicate", "shuffle"):
            def sharded(autotune, mode=mode):
                return AnotherMeEngine(
                    forest, EngineConfig(lcs_impl="kernel", **cfg),
                    ExecutionPlan(n_shards=SHARDS, devices=(dev,) * SHARDS, score_mode=mode,
                                  autotune=autotune), device=dev)

            res, eng, c = _tuned_equals_untuned(sharded, batch, f"autotune {SHARDS} shards {mode}")
            counts.update(c)
            if mode == "replicate":  # each shard's #2 launches against the plain version
                _rescore_slice(torch, eng, batch, res, slice_pairs,
                               f"autotune {SHARDS} shards {mode} N={n}", rho=GEOLIFE_RHO,
                               pads_masked=True)
            check(any(record in key for key in eng._runner_cache),
                  f"autotune {mode}: the sharded runner was built without the record")
            check(res.similar_pairs == probe.similar_pairs and res.communities == probe.communities,
                  f"autotune {mode}: sharded result != one shard's")
            log(f"autotune: {SHARDS} shards {mode} kernel: tuned == untuned == one shard "
                f"({len(res.similar_pairs)} similar), launches {_nonzero(c)}")
        for delta_join in ("host", "device"):
            untuned, tuned = (_stream(dev, forest, "kernel", delta_join=delta_join,
                                      rho=GEOLIFE_RHO, autotune=a) for a in (False, True))
            for u, mb in enumerate(_micro_batches(batch, n_updates)):
                want = untuned.update(mb)
                got, c = _counted(lambda: tuned.update(mb))
                counts.update(c)
                _same_stream_result(got, want, f"autotune stream {delta_join} update {u}")
                check(got.stats["runner_builds"] == want.stats["runner_builds"]
                      and got.stats["score_traces"] == want.stats["score_traces"],
                      f"autotune stream {delta_join} update {u}: build counts differ")
            if delta_join == "device":
                check(any(record in key for key in tuned._runner_cache),
                      "autotune: the device-join score runner was built without the record")
            log(f"autotune: {n_updates}-update {delta_join}-join stream of {n} rows: every "
                f"update tuned == untuned ({len(got.similar_pairs)} similar, runner_builds "
                f"{got.stats['runner_builds']})")
    expect_launched(counts, ["lcs_kernel", "fused_gather_score"])
    return dict(counts)


def phase_geolife(torch, dev, slice_pairs=1 << 20):
    """The GeoLife surrogate at the paper's full scale (fig11/12), "fused"
    (#1), components; then fig11's quick grid with "ssh" and "minhash" (#5)
    against the port's CPU run and the centralized truth."""
    from repro_torch.core import centralized_similar_pairs, encode_batch, forest_tables
    from repro_torch.core import maximal_cliques, qa1, qa2
    from repro_torch.data import geolife_surrogate

    t0 = time.perf_counter()
    batch, forest = geolife_surrogate(num_users=GEOLIFE_USERS, num_traj=GEOLIFE_N, seed=0,
                                      device=dev)
    gen_s = time.perf_counter() - t0
    log(f"geolife: surrogate {list(batch.places.shape)} generated in {gen_s:.3f}s (host numpy)")
    engine = _engine(dev, forest, "fused", rho=GEOLIFE_RHO, community_mode="components")
    tag = f"geolife N={GEOLIFE_N}"
    res, c = _scale_run(torch, dev, engine, batch, tag, ["fused_gather_score"])
    counts = collections.Counter(c)
    _rescore_slice(torch, engine, batch, res, slice_pairs, tag, rho=GEOLIFE_RHO)
    figures = dict(generate_s=gen_s, **{k: v for k, v in res.stats.items() if k.startswith("t_")},
                   pair_capacity=res.stats["pair_capacity"],
                   num_candidates=res.stats["num_candidates"], num_similar=len(res.similar_pairs),
                   num_communities=len(res.communities),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    del res, engine
    torch.cuda.empty_cache()

    quick, qforest = geolife_surrogate(num_users=60, num_traj=1_200, seed=0, device=dev)
    cpu_quick, _ = geolife_surrogate(num_users=60, num_traj=1_200, seed=0, device="cpu")
    cl, cr, _ = centralized_similar_pairs(
        encode_batch(quick, forest_tables(qforest, device=dev)), rho=GEOLIFE_RHO)
    cen_pairs = {(int(a), int(b)) for a, b in zip(cl.tolist(), cr.tolist())}
    cen_comms = maximal_cliques(cen_pairs)
    qa = {}
    for backend in ("ssh", "minhash"):
        res, c = _run_counted(_engine(dev, qforest, "fused", backend, rho=GEOLIFE_RHO), quick)
        expect_launched(c, ["fused_gather_score"] + (["minhash_kernel"] if backend == "minhash"
                                                      else []))
        counts.update(c)
        cpu = _engine("cpu", qforest, "fused", backend, rho=GEOLIFE_RHO).run(cpu_quick)
        _same_result(res, cpu, f"fig11 {backend}")
        qa[backend] = (qa1(res.communities, cen_comms), qa2(res.similar_pairs, cen_pairs))
        if backend == "ssh":
            check(qa[backend] == (1.0, 1.0), f"fig11: ssh QA1/QA2 {qa[backend]} != 1.000")
        log(f"geolife: fig11 quick (60 users, 1,200) {backend}: card == CPU, QA1={qa[backend][0]:.3f} "
            f"QA2={qa[backend][1]:.3f} ({res.stats['num_candidates']} candidates, "
            f"{len(res.similar_pairs)} similar; centralized {len(cen_pairs)})")
    figures["fig11_qa"] = qa
    log(json.dumps({"geolife": figures}))
    return dict(counts), figures


def phase_dedup(torch, dev, n=DEDUP_N):
    """``ssh_dedup`` over a planted-duplicate corpus with granite-3-8b's
    vocabulary, on the card against the CPU; ``TokenDataset`` batches on
    the card against the CPU's.  The JAX reference scores with the jnp
    wavefront here, so no kernel runs."""
    import numpy as np

    from repro_torch.data.tokens import TokenDataset, ssh_dedup, synthetic_corpus

    t0 = time.perf_counter()
    corpus, dup_source = synthetic_corpus(n, DEDUP_SEQ, GRANITE_VOCAB, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (keep, stats), counts = _counted(lambda: ssh_dedup(corpus, vocab_size=GRANITE_VOCAB,
                                                       device=dev))
    card_s = time.perf_counter() - t0
    check(not any(counts.values()), f"dedup: a kernel launched on the wavefront path: {counts}")
    t0 = time.perf_counter()
    cpu_keep, cpu_stats = ssh_dedup(corpus, vocab_size=GRANITE_VOCAB, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(keep, cpu_keep) and stats == cpu_stats,
          f"dedup: card {stats} != CPU {cpu_stats}")
    planted = dup_source >= 0
    recall = float((~keep[planted]).mean())
    check(stats.num_dropped > 0 and recall > 0.5, f"dedup: recall {recall}")
    log(f"dedup: {n} docs x {DEDUP_SEQ} tokens (vocab {GRANITE_VOCAB}): {stats}; card == CPU; "
        f"planted-duplicate recall {recall:.4f}; card {card_s:.3f}s, CPU {cpu_s:.3f}s, "
        f"corpus {gen_s:.3f}s")
    kept = corpus[keep]
    for step in (0, 7):
        whole = TokenDataset(kept, global_batch=8, seed=0, device=dev).batch(step)
        cpu = TokenDataset(kept, global_batch=8, seed=0, device="cpu").batch(step)
        shards = [TokenDataset(kept, global_batch=8, n_shards=2, shard=s, seed=0,
                               device=dev).batch(step) for s in (0, 1)]
        for key in ("tokens", "labels"):
            check(whole[key].device == dev and whole[key].dtype == torch.int32
                  and torch.equal(whole[key].cpu(), cpu[key]), f"dedup: {key} batch != CPU")
            check(torch.equal(torch.cat([s[key] for s in shards]), whole[key]),
                  f"dedup: 2 shards' {key} != the whole batch")
    log("dedup: TokenDataset batches on the card == CPU, 2 shards concatenated == 1")
    return dict(card_s=card_s, cpu_s=cpu_s, recall=recall, stats=dataclasses.asdict(stats))


def phase_examples(dev):
    """Both torch examples on the card; their last lines checked."""
    import contextlib as _ctx
    import importlib.util
    import io

    lasts = {"torch_quickstart": "QA1 = 1.000  QA2 = 1.000  (paper: 1.000)",
             "torch_find_another_me": "Carol found another her across the world ✓"}
    for name, last in lasts.items():
        spec = importlib.util.spec_from_file_location(name, HERE / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out = io.StringIO()
        with _ctx.redirect_stdout(out):
            module.main(device=dev)
        lines = out.getvalue().splitlines()
        check(lines and lines[-1] == last, f"examples: {name} ended {lines[-1:]!r}")
        log(f"examples: {name} on the card: {lines[-1]}")


# ---------------------------------------------------------------------------
# LM serving: flash attention (#6) and the SSD intra-chunk step (#7)
# ---------------------------------------------------------------------------
def _max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _ssd_operands(torch, dev, BC, Q, H, P, N, dtype, rng):
    """Intra-chunk operands with the model's ranges: dt in U(1e-3, 1e-1),
    A = -U(1, 16) (init_params' A_log), x, B, C standard normal."""
    import numpy as np

    dt = rng.uniform(1e-3, 1e-1, size=(BC, Q, H)).astype(np.float32)
    cum = np.cumsum(dt * -rng.uniform(1.0, 16.0, size=H).astype(np.float32), axis=1)
    x, B_, C_ = (rng.normal(size=sh).astype(np.float32) for sh in ((BC, Q, H, P), (BC, Q, N), (BC, Q, N)))

    def on(a, t=torch.float32):
        return torch.as_tensor(a, device=dev).to(t)

    return on(x, dtype), on(cum), on(dt), on(B_, dtype), on(C_, dtype)


def phase_lm_kernels(torch, dev):
    """Kernels #6 and #7 against their plain versions on the card at edge
    shapes: float32 within 1e-4, bfloat16 attention within 3e-2 on both of
    #6's routes (the wrapper's wgmma route, at every head dim here, then the
    CUDA-core kernel run by name on the same operands); #7 within 1e-4 on
    both of its routes
    (5e-2 under ``bf16_intra``), alone and in the chunked scan."""
    import numpy as np

    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    rng = np.random.default_rng(0)
    fk = attn.flash_attention_kernel
    worst, n = {}, 0
    for S in (1, 65, 1000):
        for D in (64, 80, 96, 112, 128, 144, 192, 256):
            for rep in (1, 4):
                base = [torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)
                        for sh in ((2, S, 2 * rep, D), (2, S, 2, D), (2, S, 2, D))]
                for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
                    q, k, v = (t.to(dtype) for t in base)
                    path = attn.route(dtype, D)
                    for causal in (True, False):
                        want = attn.flash_attention_plain(q, k, v, causal=causal)
                        before = fk.launches_by_route[path]
                        got = {path: fk(q, k, v, causal=causal)}
                        check(fk.launches_by_route[path] == before + 1,
                              f"flash attention {dtype} D={D}: not launched on the {path} route")
                        if path == "wgmma":
                            got["cuda_cores"] = attn.launch("cuda_cores", q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        for route, out in got.items():
                            err = _max_err(out, want)
                            what = f"flash attention [{route}] S={S} D={D} rep={rep} {dtype} causal={causal}"
                            check(out.dtype == dtype and out.shape == q.shape,
                                  f"{what}: {out.dtype} {tuple(out.shape)}")
                            check(err <= tol, f"{what}: max |kernel - plain| {err} > {tol}")
                            key = (route, str(dtype).removeprefix("torch."))
                            worst[key] = max(worst.get(key, 0.0), err)
                            n += 1
    log(f"flash_attention_kernel: {n} edge cases (S 1/65/1000, D 64/80/96/112/128/144/192/256, rep "
        f"1/4, causal and not; bfloat16 on both routes) within tolerance; worst "
        + ", ".join(f"{r} {d} {e:.3g}" for (r, d), e in sorted(worst.items())))
    si = ssd.ssd_intra
    worst, n = {}, 0

    def hold(what, got, want, tol=1e-4):
        torch.cuda.synchronize()
        errs = [_max_err(g, w) for g, w in zip(got, want)]
        check(all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got, want)),
              f"{what}: outputs {[(g.dtype, tuple(g.shape)) for g in got]}")
        check(max(errs) <= tol, f"{what}: max |kernel - plain| (y, state, cdecay) {errs} > {tol}")
        return max(errs)

    def both_routes(ops, what):
        """The wrapper (its route counted) and the other route by name."""
        nonlocal n
        x, _, _, B_, _ = ops
        path = ssd.route(x.dtype, x.shape[1], x.shape[3], B_.shape[2])
        want = ssd.ssd_intra_plain(*ops)
        before = si.launches_by_route[path]
        got = {path: si(*ops)}
        check(si.launches_by_route[path] == before + 1, f"ssd_intra {what}: not launched on the {path} route")
        if path == "wgmma":
            got["cuda_cores"] = ssd.launch("cuda_cores", *ops)
        for r, out in got.items():
            key = (r, str(x.dtype).removeprefix("torch."))
            worst[key] = max(worst.get(key, 0.0), hold(f"ssd_intra [{r}] {what}", out, want))
            n += 1

    # the tensor-core route's edges: ragged chunks, one and two 64-column
    # tiles of N and P, 13 heads (no block size divides them)
    for Q in (1, 16, 65, 128):
        for N in (64, 128):
            for P in (64, 128):
                both_routes(_ssd_operands(torch, dev, 3, Q, 13, P, N, torch.bfloat16, rng),
                            f"Q={Q} N={N} P={P} H=13 bfloat16")
    for N in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            both_routes(_ssd_operands(torch, dev, 8, 128, 16, 64, N, dtype, rng),
                        f"Q=128 N={N} P=64 H=16 {dtype}")
    log(f"ssd_intra: {n} edge cases (Q 1/16/65/128, N and P 64/128, 13 heads; Q 128 with 16 heads in "
        "float32 and bfloat16; bfloat16 on both routes) within 1e-4 of the plain version; worst "
        + ", ".join(f"{r} {d} {e:.3g}" for (r, d), e in sorted(worst.items())))
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((8, 128, 16, 64, 64), (3, 65, 9, 128, 128)):
            ops = _ssd_operands(torch, dev, *shape, dtype, rng)
            before = si.launches_by_route["wgmma"]
            got = si(*ops, bf16_intra=True)
            check(si.launches_by_route["wgmma"] == before + 1, "ssd_intra bf16_intra: not on the wgmma route")
            err = hold(f"ssd_intra bf16_intra {shape} {dtype}", got,
                       ssd.ssd_intra_plain(*ops, bf16_intra=True), 5e-2)
            log(f"ssd_intra bf16_intra (BC, Q, H, P, N) {shape} {dtype}: wgmma route within 5e-2 of the "
                f"plain version ({err:.3g})")

    B, S, H, P, N = 2, 512, 16, 64, 64
    x, Bm, Cm = (torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)
                 for sh in ((B, S, H, P), (B, S, 1, N), (B, S, 1, N)))
    dt = torch.as_tensor(rng.uniform(1e-3, 1e-1, size=(B, S, H)).astype(np.float32), device=dev)
    A = -torch.as_tensor(rng.uniform(1.0, 16.0, size=H).astype(np.float32), device=dev)
    D = torch.as_tensor(rng.normal(size=H).astype(np.float32), device=dev)
    si.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
    y, st = ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    check(si.launches_by_route == {"wgmma": 0, "cuda_cores": 1}, f"float32 scan routes {si.launches_by_route}")
    ry, rst = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    errs = [_max_err(y, ry), _max_err(st, rst)]
    check(max(errs) <= 1e-4, f"ssd_chunked S={S} (4 chunks): max |op - ref| (y, state) {errs} > 1e-4")
    log(f"ssd_chunked S={S}, 4 chunks, float32 (CUDA-core route): y and final state within 1e-4 of "
        f"the plain scan ({max(errs):.3g})")
    # the wgmma route in the scan: bfloat16-valued float32 operands, the
    # intra-chunk step given them in bfloat16, so that y stays float32
    x, Bm, Cm = (t.to(torch.bfloat16).float() for t in (x, Bm, Cm))

    def intra16(x_, cum_, dt_, B_, C_, *, bf16_intra):
        return si(x_.to(torch.bfloat16), cum_, dt_, B_.to(torch.bfloat16), C_.to(torch.bfloat16),
                  bf16_intra=bf16_intra)

    y, st = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=128, bf16_intra=False, intra=intra16)
    check(si.launches_by_route == {"wgmma": 1, "cuda_cores": 1}, f"bf16 scan routes {si.launches_by_route}")
    ry, rst = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    errs = [_max_err(y, ry), _max_err(st, rst)]
    check(max(errs) <= 1e-4, f"ssd_scan S={S} on the wgmma route: max |op - ref| (y, state) {errs} > 1e-4")
    log(f"ssd_scan S={S}, 4 chunks, bfloat16 operands (wgmma route): y and final state within 1e-4 of "
        f"the plain scan ({max(errs):.3g})")
    y, st = ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128, bf16_intra=True)
    check(si.launches_by_route == {"wgmma": 2, "cuda_cores": 1}, f"bf16_intra scan routes {si.launches_by_route}")
    ry, rst = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128, bf16_intra=True)
    errs = [_max_err(y, ry), _max_err(st, rst)]
    check(max(errs) <= 5e-2, f"ssd_chunked S={S} bf16_intra: max |op - ref| (y, state) {errs} > 5e-2")
    log(f"ssd_chunked S={S}, 4 chunks, bf16_intra (wgmma route): within 5e-2 of the plain scan "
        f"({max(errs):.3g})")


def _to(tree, where):
    """A parameter tree moved to a device or cast to a dtype."""
    return {k: _to(v, where) if isinstance(v, dict) else v.to(where) for k, v in tree.items()}


def _lm_kernels(cfg):
    return (["flash_attention_kernel"] if cfg.family != "ssm" else []) + \
        (["ssd_intra"] if cfg.family in ("ssm", "hybrid") else [])


def phase_lm_small(torch, dev):
    """Reduced granite-3-8b, mamba2-1.3b, zamba2-2.7b, deepseek-v2-236b,
    kimi-k2-1t-a32b and minicpm3-4b served on the card (prefill of 32
    tokens, two decode steps) against the same run on the CPU (the plain
    versions): logits within 5e-2, every step, whatever the MoE layers
    dropped (logged); then the reduced hubert-xlarge and internvl2-76b
    ``forward`` over ``make_inputs``' frame features and patches, card
    against CPU, within 5e-2."""
    import numpy as np

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.inputs import make_inputs
    from repro_torch.models import moe
    from repro_torch.models.model import forward, init_params
    from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache

    def hold(arch, cfg, got, want, counts, what):
        expect_launched(counts, _lm_kernels(cfg))
        V = cfg.vocab_size
        err = _max_err(got[..., :V], want[..., :V])
        check(err <= LM_LOGITS_ATOL, f"lm small {arch}: card vs CPU logits differ by {err}")
        routes = {k: dict(w.launches_by_route) for k, w in _wrappers().items() if k in _lm_kernels(cfg)}
        log(f"lm small {arch} (reduced): {what} on the card = the CPU run "
            f"(max |logits diff| {err:.3g}), launches { {k: counts[k] for k in _lm_kernels(cfg)} }, "
            f"routes {routes}")

    for arch in ("granite-3-8b", "mamba2-1.3b", "zamba2-2.7b", "deepseek-v2-236b",
                 "kimi-k2-1t-a32b", "minicpm3-4b"):
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 0, "cpu")
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 34)))

        def serve(p, device):
            dropped = []
            with torch.inference_mode():
                t = tokens.to(device)
                moe.reset_dropped()
                lp, cache = prefill_with_cache(p, t[:, :32], cfg, 40)
                dropped.append(moe.dropped_assignments())
                step = make_decode_step(cfg)
                out = [lp]
                for i in (32, 33):
                    moe.reset_dropped()
                    ld, cache = step(p, cache, t[:, i:i + 1])
                    dropped.append(moe.dropped_assignments())
                    out.append(ld)
                return torch.cat(out, dim=1).cpu(), dropped

        want, want_dropped = serve(params, torch.device("cpu"))
        on_card = _to(params, dev)
        (got, dropped), counts = _counted(lambda: serve(on_card, dev))
        extra = f", dropped (prefill, step, step) card {dropped} CPU {want_dropped}" \
            if cfg.family == "moe" else ""
        hold(arch, cfg, got, want, counts, "prefill + 2 decode steps" + extra)

    for arch in ("hubert-xlarge", "internvl2-76b"):
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 0, "cpu")
        inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device="cpu")
        inputs.pop("labels")

        def fwd(p, device):
            with torch.inference_mode():
                return forward(p, {k: v.to(device) for k, v in inputs.items()}, cfg)[0].cpu()

        want = fwd(params, torch.device("cpu"))
        got, counts = _counted(lambda: fwd(_to(params, dev), dev))
        shapes = {k: list(v.shape) for k, v in inputs.items()}
        hold(arch, cfg, got, want, counts, f"forward over {cfg.frontend} inputs {shapes}")


def _profiled_split(torch, fn, tag, top=8):
    """Run ``fn`` under ``torch.profiler`` (``launch/roofline.py::
    profile_device``) and log the host wall, the device's busy and idle
    shares, the device time by kernel kind and the ``top`` kernels by
    device time."""
    from repro_torch.launch.roofline import profile_device

    prof = profile_device(fn, torch.device("cuda"), top=top)
    wall, busy, by = prof["wall_ms"], prof["busy_ms"], prof["device_ms_by_kind"]
    check(busy > 0, f"{tag}: the profiler saw no device time")
    parts = ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    parts += "; top kernels: " + ", ".join(f"{n[:80]} {v:.1f} ms" for n, v in prof["top_kernels"])
    log(f"{tag} (profiled): host wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%): {parts}")


class _Capture:
    """Records the operands of the first call of a kernel wrapper, as the
    op module calls it (the wrapper still counts its launch)."""

    def __init__(self, module, name):
        self.module, self.name, self.args, self.kwargs = module, name, None, None

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            if self.args is None:
                self.args, self.kwargs = args, kwargs
            return real(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class _Routing:
    """Records every MoE routing call (``models/moe.py::route``): each
    token's experts, sorted, and whether it lost an assignment to the
    capacity; one (experts [T, K], lost [T]) pair a call, on the host."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.calls, self.real = [], moe.route

        def spy(x_flat, router_w, cfg, **kw):
            r = self.real(x_flat, router_w, cfg, **kw)
            lost = torch.zeros(x_flat.shape[0], dtype=torch.bool, device=x_flat.device)
            lost[r["order"][~r["kept"]] // cfg.experts_per_token] = True
            self.calls.append((r["experts"].sort(dim=-1).values.cpu(), lost.cpu()))
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.real


def phase_lm_full(torch, dev, arch, expect, routes=None, num_layers=None):
    """One registered model at its full published width (``num_layers``
    cuts the depth), random bfloat16 weights from a seed: 4 prompts of
    2,048 tokens prefilled into a cache of 2,080 positions, then 32 greedy
    tokens.  The prefill must launch the kernels ``expect`` times, each on
    its route in ``routes`` (default ``"wgmma"``); one layer's kernel
    operands are rerun through the plain versions; the prefill logits are
    held against ``forward(last_only)`` over the prompt and (but for MoE)
    ``forward`` over the longer sequence, within 5e-2, and two
    teacher-forced decode steps against a float32 forward: within 5e-2
    more than the bfloat16 forward's own distance from it.  In an MoE
    model a request's decode
    step is held only where it computes the forward's function: where, in
    every layer, it routed the token to the experts the float32 forward
    routed it to and neither dropped one of its assignments.  Capacity 1
    at B = 4 drops colliding assignments, as in the reference, and a
    near-tie between a 6th and 7th expert can fall either way between
    bfloat16 and float32 activations; so the steps are run again at a
    capacity that drops nothing (``capacity_factor = E``) and held the
    same way."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import layers, moe
    from repro_torch.models.model import forward, init_params, padded_vocab, param_count
    from repro_torch.serve.kvcache import cache_bytes
    from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache

    cfg = get_config(arch)
    full_depth = cfg.num_layers
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    is_moe = cfg.family == "moe"
    routes_wanted = {name: (routes or {}).get(name, "wgmma") for name in expect}
    V = cfg.vocab_size
    tag = f"lm {arch} full" + (f" ({cfg.num_layers} of {full_depth} layers)" if num_layers else "")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, V, (LM_BATCH, LM_PROMPT + LM_EXTRA)), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    moe.reset_dropped()
    with torch.inference_mode(), _Capture(attn_ops, "flash_attention_kernel") as fa, \
            _Capture(ssd_ops, "ssd_intra") as si:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, cache), counts = _counted(
            lambda: prefill_with_cache(params, tokens[:, :LM_PROMPT], cfg, LM_MAX_LEN))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    prefill_dropped = moe.dropped_assignments()
    got = {k: counts[k] for k in expect}
    check(got == expect, f"{tag}: prefill launches {got}, expected {expect}")
    routes = {"flash_attention_kernel": dict(attn.flash_attention_kernel.launches_by_route),
              "ssd_intra": dict(ssd.ssd_intra.launches_by_route)}
    for name, n in expect.items():  # bfloat16 activations: every launch on the path's route
        want_routes = {"wgmma": 0, "cuda_cores": 0, routes_wanted[name]: n}
        check(routes[name] == want_routes, f"{tag}: {name} routes {routes[name]}, expected {want_routes}")
    if "flash_attention_kernel" in expect:
        check(attn.flash_attention_kernel.copies == 0,
              f"{tag}: {attn.flash_attention_kernel.copies} operand copies before flash attention")
    check(logits.shape == (LM_BATCH, 1, padded_vocab(cfg)) and bool(torch.isfinite(logits[..., :V]).all()),
          f"{tag}: prefill logits {tuple(logits.shape)}")
    operands = {}
    if "flash_attention_kernel" in expect:
        q, k, v = fa.args
        causal = fa.kwargs.get("causal", True)
        err = _max_err(attn.flash_attention_kernel(q, k, v, causal=causal),
                       attn.flash_attention_plain(q, k, v, causal=causal))
        check(err <= 3e-2, f"{tag}: flash attention at the path's operands differs from plain by {err}")
        log(f"{tag}: flash attention at its first call's operands q {list(q.shape)} k {list(k.shape)} "
            f"{q.dtype} ({attn.route(q.dtype, q.shape[-1])} route): within 3e-2 of the plain version "
            f"({err:.3g})")
        operands["flash_attention_kernel"] = (q, k, v, causal)
    if "ssd_intra" in expect:
        ops = si.args
        x = ops[0]
        path = ssd.route(x.dtype, x.shape[1], x.shape[3], ops[3].shape[-1])
        before = ssd.ssd_intra.launches_by_route[path]
        errs = [_max_err(g, w) for g, w in zip(ssd.ssd_intra(*ops), ssd.ssd_intra_plain(*ops))]
        check(ssd.ssd_intra.launches_by_route[path] == before + 1, f"{tag}: ssd_intra left the {path} route")
        check(max(errs) <= 1e-4, f"{tag}: ssd_intra at the path's operands differs from plain by {errs}")
        log(f"{tag}: ssd_intra at its first call's operands x {list(x.shape)} {x.dtype}, "
            f"B {list(ops[3].shape)} on the path's {path} route: y, state, cdecay within 1e-4 of the "
            f"plain version ({max(errs):.3g})")
        operands["ssd_intra"] = ops

    def teacher_forced(step_cfg):
        """The prefill's logits, then two teacher-forced decode steps from a
        copy of the prefill's cache; each step's dropped count, and the
        steps' routing (one call a layer a step)."""
        step = make_decode_step(step_cfg)
        tf_cache = {k: t.clone() for k, t in cache.items()}
        out, dropped = [logits[:, -1, :V]], [prefill_dropped]
        with _Routing() as routing:
            for t in (LM_PROMPT, LM_PROMPT + 1):
                moe.reset_dropped()
                ld, tf_cache = step(params, tf_cache, tokens[:, t:t + 1])
                out.append(ld[:, -1, :V])
                dropped.append(moe.dropped_assignments())
        return out, dropped, routing.calls

    with torch.inference_mode():
        served, served_dropped, served_routing = teacher_forced(cfg)
        if is_moe:  # the same steps at a capacity of T*K + 1: nothing drops
            nodrop, nodrop_dropped, nodrop_routing = teacher_forced(
                dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts)))
            check(nodrop_dropped[1:] == [0, 0], f"{tag}: the no-drop decode steps dropped {nodrop_dropped}")

        step = make_decode_step(cfg)
        tok = logits[:, -1:, :V].argmax(dim=-1)
        moe.reset_dropped()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = []
        for _ in range(LM_GEN):
            ld, cache = step(params, cache, tok)
            tok = ld[:, :, :V].argmax(dim=-1)
            gen.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        greedy_dropped = moe.dropped_assignments()
    check(int(cache["pos"]) == LM_MAX_LEN, f"{tag}: cache at {int(cache['pos'])} after decode")
    gen = torch.cat(gen, dim=1)
    check(bool(((gen >= 0) & (gen < V)).all()), f"{tag}: generated ids out of the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cb = cache_bytes(cfg, LM_BATCH, LM_MAX_LEN)
    drops = (f"; MoE assignments dropped: prefill {prefill_dropped} of "
             f"{LM_BATCH * LM_PROMPT * cfg.experts_per_token * cfg.num_layers}, the {LM_GEN} greedy steps "
             f"{greedy_dropped} of {LM_GEN * LM_BATCH * cfg.experts_per_token * cfg.num_layers}"
             if is_moe else "")
    log(f"{tag}: {param_count(cfg)} parameters (bf16, init {init_s:.3f} s); prefill {LM_BATCH} x "
        f"{LM_PROMPT} tokens {prefill_s:.3f} s ({LM_BATCH * LM_PROMPT / prefill_s:.0f} tokens/s), "
        f"launches {got}, routes {routes}; decode {LM_GEN} greedy steps {decode_s:.3f} s "
        f"({decode_s / LM_GEN * 1e3:.2f} ms a step for {LM_BATCH} requests); cache {cb} bytes; "
        f"peak device memory {peak:.2f} GiB{drops}; request 0 generated {gen[0, :8].tolist()}...")
    del cache
    with torch.inference_mode():
        state = {}
        _profiled_split(torch, lambda: state.update(zip(("logits", "cache"), prefill_with_cache(
            params, tokens[:, :LM_PROMPT], cfg, LM_MAX_LEN))), f"{tag} prefill")
        tok = state["logits"][:, -1:, :V].argmax(dim=-1)

        steps = min(8, LM_GEN)  # the cache has room for LM_GEN more tokens

        def decode():
            for _ in range(steps):
                step(params, state["cache"], tok)

        _profiled_split(torch, decode, f"{tag} decode, {steps} steps")
        del state

    # decode vs forward over the same tokens.  At these widths two bfloat16
    # computations of the same logits differ by more than 5e-2 (the bfloat16
    # forward is ~0.1 from a float32 forward of the same weights), so the
    # decode steps are held to a float32 forward: no more than 5e-2 further
    # from it than the bfloat16 forward is.  The prefill equals forward.
    # The float32 forward keeps the bfloat16 weights: every layer casts its
    # parameters to the activations' dtype at use, so the numbers are those
    # of a float32 copy of the tree without holding one (deepseek-v2's would
    # not fit beside the bfloat16 tree).
    at = slice(LM_PROMPT - 1, LM_PROMPT + 2)
    with torch.inference_mode():
        last = forward(params, {"tokens": tokens[:, :LM_PROMPT]}, cfg, last_only=True)[0][:, -1, :V]
        moe.reset_dropped()
        fwd16 = forward(params, {"tokens": tokens}, cfg)[0][:, at, :V].clone()
        fwd16_dropped = moe.dropped_assignments()
        layers.COMPUTE_DTYPE = torch.float32  # activations follow it
        try:
            moe.reset_dropped()
            with _Routing() as fwd32_routing:
                fwd32, fwd32_counts = _counted(
                    lambda: forward(params, {"tokens": tokens}, cfg)[0][:, at, :V].clone())
            fwd32_dropped = moe.dropped_assignments()
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
    del params
    fwd32_routes = {name: dict(w.launches_by_route) for name, w in _wrappers().items()
                    if name in expect}
    for name in expect:  # float32 activations: every launch on the CUDA cores
        want_routes = {"wgmma": 0, "cuda_cores": fwd32_counts[name]}
        check(fwd32_counts[name] > 0 and fwd32_routes[name] == want_routes,
              f"{tag}: float32 forward {name} routes {fwd32_routes[name]}, expected {want_routes}")

    def rounded(errs):
        return [float(f"{e:.4g}") for e in errs]

    L_moe, S_fwd = (cfg.num_layers if is_moe else 0), tokens.shape[1]

    def held_rows(step_routing):
        """{decode step: the requests held}: those that, in every layer,
        went to the float32 forward's experts at that position and lost
        no assignment in either (every request without MoE)."""
        held = {}
        for i in (1, 2):
            pos = LM_PROMPT - 1 + i
            held[i] = [b for b in range(LM_BATCH) if all(
                torch.equal(step_routing[(i - 1) * L_moe + l][0][b],
                            fwd32_routing.calls[l][0][b * S_fwd + pos])
                and not step_routing[(i - 1) * L_moe + l][1][b]
                and not fwd32_routing.calls[l][1][b * S_fwd + pos]
                for l in range(L_moe))]
        return held

    def held_steps(out, step_routing, what):
        """The held requests' decode logits against the float32 forward;
        returns the errors of every request, of the held ones, and which."""
        held = held_rows(step_routing)
        vs32 = [_max_err(out[i], fwd32[:, i]) for i in range(3)]
        vs32_held = {i: _max_err(out[i][held[i]], fwd32[held[i], i]) for i in (1, 2)}
        check(all(vs32_held[i] <= floor[i] + LM_LOGITS_ATOL for i in (1, 2)),
              f"{tag}: {what} decode vs float32 forward over the held requests {vs32_held} "
              f"(held {held}) exceeds the bfloat16 forward's {floor[1:]} + 5e-2")
        return vs32, vs32_held, held

    vs16 = [_max_err(served[i], fwd16[:, i]) for i in range(3)]
    floor = [_max_err(fwd16[:, i], fwd32[:, i]) for i in range(3)]
    last_err = _max_err(served[0], last)
    # with MoE, the forward over 2,176 tokens routes them at another
    # capacity and through GEMMs of other shapes than the prefill's 2,048,
    # so a near-tied expert can go the other way (held: forward(last_only),
    # over the prefill's own tokens)
    check(is_moe or vs16[0] <= LM_LOGITS_ATOL, f"{tag}: prefill logits vs forward {vs16[0]} > 5e-2")
    check(last_err <= LM_LOGITS_ATOL, f"{tag}: prefill logits vs forward(last_only) {last_err} > 5e-2")
    vs32, vs32_held, held = held_steps(served, served_routing, "served")
    extra = ""
    if is_moe:
        nd32, nd32_held, nd_held = held_steps(nodrop, nodrop_routing, "no-drop")
        check(sum(map(len, nd_held.values())) > 0, f"{tag}: no request of the no-drop steps was held")
        extra = (f"; MoE dropped assignments: prefill {prefill_dropped}, the served steps "
                 f"{served_dropped[1:]}, the bfloat16 forward {fwd16_dropped}, the float32 forward "
                 f"{fwd32_dropped}; requests held (same experts as the float32 forward in every layer, "
                 f"none dropped): served {held}, max |diff| over them "
                 f"{ {i: round(e, 4) for i, e in vs32_held.items()} }; the no-drop steps vs the float32 "
                 f"forward {rounded(nd32[1:])}, held {nd_held}, over them "
                 f"{ {i: round(e, 4) for i, e in nd32_held.items()} }")
    log(f"{tag}: max |logits diff| over positions {LM_PROMPT - 1}..{LM_PROMPT + 1} (prefill, two "
        f"teacher-forced decode steps): vs forward {rounded(vs16)}; prefill vs forward(last_only) "
        f"{last_err:.4g}; vs a float32 forward {rounded(vs32)}, where the bfloat16 forward is "
        f"{rounded(floor)} (logits max |.| {float(fwd32.abs().max()):.3f}); the float32 forward's "
        f"routes {fwd32_routes}{extra}")
    return counts, operands, routes


def _causal_pairs(Sq, Skv):
    """(query, key) pairs a causal row mask q >= k keeps, Sq queries from 0."""
    if Sq <= Skv:
        return Sq * (Sq + 1) // 2
    return Skv * (Skv + 1) // 2 + (Sq - Skv) * Skv


def _flash_row(torch, q, k, v, causal, launches, path, cuda_cores=False):
    """#6 at one shape: the wrapper's kernel (the wgmma route on bf16 with
    D a multiple of 16) beside the plain version and SDPA; with
    ``cuda_cores`` also the CUDA-core kernel (``flash_attention.cu``), run
    by name on the same operands."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn

    run = lambda: attn.flash_attention_kernel(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: attn.flash_attention_plain(q, k, v, causal=causal)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    ms, plain_ms = _time_ms(torch, run), _time_ms(torch, plain, reps=3)
    out = run()
    want = plain()
    err = _max_err(out, want)
    try:  # the library call is timed for comparison only; it may refuse a shape
        library_ms, refused = _time_ms(torch, lib), None
        lib_err = _max_err(out, lib().transpose(1, 2))
    except RuntimeError as e:
        library_ms, lib_err, refused = None, float("nan"), str(e).splitlines()[0][:200]
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    pairs = B * H * (_causal_pairs(Sq, Skv) if causal else Sq * Skv)
    flops = 4 * D * pairs  # q.k and p.v, 2 flops a multiply-add
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = _bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    # the launch alone: the route's kernel run by name on operands it reads
    # in place, ten launches an event pair
    route = attn.route(q.dtype, D)
    ready = attn.tma_ready if route == "wgmma" else (lambda t: t.stride(-1) == 1)
    ops = [t if ready(t) else t.contiguous() for t in (q, k, v)]
    launch_ms = _time_ms(torch, lambda: attn.launch(route, *ops, causal=causal), batch=10)
    row = dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=library_ms, library_refused=refused, path=path, kernel_route=route,
               launch_ms=launch_ms, launch_bound_share=bound / launch_ms,
               tflops=flops / ms / 1e9,
               shape=f"q {list(q.shape)} k/v {list(k.shape)} {str(q.dtype).removeprefix('torch.')}"
                     f" causal={causal}")
    extra = ""
    if cuda_cores:
        old = lambda: attn.launch("cuda_cores", q, k, v, causal=causal)  # noqa: E731
        row["cuda_cores_ms"] = _time_ms(torch, old, reps=3)
        row["cuda_cores_max_abs_err"] = _max_err(old(), want)
        extra = (f"; the CUDA-core kernel {row['cuda_cores_ms']:.3f} ms "
                 f"({row['cuda_cores_ms'] / ms:.1f}x the {row['kernel_route']} kernel with its wrapper, "
                 f"{row['cuda_cores_ms'] / launch_ms:.1f}x the launch alone)")
    log(f"timing flash_attention_kernel [{path}] q {list(q.shape)} k {list(k.shape)}: {ms:.3f} ms "
        f"on the {row['kernel_route']} route with its wrapper, one launch an event pair (the launch "
        f"alone {launch_ms:.3f} ms, ten an event pair: {bound / launch_ms:.1%} of its bound; plain "
        f"{plain_ms:.3f} ms, "
        + (f"sdpa {library_ms:.3f} ms = {ms / library_ms:.2f}x" if refused is None else f"sdpa refused: {refused}")
        + f", bound {bound:.4f} ms by {by}: {flops:.3g} flops at 989 TFLOP/s "
        f"bf16, {nbytes / 1e6:.1f} MB); {flops / ms / 1e9:.2f} TFLOP/s; max |kernel - plain| "
        f"{err:.3g}, |kernel - sdpa| {lib_err:.3g}{extra}")
    return row


def _ssd_wgmma_flops(BC, Q, H, P, N, heads_per_block, bf16_intra=False):
    """Tensor-core flops that ``ssd_intra_sm90.cu`` runs: C B^T once a
    block (m64n128, N rounded up to 64, per warpgroup that has rows), then
    per head y (4 k-steps for rows 0-63, 8 for rows 64-127) and the state (8
    k-steps per 64-row tile of N), each k-step one m64n64k16 per 64 columns
    of P and per bfloat16 part (3 and 3; 1 and 2 under ``bf16_intra``)."""
    ncn, ncp = -(-N // 64), -(-P // 64)
    wgs = 2 if Q > 64 else 1
    blocks = BC * -(-H // heads_per_block)
    parts_m, parts_w = (1, 2) if bf16_intra else (3, 3)
    mma = 2 * 64 * 64 * 16
    s = blocks * wgs * 2 * 64 * 128 * 64 * ncn
    y = BC * H * (4 + 4 * (wgs - 1) * 2) * parts_m * ncp * mma
    state = BC * H * 8 * parts_w * ncp * ncn * mma
    return s + y + state


def _bf16_normal(torch, dev, rng, *shapes):
    import numpy as np

    return [torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev).to(torch.bfloat16)
            for sh in shapes]


def phase_timing_lm(torch, dev, full, figures):
    """#6 at the operands of each full-width model's prefill (``full``:
    {arch: phase_lm_full's result}), at kimi-k2's GQA head dim (112) and
    hubert-xlarge's non-causal heads (80) at the same batch and length, and
    at prefill_32k's length (B = 1, S = 32,768, granite's heads); #7 at
    zamba2's operands on both routes."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import kernel as ssd

    z_counts, z_ops, z_routes = full["zamba2-2.7b"]
    prompt = f"prefill {LM_BATCH} x {LM_PROMPT}"
    main = _flash_row(torch, *z_ops["flash_attention_kernel"], z_counts["flash_attention_kernel"],
                      f"zamba2-2.7b {prompt}")
    rows = []
    for arch, (counts, ops, routes) in full.items():
        if arch == "zamba2-2.7b":
            continue
        row = _flash_row(torch, *ops["flash_attention_kernel"], counts["flash_attention_kernel"],
                         f"{arch} {prompt}", cuda_cores=arch in ("granite-3-8b", "deepseek-v2-236b"))
        row["launches_by_route"] = routes["flash_attention_kernel"]
        rows.append(row)
        if arch == "deepseek-v2-236b":  # MLA's D = 192 left the CUDA cores for the tensor cores
            check(row["kernel_route"] == "wgmma" and row["cuda_cores_ms"] >= 10 * row["launch_ms"],
                  f"#6 at deepseek-v2's operands: the {row['kernel_route']} launch alone "
                  f"{row['launch_ms']:.3f} ms, the CUDA-core kernel {row['cuda_cores_ms']:.3f} ms (< 10x)")
    rng = np.random.default_rng(2)
    for arch, causal in (("kimi-k2-1t-a32b", True), ("hubert-xlarge", False)):
        cfg = get_config(arch)
        H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = _bf16_normal(torch, dev, rng, (LM_BATCH, LM_PROMPT, H, D), (LM_BATCH, LM_PROMPT, KH, D),
                               (LM_BATCH, LM_PROMPT, KH, D))
        check(cfg.causal == causal, f"{arch}: causal={cfg.causal}")
        rows.append(_flash_row(torch, q, k, v, causal, 0, f"{arch}'s heads, {LM_BATCH} x {LM_PROMPT} "
                               "(timing only)"))
    q, k, v = _bf16_normal(torch, dev, rng, (1, PREFILL_32K, 32, 128), (1, PREFILL_32K, 8, 128),
                           (1, PREFILL_32K, 8, 128))
    rows.append(_flash_row(torch, q, k, v, True, 0, "prefill_32k's length, granite's heads (timing only)"))
    del q, k, v
    launches_lm = {f"{arch} prefill": c["flash_attention_kernel"] for arch, (c, _, _) in full.items()}
    flash = dict(name="flash_attention_kernel", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                 replaces="src/repro/kernels/attention/kernel.py:111", **main,
                 launches_by_route=z_routes["flash_attention_kernel"], launches_lm=launches_lm,
                 other_route=dict(name="cuda_cores", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                                  takes="float32, and bfloat16 head dims that are not multiples of 16 "
                                        "(72, 136, 200)"),
                 ptxas=figures["flash_attention_sm90"], rows=rows)
    flash["launches"] = sum(launches_lm.values())

    # the path hands the wrapper views of B and C with the row stride of the
    # fused B|C channels; the wrapper copies them, a route run by name does not
    ops = tuple(t.contiguous() for t in z_ops["ssd_intra"])
    x, _, _, B_, _ = ops
    BC, Q, H, P = x.shape
    N = B_.shape[-1]
    path = ssd.route(x.dtype, Q, P, N)
    check(path == "wgmma", f"zamba2's SSD operands take the {path} route")
    run = lambda: ssd.ssd_intra(*ops)  # noqa: E731
    other = lambda: ssd.launch("cuda_cores", *ops)  # noqa: E731
    plain = lambda: ssd.ssd_intra_plain(*ops)  # noqa: E731
    # 10 launches an event pair: a lone call's ~0.1 ms of host work in the
    # wrapper would count as device time at this kernel's length
    turns = [_time_ms(torch, f, batch=10) for f in (run, other, other, run)]
    ms, other_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    single_ms = _time_ms(torch, run)
    plain_ms = _time_ms(torch, plain, reps=3)
    bf16_intra_ms = _time_ms(torch, lambda: ssd.ssd_intra(*ops, bf16_intra=True), batch=10)
    want = plain()
    err = max(_max_err(g, w) for g, w in zip(run(), want))
    other_err = max(_max_err(g, w) for g, w in zip(other(), want))
    tri = Q * (Q + 1) // 2
    # the function's float32 work: C B^T once a chunk (lower triangle), then
    # per chunk and head M x over the causal pairs and the state x^T (B w);
    # 2 flops a multiply-add.  The CUDA-core route does this in float32.
    flops = 2 * BC * tri * N + 2 * BC * H * (tri * P + Q * P * N)
    nbytes = sum(t.numel() * t.element_size() for t in ops) + 4 * (x.numel() + BC * H * P * N + BC * H)
    fp32_bound, fp32_by = _bound_ms(nbytes, flops, FP32_FLOPS)
    hg = ssd.heads_per_block(BC, H, P, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    tensor_flops = _ssd_wgmma_flops(BC, Q, H, P, N, hg)
    bound, by = _bound_ms(nbytes, tensor_flops, BF16_TENSOR_FLOPS)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ptxas = figures["ssd_intra_sm90"]
    log(f"timing ssd_intra [zamba2-2.7b prefill] x {list(x.shape)} N={N}: {ms:.3f} ms on the wgmma "
        f"route (10 launches an event pair, turns {[round(v, 4) for v in turns]}; one launch an event "
        f"pair {single_ms:.3f} ms; the CUDA-core kernel {other_ms:.3f} ms = "
        f"{other_ms / ms:.1f}x; plain {plain_ms:.3f} ms; bf16_intra {bf16_intra_ms:.3f} ms); bound "
        f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB = {bytes_ms:.4f} ms; {tensor_flops:.3g} tensor-core "
        f"flops at 989 TFLOP/s bf16 = {tensor_flops / BF16_TENSOR_FLOPS * 1e3:.4f} ms; the CUDA-core "
        f"route's {flops:.3g} flops at 67 TFLOP/s fp32 = {fp32_bound:.4f} ms by {fp32_by}); "
        f"{flops / ms / 1e9:.2f} TFLOP/s of the function's float32 work, {tensor_flops / ms / 1e9:.2f} "
        f"TFLOP/s on the tensor cores ({hg} heads a block); max |kernel - plain| {err:.3g} (CUDA cores "
        f"{other_err:.3g}); "
        f"ssd_intra_sm90 ptxas (<N chunks, P chunks, bf16_intra>: registers, spill-store bytes): "
        f"{ {k: (v.get('registers'), v.get('spill_store_bytes')) for k, v in ptxas['kernels'].items()} }, "
        f"{ptxas['hgmma']} HGMMA, built in {ptxas['build_s']} s; library_ms: no single PyTorch "
        "call computes the masked decayed product and the chunk states")
    ssd_entry = dict(
        name="ssd_intra", route="cuda", source="src/repro_torch/kernels/csrc/ssd_intra_sm90.cu",
        replaces="src/repro/kernels/ssd/kernel.py:69", launches=z_counts["ssd_intra"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        launches_by_route=z_routes["ssd_intra"], kernel_route=path, bytes_bound_ms=bytes_ms,
        tensor_flops=tensor_flops, heads_per_block=hg, tflops=flops / ms / 1e9,
        fp32_operations_bound_ms=fp32_bound,
        bf16_intra_ms=bf16_intra_ms, single_call_ms=single_ms, ptxas=ptxas,
        other_route=dict(name="cuda_cores", source="src/repro_torch/kernels/csrc/ssd_intra.cu",
                         ms=other_ms, max_abs_err=other_err, bound_ms=fp32_bound, bound_by=fp32_by,
                         takes="float32 operands, and bfloat16 shapes with P or N not a multiple of 16"),
        path=f"zamba2-2.7b prefill {LM_BATCH} x {LM_PROMPT}",
        shape=f"x {list(x.shape)} {str(x.dtype).removeprefix('torch.')} N={N}")
    return [flash, ssd_entry]


def phase_lm(torch, dev, figures):
    """The LM phases (19-22): kernels at edge shapes, the reduced models,
    the four full-width models and the timing rows; logs each phase's
    seconds and returns the timing phase's kernel entries (#6, #7)."""
    lm_seconds, full = {}, {}
    t0 = time.perf_counter()
    phase_lm_kernels(torch, dev)
    lm_seconds["lm kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_lm_small(torch, dev)
    lm_seconds["lm small"] = time.perf_counter() - t0
    for arch, expect, kw in (
            ("zamba2-2.7b", {"flash_attention_kernel": 9, "ssd_intra": 54}, {}),
            ("granite-3-8b", {"flash_attention_kernel": 40}, {}),
            # MLA's q/k head dim 128 + 64 = 192 (64-key tiles on the wgmma
            # route); 4 of 60 layers: the 60 would be ~476 GB of bfloat16 weights
            ("deepseek-v2-236b", {"flash_attention_kernel": 4}, dict(num_layers=4)),
            # 31 of 62 layers: the smoke's 600 s aim once the training
            # phases joined it
            ("minicpm3-4b", {"flash_attention_kernel": 31}, dict(num_layers=31))):
        t0 = time.perf_counter()
        full[arch] = phase_lm_full(torch, dev, arch, expect, **kw)
        lm_seconds[arch] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    entries = phase_timing_lm(torch, dev, full, figures)
    lm_seconds["lm timing"] = time.perf_counter() - t0
    log(json.dumps({"lm_phase_s": lm_seconds}))
    return entries


# ---------------------------------------------------------------------------
# LM training: #6 and #7 forward with a gradient through each
# ---------------------------------------------------------------------------
# zamba2-2.7b's train_4k length, a global batch of 4 as 2 microbatches of 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 4_096, 4, 2
TRAIN_GRAD_REL = 5e-2


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _vjp(torch, fn, args, cots):
    """Gradients of sum(out * cotangent) with respect to ``args``."""
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(sum((o.float() * c).sum() for o, c in zip(outs, cots)), args)


def _counted_train(fn):
    """``_counted`` with #6's and #7's backwards counted too, by their spans
    (``repro_torch.core.trace``, on for the call, so a timed call takes
    ``_counted``); returns (result, launches, backward calls)."""
    from repro_torch.core import trace

    with trace.counting() as spans:
        out, counts = _counted(fn)
    return out, counts, {"flash_attention_kernel": trace.calls(spans, "flash_attention.bwd"),
                         "ssd_intra": trace.calls(spans, "ssd_intra.bwd")}


def _flash_train_row(torch, q, k, v, what):
    """#6's autograd op at one shape: its gradient against autograd through
    the plain version in float32 (3e-2 relative L2), on the wgmma backward;
    the forward kernel (with and without the logsumexp), the backward on
    both routes (the wgmma kernels, ``flash_attention_bwd``'s torch ops) and
    SDPA's forward + backward timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.attention.ops import flash_attention

    rng_dout = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(1),
                           device=q.device)
    before = dict(attn.flash_attention_backward.launches_by_route)
    got = _vjp(torch, lambda q, k, v: flash_attention(q, k, v, causal=True), (q, k, v), (rng_dout,))
    check(attn.flash_attention_backward.launches_by_route["wgmma"] == before["wgmma"] + 1,
          f"{what}: the backward did not take the wgmma route")
    want = _vjp(torch, lambda q, k, v: attn.flash_attention_plain(q, k, v, causal=True),
                [t.float() for t in (q, k, v)], (rng_dout,))
    errs = [_rel_l2(g, w) for g, w in zip(got, want)]
    check(all(g.dtype == q.dtype and bool(torch.isfinite(g).all()) for g in got), f"{what}: grads")
    check(max(errs) <= 3e-2, f"{what}: dq/dk/dv relative L2 {errs} > 3e-2")
    out, lse = attn.flash_attention_kernel(q, k, v, causal=True, with_lse=True)
    dout = rng_dout.to(q.dtype)
    fwd_ms = _time_ms(torch, lambda: attn.flash_attention_kernel(q, k, v, causal=True))
    fwd_lse_ms = _time_ms(torch, lambda: attn.flash_attention_kernel(q, k, v, causal=True, with_lse=True))
    bwd_ms = _time_ms(torch, lambda: attn.flash_attention_backward(q, k, v, out, dout, lse, causal=True))
    ops_ms = _time_ms(torch, lambda: attn.flash_attention_bwd(q, k, v, out, dout, causal=True), reps=3)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, (qs, ks, vs), dout.transpose(1, 2))

    sdpa_ms = _time_ms(torch, sdpa)
    B, S, H, D = q.shape
    pairs = B * H * _causal_pairs(S, k.shape[1])
    # five products a causal pair (scores, dp, dv, dq, dk), 2 flops a
    # multiply-add; each of q, k, v, out, dout read once, dq, dk, dv written
    flops = 10 * D * pairs
    nbytes = (3 * q.numel() + 3 * k.numel() + 2 * q.numel()) * q.element_size()
    bound, by = _bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    fp32_bound, _ = _bound_ms(nbytes, flops, FP32_FLOPS)
    row = dict(shape=f"q {list(q.shape)} k/v {list(k.shape)} {str(q.dtype).removeprefix('torch.')}",
               grad_rel_l2=max(errs), forward_ms=fwd_ms, forward_lse_ms=fwd_lse_ms, backward_ms=bwd_ms,
               torch_ops_backward_ms=ops_ms, sdpa_fwd_bwd_ms=sdpa_ms, backward_bound_ms=bound,
               backward_bound_by=by, backward_share_of_bound=bound / bwd_ms,
               backward_fp32_bound_ms=fp32_bound, backward_tflops=flops / bwd_ms / 1e9)
    log(f"train kernels: #6 {what} {row['shape']}: gradient within 3e-2 of autograd through the plain "
        f"version in float32 (dq, dk, dv {[round(e, 5) for e in errs]}); forward {fwd_ms:.3f} ms "
        f"({fwd_lse_ms:.3f} with the logsumexp); backward on wgmma {bwd_ms:.3f} ms "
        f"({flops / bwd_ms / 1e9:.2f} TFLOP/s, {100 * bound / bwd_ms:.1f}% of the bound {bound:.4f} ms "
        f"by {by} at 989 TFLOP/s bf16), flash_attention_bwd {ops_ms:.3f} ms (float32 torch ops; "
        f"{fp32_bound:.4f} ms at 67 TFLOP/s fp32), SDPA forward + backward {sdpa_ms:.3f} ms")
    return row


def _ssd_train_rows(torch, dev):
    """#7's autograd op at zamba2's operands [64, 128, 80, 64], N = 64:
    the gradient of (y, state, cdecay) against autograd through the plain
    version in float32 (rounded to the gradient's dtype) on bfloat16
    operands (wgmma route), float32 operands (CUDA-core route), both within
    1e-4, and under ``bf16_intra`` within 5e-2; the forward kernel and
    ``ssd_intra_bwd`` timed."""
    import numpy as np

    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.ops import ssd_intra_op

    rng = np.random.default_rng(3)
    BC, Q, H, P, N = 64, 128, 80, 64, 64
    rows = {}
    for dtype, bf16_intra, tol in ((torch.bfloat16, False, 1e-4), (torch.float32, False, 1e-4),
                                   (torch.float32, True, 5e-2)):
        ops = _ssd_operands(torch, dev, BC, Q, H, P, N, dtype, rng)
        path = ssd.route(dtype, Q, P, N, bf16_intra=bf16_intra)
        cots = [torch.as_tensor(rng.normal(size=o.shape).astype(np.float32), device=dev)
                for o in ssd.ssd_intra_plain(*ops)]
        got = _vjp(torch, lambda *a: ssd_intra_op(*a, bf16_intra=bf16_intra), ops, cots)
        want = _vjp(torch, lambda *a: ssd.ssd_intra_plain(*a, bf16_intra=bf16_intra),
                    [t.float() for t in ops], cots)
        # bfloat16 operands get bfloat16 gradients: held against the float32
        # gradient rounded the same way
        errs = [_rel_l2(g, w.to(g.dtype)) for g, w in zip(got, want)]
        what = f"#7 [{path}{', bf16_intra' if bf16_intra else ''}] x {[BC, Q, H, P]} {dtype}"
        check(all(bool(torch.isfinite(g).all()) for g in got), f"train kernels: {what}: grads not finite")
        check(max(errs) <= tol, f"train kernels: {what}: (dx, dcum, ddt, dB, dC) relative L2 {errs} > {tol}")
        outs = ssd.ssd_intra(*ops, bf16_intra=bf16_intra)
        fwd_ms = _time_ms(torch, lambda: ssd.ssd_intra(*ops, bf16_intra=bf16_intra), batch=10)
        bwd_ms = _time_ms(torch, lambda: ssd.ssd_intra_bwd(*ops, *[torch.ones_like(o) for o in outs],
                                                           bf16_intra=bf16_intra), reps=3)
        BC_, Q_, H_, P_ = ops[0].shape
        N_ = ops[3].shape[-1]
        # the backward's least work: its inputs and cotangents read once, the
        # five gradients written once; its products (S recomputed, dM = dy x^T
        # and M^T dy over the causal pairs, dS's two products, and the state's
        # four) at the bf16 tensor-core rate
        tri = Q_ * (Q_ + 1) // 2
        flops = 2 * BC_ * (3 * tri * N_ + 2 * H_ * tri * P_ + 2 * H_ * Q_ * P_ * N_ + 2 * H_ * Q_ * N_)
        nbytes = sum(t.numel() * t.element_size() for t in (*ops, *got)) + sum(4 * c.numel() for c in cots)
        bound, by = _bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
        key = path + ("_bf16_intra" if bf16_intra else "")
        rows[key] = dict(grad_rel_l2=max(errs), forward_ms=fwd_ms, backward_ms=bwd_ms,
                         backward_bound_ms=bound, backward_bound_by=by,
                         shape=f"x {[BC, Q, H, P]} {str(dtype).removeprefix('torch.')} N={N}")
        log(f"train kernels: {what}: gradient within {tol} of autograd through the plain version "
            f"({[float(f'{e:.3g}') for e in errs]}); forward {fwd_ms:.3f} ms, ssd_intra_bwd {bwd_ms:.3f} ms "
            f"(float32 torch ops; bound {bound:.4f} ms by {by}: {nbytes / 1e6:.1f} MB, {flops:.3g} flops)")
    return rows


def phase_train_kernels(torch, dev):
    """#6 at [2, 4096, 32, 80], granite's [2, 4096, 32/8, 128] and the
    zamba2-train-4k cell's [2, 4096, 32, 160] (bfloat16, causal) and #7 at
    zamba2's [64, 128, 80, 64]: each autograd op's gradient against
    autograd through the plain version, and times."""
    import numpy as np

    rng = np.random.default_rng(2)
    flash = {}
    for what, (H, KH, D) in (("heads of 80", (32, 32, 80)), ("granite-3-8b", (32, 8, 128)),
                             ("zamba2-2.7b", (32, 32, 160))):
        q, k, v = _bf16_normal(torch, dev, rng, (2, TRAIN_SEQ, H, D), (2, TRAIN_SEQ, KH, D),
                               (2, TRAIN_SEQ, KH, D))
        flash[what] = _flash_train_row(torch, q, k, v, what)
        del q, k, v
    torch.cuda.empty_cache()
    return flash, _ssd_train_rows(torch, dev)


@contextlib.contextmanager
def _plain_kernels():
    """The model's attention and SSD scan through the plain versions (torch
    autograd through their torch ops): the plain path the kernel path's
    gradient is held against."""
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import layers, mamba

    real = layers.flash_attention, mamba.ssd_chunked
    layers.flash_attention, mamba.ssd_chunked = attn.flash_attention_plain, ssd_ref.ssd_chunked
    try:
        yield
    finally:
        layers.flash_attention, mamba.ssd_chunked = real


def _all_leaves(tree):
    from repro_torch.train.optimizer import leaves

    return leaves(tree)


def phase_train_small(torch, dev):
    """Reduced granite-3-8b (dense), mamba2-1.3b (ssm), zamba2-2.7b (hybrid)
    and deepseek-v2-236b (MoE + MLA): the loss and every gradient leaf on
    the card against the CPU (loss within 5e-2, each leaf within 5e-2
    relative L2, every leaf finite and nonzero, equal MoE drops), then one
    train step on the card.  Returns the launches of the card's runs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.inputs import make_inputs
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (
        TrainConfig, loss_and_grads, make_train_state, make_train_step,
    )

    launches = {}
    for arch in ("granite-3-8b", "mamba2-1.3b", "zamba2-2.7b", "deepseek-v2-236b"):
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 0, "cpu")
        inputs = make_inputs(cfg, SHAPES["train_4k"].reduced(), seed=0, device="cpu")
        runs = {}
        for where in ("cpu", dev):
            moe.reset_dropped()
            (loss, _, grads), counts, bwd = _counted_train(
                lambda: loss_and_grads(_to(params, where), _to(inputs, where), cfg))
            runs[str(where)] = (float(loss), [g.cpu() for g in _all_leaves(grads)], moe.dropped_assignments(),
                                counts, bwd)
        (lc, gc, dc, _, _), (lg, gg, dg, counts, bwd) = runs["cpu"], runs[str(dev)]
        expect_launched(counts, _lm_kernels(cfg))
        check(abs(lg - lc) <= 5e-2, f"train small {arch}: loss card {lg} CPU {lc}")
        check(dg == dc, f"train small {arch}: MoE drops card {dg} CPU {dc}")
        errs = [_rel_l2(g, w) for g, w in zip(gg, gc)]
        check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in gg),
              f"train small {arch}: a gradient leaf is not finite or all zero on the card")
        check(max(errs) <= TRAIN_GRAD_REL, f"train small {arch}: gradient leaves vs CPU {max(errs)} > 5e-2")
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1))
        p = _to(params, dev)
        (_, _, m), step_counts = _counted(
            lambda: make_train_step(cfg, tcfg)(p, make_train_state(p, tcfg), _to(inputs, dev)))
        check(bool(torch.isfinite(m["loss"])), f"train small {arch}: train step loss {m['loss']}")
        launches[arch] = {k: counts[k] for k in _lm_kernels(cfg)}
        log(f"train small {arch} (reduced): loss card {lg:.5f} CPU {lc:.5f}; {len(gg)} gradient leaves, "
            f"worst relative L2 vs CPU {max(errs):.3g}, every leaf finite and nonzero; MoE drops {dg}; "
            f"launches {launches[arch]}, backward calls { {k: bwd[k] for k in _lm_kernels(cfg)} }; a train "
            f"step on the card: loss {float(m['loss']):.5f}, grad norm {float(m['grad_norm']):.4f}")
    return launches


def _train_batch(torch, dev, V):
    import numpy as np

    docs = torch.as_tensor(np.random.default_rng(5).integers(0, V, (TRAIN_BATCH, TRAIN_SEQ + 1)),
                           device=dev, dtype=torch.int32)
    return {"tokens": docs[:, :-1].contiguous(), "labels": docs[:, 1:].contiguous()}


def phase_train_full(torch, dev, arch="zamba2-2.7b"):
    """zamba2-2.7b at published widths, all 54 layers, random bfloat16 init:
    3 train steps on one batch of 4 x 4,096 tokens (2 microbatches, f32
    moments, lr 3e-4, warmup 1), the loss falling from step 1 to 3; then a
    step with 8-bit moments and EF compression.  Each step launches #6
    (9 + 9 recomputed) and #7 (54 + 54) a microbatch and runs each
    backward once a launch's forward, #6's on its wgmma kernels (9 a
    microbatch, 18 a step, none on torch ops); every gradient leaf of a microbatch
    at the initial weights is finite and nonzero; a fourth step is
    profiled (device activity); and the first group (6
    mamba layers and the shared block) at published widths: the kernel
    path's whole gradient within 5e-2 relative L2 of the plain path's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.models.model import init_params, param_count, units
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (
        TrainConfig, loss_and_grads, make_train_state, make_train_step,
    )

    cfg = get_config(arch)
    tag = f"train {arch} full"
    n_units = len(units(cfg))
    groups = cfg.num_layers // cfg.shared_attn_every
    per_mb = {"flash_attention_kernel": 2 * groups, "ssd_intra": 2 * cfg.num_layers}
    per_step = {k: TRAIN_ACCUM * v for k, v in per_mb.items()}
    bwd_mb = {k: v // 2 for k, v in per_mb.items()}
    # #6's backward routes: every call on the wgmma kernels
    bwd_routes_mb = {"wgmma": groups, "torch_ops": 0}
    bwd_routes_step = {"wgmma": TRAIN_ACCUM * groups, "torch_ops": 0}

    def bwd_routes(what, want):
        got = dict(attn.flash_attention_backward.launches_by_route)
        check(got == want, f"{tag}: {what}: #6's backward routes {got}, expected {want}")
        return got
    parts = {}
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _train_batch(torch, dev, cfg.vocab_size)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # every gradient leaf of a microbatch at the initial weights, finite and
    # nonzero: no leaf left without a gradient by a kernel's output
    t0 = time.perf_counter()
    mb = {k: v[:TRAIN_BATCH // TRAIN_ACCUM] for k, v in batch.items()}
    (_, _, grads), counts, bwd = _counted_train(lambda: loss_and_grads(params, mb, cfg))
    flat = _all_leaves(grads)
    bad = [i for i, g in enumerate(flat) if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    check(not bad, f"{tag}: {len(bad)} of {len(flat)} gradient leaves not finite or all zero")
    check({k: counts[k] for k in per_mb} == per_mb, f"{tag}: a microbatch's launches {counts}")
    check(bwd == bwd_mb, f"{tag}: a microbatch's backward calls {bwd}, expected {bwd_mb}")
    bwd_routes("a microbatch", bwd_routes_mb)
    n_leaves = len(flat)
    del grads, flat
    parts["microbatch grads"] = time.perf_counter() - t0
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1), grad_accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats(dev)
    state = make_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    losses, secs, step_counts = [], [], None
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (params, state, m), counts = _counted(lambda: step(params, state, batch))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        got = {k: counts[k] for k in per_step}
        check(got == per_step, f"{tag}: step {i + 1} launches {got}, expected {per_step} "
              f"({TRAIN_ACCUM} microbatches x (forward + recompute))")
        step_counts = got
        step_bwd_routes = bwd_routes(f"step {i + 1}", bwd_routes_step)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(math.isfinite(v) for v in losses) and losses[2] < losses[0],
          f"{tag}: losses {losses} did not fall from step 1 to step 3")
    t0 = time.perf_counter()
    _profiled_split(torch, lambda: step(params, state, batch), f"{tag} train step 4 (f32 moments)")
    parts["profiled step"] = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    # 8-bit moments and EF compression
    tcfg8 = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1, state_bits=8), grad_accum=TRAIN_ACCUM,
                        compress_grads=True)
    state8 = make_train_state(params, tcfg8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (params, state8, m8), counts8 = _counted(lambda: make_train_step(cfg, tcfg8)(params, state8, batch))
    loss8 = float(m8["loss"])
    s8 = time.perf_counter() - t0
    check(math.isfinite(loss8), f"{tag}: the 8-bit + compression step's loss {loss8}")
    check({k: counts8[k] for k in per_step} == per_step, f"{tag}: 8-bit step launches {counts8}")
    bwd_routes("the 8-bit step", bwd_routes_step)
    del state8
    torch.cuda.empty_cache()
    peak_all = torch.cuda.max_memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    group = _first_group_grads(torch, cfg, params, mb)
    parts["first group"] = time.perf_counter() - t0
    log(f"{tag}: {param_count(cfg) / 1e9:.3f} B parameters, init {init_s:.2f} s; {n_units} recomputed "
        f"units; 3 steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens ({TRAIN_ACCUM} microbatches): losses "
        f"{[round(v, 5) for v in losses]}, step seconds {[round(v, 3) for v in secs]} "
        f"({tokens / statistics.median(secs):.1f} tokens/s at the median), peak {peak:.2f} GiB "
        f"(f32 moments); launches a step {step_counts}, backward calls a microbatch {bwd_mb}, #6's backward "
        f"routes a step {step_bwd_routes}; the 8-bit + "
        f"compression step: loss {loss8:.5f}, {s8:.3f} s; peak over all {peak_all:.2f} GiB; all "
        f"{n_leaves} gradient leaves of a microbatch at the initial weights finite and nonzero; seconds "
        f"{ {k: round(v, 2) for k, v in parts.items()} }")
    return dict(per_step=per_step, bwd_routes_step=step_bwd_routes, losses=losses, step_s=secs,
                tokens_per_s=tokens / statistics.median(secs), peak_gib=peak, peak_all_gib=peak_all,
                step8_s=s8, loss8=loss8, first_group=group, seconds=parts)


def _first_group_grads(torch, cfg, params, mb):
    """The model cut to its first unit (6 mamba layers and the shared
    block) at published widths: the whole gradient on the kernel path
    against the plain path, same dtype, same batch, on the card."""
    from repro_torch.models.model import units
    from repro_torch.train.train_step import loss_and_grads

    n = len(units(cfg)[0])
    cut = dataclasses.replace(cfg, num_layers=n)
    sub = dict(params)
    sub["blocks"] = {k: (v[:n] if not isinstance(v, dict) else {kk: vv[:n] for kk, vv in v.items()})
                     for k, v in params["blocks"].items()}
    (loss_k, _, g_k), counts = _counted(lambda: loss_and_grads(sub, mb, cut))
    g_k = torch.cat([g.float().flatten() for g in _all_leaves(g_k)])
    with _plain_kernels():
        (loss_p, _, g_p), plain_counts = _counted(lambda: loss_and_grads(sub, mb, cut))
    g_p = torch.cat([g.float().flatten() for g in _all_leaves(g_p)])
    err = _rel_l2(g_k, g_p)
    check(sum(plain_counts.values()) == 0, f"the plain path launched {plain_counts}")
    check(bool(torch.isfinite(g_p).all()), "the plain path's first-group gradient is not finite")
    check(err <= TRAIN_GRAD_REL, f"first group: kernel path's gradient vs the plain path's {err} > 5e-2")
    log(f"train first group ({n} mamba layers + the shared block, published widths, {mb['tokens'].shape[0]} "
        f"x {mb['tokens'].shape[1]} tokens): loss kernels {float(loss_k):.5f} plain {float(loss_p):.5f}; "
        f"whole gradient ({g_k.numel()} values) within {err:.4g} relative L2 of the plain path's; launches "
        f"{ {k: counts[k] for k in ('flash_attention_kernel', 'ssd_intra')} }")
    return dict(rel_l2=err, loss_kernels=float(loss_k), loss_plain=float(loss_p))


def phase_train_example(torch, dev, ckpt_dir):
    """``examples/torch_train_lm.py`` on the card at a few steps (tiny-100m,
    SSH dedup, a corpus small enough that batches repeat): the loss falls;
    then a resume from its checkpoint runs only the remaining steps."""
    import contextlib as _ctx
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location("torch_train_lm", HERE / "examples" / "torch_train_lm.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = ["--steps", "16", "--num-docs", "64", "--seq-len", "256", "--global-batch", "8",
            "--lr", "1e-3", "--warmup", "2", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "8",
            "--log-every", "100", "--device", str(dev)]
    out = io.StringIO()
    t0 = time.perf_counter()
    with _ctx.redirect_stdout(out):
        (res, counts) = _counted(lambda: module.main(argv))
    s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(lines[-1] == "training improved the loss ✓", f"train example ended {lines[-1:]!r}")
    with _ctx.redirect_stdout(io.StringIO()):
        resumed = module.main([a if a != "16" else "20" for a in argv] + ["--resume"])
    check(len(resumed["losses"]) == 4, f"train example: the resume ran {len(resumed['losses'])} steps, not 4")
    losses = res["losses"]
    log(f"train example (tiny-100m, ssh dedup, 16 steps on the card): {lines[1]}; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {s:.2f} s; resumed at step 16: 4 steps ran; launches "
        f"{counts['flash_attention_kernel']} of #6")
    return {"flash_attention_kernel": counts["flash_attention_kernel"]}


def phase_train(torch, dev, entries):
    """The training phases (23-26); logs each phase's seconds, and adds to
    #6's and #7's entries of ``entries`` their training launches
    (``launches_training``) and gradient figures."""
    seconds = {}
    t0 = time.perf_counter()
    flash_rows, ssd_rows = phase_train_kernels(torch, dev)
    seconds["train kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = phase_train_small(torch, dev)
    seconds["train small"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = phase_train_full(torch, dev)
    seconds["train zamba2 full"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        example = phase_train_example(torch, dev, Path(tmp))
    seconds["train example"] = time.perf_counter() - t0
    by_name = {e["name"]: e for e in entries}
    for name in ("flash_attention_kernel", "ssd_intra"):
        if name not in by_name:  # the training phases run alone
            by_name[name] = {"name": name}
            entries.append(by_name[name])
    for name, rows in (("flash_attention_kernel", flash_rows), ("ssd_intra", ssd_rows)):
        launches = {f"train small {a}": c[name] for a, c in small.items() if name in c}
        launches["zamba2-2.7b train step (2 microbatches, forward + recompute)"] = full["per_step"][name]
        if name == "flash_attention_kernel":
            for route, n in full["bwd_routes_step"].items():
                launches[f"zamba2-2.7b train step, backward on {route}"] = n
        if name in example:
            launches["train example (16 steps)"] = example[name]
        check(sum(launches.values()) > 0, f"kernel {name} was launched on no training path")
        by_name[name]["launches_training"] = launches
        by_name[name]["training"] = rows
    figures = {k: v for k, v in full.items() if k not in ("per_step", "bwd_routes_step")}
    log(json.dumps({"train_phase_s": seconds, "train_zamba2_full": figures}))
    return entries


# ---------------------------------------------------------------------------
# the LM on multi-axis meshes of the one card: expert and data parallelism,
# the dry-run and the perf variants
# ---------------------------------------------------------------------------
MESH_EP_LAYERS, MESH_EP_STEPS = 2, 8
# (request, forward) pairs of the 4 x 9 that may be left out of the logits
# comparison for routing otherwise (a near-tied expert after a bf16 psum)
MESH_EP_MAX_LEFT_OUT = 2


class _RouterInputs:
    """Records every MoE layer's routing of each data shard, on the host:
    the rows routed, each token's experts (in top-k order) and which of its
    assignments were kept (the model ranks' kept assignments together; a
    layer's calls for one data shard come one a model rank, rank 0
    first)."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.calls, self.real = [], moe.route

        def spy(x_flat, router_w, cfg, **kw):
            r = self.real(x_flat, router_w, cfg, **kw)
            rank, tp = kw.get("rank", 0), kw.get("tp", 1)
            T, K = r["experts"].shape
            local = r["experts"].reshape(-1) // (cfg.num_experts // tp) == rank
            kept = torch.zeros(T * K, dtype=torch.bool, device=x_flat.device)
            kept[r["order"]] = r["kept"]
            kept = (kept & local).reshape(T, K).cpu()
            if rank == 0:
                self.calls.append([x_flat.cpu(), r["experts"].cpu(), kept])
            else:
                self.calls[-1][2] |= kept
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.real


class _ExpertStorage:
    """Records the storage of every expert weight a dispatch reads."""

    def __enter__(self):
        from repro_torch.models import moe

        self.ptrs, self.real = set(), moe.dispatch_compute

        def spy(x_flat, router_w, w_gate, w_up, w_down, cfg, **kw):
            self.ptrs |= {w.untyped_storage().data_ptr() for w in (w_gate, w_up, w_down)}
            return self.real(x_flat, router_w, w_gate, w_up, w_down, cfg, **kw)

        moe.dispatch_compute = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.dispatch_compute = self.real


def _serve_on_mesh(torch, params, cfg, tokens, mesh, steps, teacher=None):
    """Prefill ``tokens`` [B, S] and ``steps`` decode steps over ``mesh``
    (greedy, or fed ``teacher`` [B, steps]); returns the logits of the
    prefill and of each step (a list of [B, V]), the tokens fed, each
    routing call's (inputs, experts), the dropped counts (prefill, the
    steps), the launches and the seconds (prefill, decode)."""
    from repro_torch.models import moe
    from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache

    V = cfg.vocab_size
    moe.reset_dropped()
    with torch.inference_mode(), _RouterInputs() as routing:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (logits, cache), counts = _counted(lambda: prefill_with_cache(
            params, tokens, cfg, tokens.shape[1] + steps, mesh=mesh))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        routes = dict(_wrappers()["flash_attention_kernel"].launches_by_route)
        dropped = [moe.dropped_assignments()]
        out, fed = [logits[:, -1, :V].float()], []
        step = make_decode_step(cfg, mesh)
        tok = logits[:, -1:, :V].argmax(dim=-1)
        t0 = time.perf_counter()
        for i in range(steps):
            if teacher is not None:
                tok = teacher[:, i:i + 1]
            fed.append(tok)
            moe.reset_dropped()
            ld, cache = step(params, cache, tok)
            dropped.append(moe.dropped_assignments())
            out.append(ld[:, -1, :V].float())
            tok = ld[:, :, :V].argmax(dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return dict(logits=out, fed=torch.cat(fed, dim=1), routing=routing.calls, dropped=dropped,
                counts=counts, routes=routes, seconds=(prefill_s, decode_s))


def _routing_held(got, want, B, dp=1, inputs_equal=True):
    """Routing against another run.  The calls come a layer at a time
    (the prefill's, then each decode step's), one a data shard (``dp`` of
    them, B / dp requests each).  With ``inputs_equal``: each call's
    experts are equal wherever its input rows are (routing is a function
    of the layer input).  Returns (rows with equal inputs, rows whose
    inputs differed, for each forward (the prefill, then each step) the
    requests whose last position went to the same experts and kept the
    same assignments in every layer)."""
    same_in, differ = 0, 0
    per = B // dp
    calls_per_forward = len(got) // (1 + MESH_EP_STEPS)
    held = [set(range(B)) for _ in range(1 + MESH_EP_STEPS)]
    for i, ((xg, eg, kg), (xw, ew, kw)) in enumerate(zip(got, want)):
        if inputs_equal:
            eq = (xg == xw).all(dim=-1)
            check(_equal(eg[eq], ew[eq]), "routing differs on equal inputs")
            same_in, differ = same_in + int(eq.sum()), differ + int((~eq).sum())
        last = eg.shape[0] // per  # tokens a request in this call
        for j in range(per):
            t = (j + 1) * last - 1
            if not (_equal(eg[t], ew[t]) and _equal(kg[t], kw[t])):
                held[i // calls_per_forward].discard((i % dp) * per + j)
    return same_in, differ, [sorted(h) for h in held]


def _equal(a, b):
    return bool((a == b).all())


def _held_errors(got, want, held):
    """Max |diff| of each forward's logits over its held requests (0 where
    none is held), and over every request; rounded."""
    held_err = [round(_max_err(g[h], w[h]), 4) if h else 0.0 for g, w, h in zip(got, want, held)]
    return held_err, [round(_max_err(g, w), 4) for g, w in zip(got, want)]


def phase_lm_ep(torch, dev):
    """deepseek-v2-236b at published widths, 2 of its 60 layers (a layer's
    160 experts are ~7.5 GB of bfloat16), served on meshes of the card:
    4 prompts of 2,048 tokens, then 8 decode steps.  (1, 2): each model
    rank holds 80 experts; held against the one-device run (``mesh=None``,
    greedy; the mesh's steps fed its tokens): routing is equal wherever the
    layer's input is (the first layer's everywhere; the ranks' partial
    outputs are summed in bfloat16, as the reference's psum sums them, so a
    later layer's input can differ by a rounding, and a near-tied expert
    or a capacity boundary can then go the other way), at most
    ``MESH_EP_MAX_LEFT_OUT`` of the 36 (request, forward) pairs route
    otherwise, and the logits of every other one (its last position went
    to the same experts and kept the same assignments in every layer) are
    within 5e-2.  (2, 2): each
    data shard (2 requests) routes at its own capacity; held the same way
    against the same mesh's plain-version path (``_plain_kernels``); drops
    counted.  Every dispatch reads the one stacked copy of the experts
    (views: no copy per rank).  Returns the launches of each run."""
    from repro_torch.configs import get_config
    from repro_torch.core import compat
    from repro_torch.models.model import init_params

    import numpy as np

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=MESH_EP_LAYERS)
    tag = f"lm deepseek-v2 ep ({MESH_EP_LAYERS} of 60 layers)"
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    experts = {params["blocks"]["moe"][k].untyped_storage().data_ptr() for k in ("w_gate", "w_up", "w_down")}
    tokens = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
                             device=dev)
    mesh = {s: compat.make_mesh(s, ("data", "model"), devices=(dev,) * (s[0] * s[1])) for s in ((1, 2), (2, 2))}
    _serve_on_mesh(torch, params, cfg, tokens, None, 1)  # a warm-up: first-call costs
    torch.cuda.reset_peak_memory_stats(dev)
    one = _serve_on_mesh(torch, params, cfg, tokens, None, MESH_EP_STEPS)
    peak_one = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    with _ExpertStorage() as storage:
        ep12 = _serve_on_mesh(torch, params, cfg, tokens, mesh[(1, 2)], MESH_EP_STEPS, teacher=one["fed"])
        ep22 = _serve_on_mesh(torch, params, cfg, tokens, mesh[(2, 2)], MESH_EP_STEPS)
    peak_mesh = torch.cuda.max_memory_allocated(dev) / 2**30
    check(storage.ptrs == experts, f"{tag}: a dispatch read an expert copy ({len(storage.ptrs)} storages, "
          f"the stacked weights are {len(experts)})")
    with _plain_kernels():
        plain22 = _serve_on_mesh(torch, params, cfg, tokens, mesh[(2, 2)], MESH_EP_STEPS, teacher=ep22["fed"])
    check(sum(plain22["counts"].values()) == 0, f"{tag}: the plain path launched {plain22['counts']}")
    # (1, 2) against one device
    same, differ, held12 = _routing_held(ep12["routing"], one["routing"], LM_BATCH)
    first = one["routing"][0][0].shape[0]
    check(_equal(ep12["routing"][0][0], one["routing"][0][0]), f"{tag}: the first layer's inputs differ")
    err12, all12 = _held_errors(ep12["logits"], one["logits"], held12)
    pairs = LM_BATCH * (1 + MESH_EP_STEPS)
    left12 = pairs - sum(map(len, held12))
    check(left12 <= MESH_EP_MAX_LEFT_OUT, f"{tag}: (1, 2) routed {left12} of {pairs} (request, forward) "
          f"pairs otherwise than one device (at most {MESH_EP_MAX_LEFT_OUT}): held {held12}")
    check(max(err12) <= LM_LOGITS_ATOL,
          f"{tag}: (1, 2) logits vs one device over the requests routed alike {err12} (held {held12}; "
          f"every request {all12}) > 5e-2")
    # (2, 2) against its plain path
    _, _, held22 = _routing_held(ep22["routing"], plain22["routing"], LM_BATCH, dp=2, inputs_equal=False)
    err22, all22 = _held_errors(ep22["logits"], plain22["logits"], held22)
    left22 = pairs - sum(map(len, held22))
    check(left22 <= MESH_EP_MAX_LEFT_OUT, f"{tag}: (2, 2) routed {left22} of {pairs} (request, forward) "
          f"pairs otherwise than its plain path (at most {MESH_EP_MAX_LEFT_OUT}): held {held22}")
    check(max(err22) <= LM_LOGITS_ATOL,
          f"{tag}: (2, 2) logits vs the plain path over the requests routed alike {err22} (held {held22}; "
          f"every request {all22}) > 5e-2")
    counts = {name: {k: r["counts"][k] for k in ("flash_attention_kernel", "ssd_intra")}
              for name, r in (("mesh=None", one), ("(1, 2)", ep12), ("(2, 2)", ep22))}
    check(all(c["flash_attention_kernel"] == MESH_EP_LAYERS for c in counts.values()),
          f"{tag}: prefill launches {counts}")
    # MLA's D = 192 on the tensor cores (bfloat16 activations)
    routes = {name: r["routes"] for name, r in (("mesh=None", one), ("(1, 2)", ep12), ("(2, 2)", ep22))}
    check(all(r == {"wgmma": MESH_EP_LAYERS, "cuda_cores": 0} for r in routes.values()),
          f"{tag}: prefill flash-attention routes {routes}")
    log(f"{tag}: prefill {LM_BATCH} x {LM_PROMPT} tokens + {MESH_EP_STEPS} decode steps on one device "
        f"{one['seconds'][0]:.3f} + {one['seconds'][1]:.3f} s, (1, 2) {ep12['seconds'][0]:.3f} + "
        f"{ep12['seconds'][1]:.3f} s, (2, 2) {ep22['seconds'][0]:.3f} + {ep22['seconds'][1]:.3f} s; "
        f"peak {peak_one:.2f} GiB one device, {peak_mesh:.2f} GiB over both meshes (the experts read "
        f"from {len(storage.ptrs)} storages: no copy per rank); (1, 2) vs one device: the first layer's "
        f"{first} router inputs equal and routed alike, {same} rows of every call with equal inputs "
        f"routed alike, {differ} with inputs a bf16 rounding apart; logits max |diff| over the requests "
        f"routed alike (same experts, same kept assignments, every layer) {err12}, held {held12} "
        f"({left12} of {pairs} left out), over every request {all12}; drops {ep12['dropped']} vs "
        f"{one['dropped']}; (2, 2) vs its plain path: held {held22} ({left22} of {pairs} left out), "
        f"logits {err22}, every request {all22}; drops (capacity a data shard) {ep22['dropped']} vs "
        f"plain {plain22['dropped']}; prefill launches {counts}, flash-attention routes {routes}")
    return {k: v["flash_attention_kernel"] for k, v in counts.items()}


def phase_train_dp(torch, dev, arch="zamba2-2.7b"):
    """zamba2-2.7b at published widths, its first group (6 mamba layers and
    the shared block), trained data parallel on a (2, 1) mesh of the card:
    2 steps of 4 x 4,096 tokens (2 microbatches, each split over the 2
    data ranks), against the one-device step from the same weights on the
    same batch: each step's loss within 5e-2, the parameters within 5e-2
    relative L2 and the first moments (0.1 of the clipped gradient) within
    5e-2 relative L2 of the one-device step's (PR 25's LM bars); #6 and #7
    launched on each data rank's rows (forward + recompute), the gradient
    psum's bytes counted on the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.launch.train import make_mesh_for_devices
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=full.shared_attn_every)
    tag = f"train {arch} dp (its first group: {cfg.num_layers} mamba layers + the shared block)"
    batch = _train_batch(torch, dev, cfg.vocab_size)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=1), grad_accum=TRAIN_ACCUM)
    mesh = make_mesh_for_devices(devices=(dev,) * 2)
    runs = {}
    for name, m in (("one device", None), ("(2, 1)", mesh)):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        state, step = make_train_state(params, tcfg), make_train_step(cfg, tcfg, m)
        losses, secs, counts = [], [], None
        if m is not None:
            m.reset_collective_bytes()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (params, state, met), counts = _counted(lambda: step(params, state, batch))
            losses.append(float(met["loss"]))
            secs.append(time.perf_counter() - t0)
        runs[name] = dict(params=params, state=state, losses=losses, secs=secs,
                          counts={k: counts[k] for k in ("flash_attention_kernel", "ssd_intra")})
    one, dp = runs["one device"], runs["(2, 1)"]
    # a launch a unit's forward and one its recompute, a microbatch (a data
    # rank's rows of it, on the mesh)
    per_step = {"flash_attention_kernel": 2 * TRAIN_ACCUM, "ssd_intra": 2 * TRAIN_ACCUM * cfg.num_layers}
    for name, r in runs.items():
        want = {k: v * (mesh.size if name == "(2, 1)" else 1) for k, v in per_step.items()}
        check(r["counts"] == want, f"{tag}: {name} step launches {r['counts']}, expected {want}")
    dl = [abs(a - b) for a, b in zip(dp["losses"], one["losses"])]
    check(max(dl) <= LM_LOGITS_ATOL, f"{tag}: losses {dp['losses']} vs one device {one['losses']}")
    flat = lambda t: torch.cat([x.float().flatten() for x in _all_leaves(t)])  # noqa: E731
    p_err = _rel_l2(flat(dp["params"]), flat(one["params"]))
    moments = lambda s: torch.cat([v["m"].flatten() for v in _moments(s["opt"]["moments"])])  # noqa: E731
    m_err = _rel_l2(moments(dp["state"]), moments(one["state"]))
    check(p_err <= TRAIN_GRAD_REL and m_err <= TRAIN_GRAD_REL,
          f"{tag}: parameters {p_err}, first moments {m_err} relative L2 from the one-device step's")
    coll = collective_bytes(mesh)
    check(coll["bytes"]["all-reduce"] > 0, f"{tag}: no gradient psum was counted")
    log(f"{tag}: 2 steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens; losses (2, 1) {[round(v, 5) for v in dp['losses']]}, "
        f"one device {[round(v, 5) for v in one['losses']]}; step seconds (2, 1) "
        f"{[round(v, 3) for v in dp['secs']]}, one device {[round(v, 3) for v in one['secs']]}; parameters "
        f"{p_err:.3g}, first moments {m_err:.3g} relative L2 from the one-device step's; launches a step "
        f"{dp['counts']}; the mesh's collective bytes a rank {coll['bytes']}")
    return dp["counts"]


def _moments(tree):
    out = []
    for v in tree.values():
        out.extend([v] if set(v) == {"m", "v"} else _moments(v))
    return out


def phase_dryrun(torch, dev, tmp):
    """``launch/dryrun.py``: every cell derived on both production meshes
    (``meta`` devices), and one cell a family measured on the card at one
    layer period: granite-3-8b train_4k (dense), deepseek-v2-236b
    decode_32k (MoE), mamba2-1.3b prefill_32k (ssm), zamba2-2.7b long_500k
    (hybrid), hubert-xlarge prefill_32k (audio), internvl2-76b train_4k
    (vision).  Returns the launches of the measured cells."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    records = dryrun.main(["--out", str(tmp / "dryrun.json")])
    derive_s = time.perf_counter() - t0
    runnable = sum(ok for _, _, ok, _ in dryrun.enumerate_cells())
    check(len(records) == 2 * runnable and all(r["status"] == "ok" for r in records),
          f"dryrun: {len(records)} records for {runnable} cells on 2 meshes")
    measured, launches = {}, {}
    for arch, sname in (("granite-3-8b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
                        ("mamba2-1.3b", "prefill_32k"), ("zamba2-2.7b", "long_500k"),
                        ("hubert-xlarge", "prefill_32k"), ("internvl2-76b", "train_4k")):
        rec, counts = _counted(lambda: dryrun.measure_cell(arch, sname, device=dev))
        torch.cuda.empty_cache()
        check(rec["busy_ms"] > 0, f"dryrun {arch} {sname}: no device time")
        derived = next(r for r in records if (r["arch"], r["shape"], r["mesh"]) == (arch, sname, "16x16"))
        measured[f"{arch} {sname}"] = {
            "layers": rec["layers"], "batch": rec["batch"], "peak_gib": round(rec["peak_bytes"] / 2**30, 3),
            "wall_ms": round(rec["wall_ms"], 3), "busy_ms": round(rec["busy_ms"], 3),
            "by_kind_ms": {k: round(v, 3) for k, v in rec["device_ms_by_kind"].items()},
            "derived_bound_s_256": derived["derived"]["roofline"]["step_time_bound_s"],
            "derived_dominant_256": derived["derived"]["roofline"]["dominant"]}
        launches[f"{arch} {sname}"] = {k: counts[k] for k in ("flash_attention_kernel", "ssd_intra")}
    check(sum(c["flash_attention_kernel"] for c in launches.values()) > 0
          and sum(c["ssd_intra"] for c in launches.values()) > 0, f"dryrun: launches {launches}")
    log(f"dryrun: {len(records)} cell records derived in {derive_s:.2f} s (meta meshes of 256 and 512); "
        f"measured at one layer period on the card: {json.dumps(measured)}; launches {launches}")
    return launches


def phase_perf(torch, dev, tmp):
    """``launch/perf.py``: every variant's derived terms; the zamba2
    variants' training step at one group on the card (8,192 tokens), each
    knob set; the kimi-k2 variants derived only (their one-layer training
    state is past the card); the AnotherMe variants at N = 1,048,576, L =
    16 on 4 shards of the card.  Returns the launches of the measured
    variants."""
    from repro_torch.launch import perf

    records, counts = _counted(lambda: perf.main(["--out", str(tmp / "perf.json"), "--device", str(dev)]))
    torch.cuda.empty_cache()
    check(all(r["status"] == "ok" for r in records), f"perf: {[(r['name'], r['status']) for r in records]}")
    rows = {}
    for r in records:
        m = r.get("measured")
        roof = (r["derived"].get("roofline") or {})
        row = {"derived_bound_s": roof.get("step_time_bound_s"), "derived_dominant": roof.get("dominant")}
        if m:
            times = dict(wall_ms=round(m["wall_ms"], 3), busy_ms=round(m["busy_ms"], 3))
            if "overflow (join, pair route, scored)" in m:
                check(m["scored_pairs"] > 0, f"perf {r['name']}: no pair scored ({m})")
                overflow = m["overflow (join, pair route, scored)"]
                if m["capped"]:  # the plan's caps cut the work: not the variant's time
                    times = {f"capped_program_{k}": v for k, v in times.items()}
                row.update(overflow=overflow, collective_bytes=m["collective_bytes"], scored=m["scored_pairs"])
            row.update(times, peak_gib=round(m["peak_bytes"] / 2**30, 3))
        else:
            check("not_measured" in r and r["name"].startswith("kimi"), f"perf {r['name']}: not measured")
            row["not_measured"] = r["not_measured"]
        rows[r["name"]] = row
    launches = {k: counts[k] for k in ("flash_attention_kernel", "ssd_intra")}
    check(all(launches.values()), f"perf: launches {launches}")
    log(f"perf variants: {json.dumps(rows)}; launches {launches}")
    return launches


def phase_mesh(torch, dev, entries):
    """The mesh phases (27-30); logs each phase's seconds and adds to #6's
    and #7's entries their launches there (``launches_mesh``)."""
    seconds, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("lm deepseek-v2 ep", lambda: phase_lm_ep(torch, dev)),
                         ("train zamba2 dp", lambda: phase_train_dp(torch, dev)),
                         ("dryrun", lambda: phase_dryrun(torch, dev, Path(tmp))),
                         ("perf variants", lambda: phase_perf(torch, dev, Path(tmp)))):
            t0 = time.perf_counter()
            paths[name] = fn()
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    by_name = {e["name"]: e for e in entries}
    for name in ("flash_attention_kernel", "ssd_intra"):
        if name not in by_name:  # the mesh phases run alone
            by_name[name] = {"name": name}
            entries.append(by_name[name])
    ep = paths["lm deepseek-v2 ep"]
    by_name["flash_attention_kernel"]["launches_mesh"] = {
        **{f"lm deepseek-v2 ep prefill {k}": v for k, v in ep.items()},
        "train zamba2 dp step": paths["train zamba2 dp"]["flash_attention_kernel"],
        **{f"dryrun {k}": v["flash_attention_kernel"] for k, v in paths["dryrun"].items()},
        "perf variants": paths["perf variants"]["flash_attention_kernel"]}
    by_name["ssd_intra"]["launches_mesh"] = {
        "train zamba2 dp step": paths["train zamba2 dp"]["ssd_intra"],
        **{f"dryrun {k}": v["ssd_intra"] for k, v in paths["dryrun"].items()},
        "perf variants": paths["perf variants"]["ssd_intra"]}
    log(json.dumps({"mesh_phase_s": seconds}))
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
    figures = phase_build()
    phase_kernels(torch, dev)
    phase_windowed_kernel(torch, dev)
    phase_fig1(dev)
    phase_small(torch, dev)
    t0 = time.perf_counter()
    sharded_paths = {"sharded small": phase_sharded_small(torch, dev)}
    sharded_seconds = {"sharded small": time.perf_counter() - t0}
    main_res, main_counts, main_inputs, main_figures = phase_main(torch, dev)
    t0 = time.perf_counter()
    sharded_figures = {}
    sharded_paths["sharded"], sharded_figures["sharded"] = phase_sharded(torch, dev, main_res)
    sharded_seconds["sharded"] = time.perf_counter() - t0
    del main_res
    t0 = time.perf_counter()
    sharded_paths["sharded shuffle"], sharded_figures["sharded shuffle"] = \
        phase_sharded_shuffle(torch, dev)
    sharded_seconds["sharded shuffle"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    kernel_counts, kernel_routes, kernel_operands = phase_kernel_path(torch, dev)
    entries = phase_timing(torch, main_inputs, main_counts, main_figures, kernel_operands,
                           kernel_counts, kernel_routes, figures)
    codes, lengths = main_inputs[:2]
    main_types = (codes[:, 0, :].contiguous(), lengths)
    del main_inputs, kernel_operands, codes
    phase_subtraj_small(torch, dev)
    sub_counts, sub_coords, sub_types, sub_routes, sub_res = phase_subtraj(torch, dev)
    t0 = time.perf_counter()
    sharded_paths["sharded subtraj"], sharded_figures["sharded subtraj"] = \
        phase_sharded_subtraj(torch, dev, sub_res)
    sharded_seconds["sharded subtraj"] = time.perf_counter() - t0
    del sub_res
    torch.cuda.empty_cache()
    _, sub_kernel_routes, sub_kernel_operands = phase_subtraj_kernel_path(torch, dev)
    phase_timing_lcs_windows(torch, entries, sub_kernel_operands, sub_kernel_routes)
    del sub_kernel_operands
    shingle_counts = phase_shingle(torch, dev, main_types, sub_types)
    entries += phase_timing_windowed_and_shingle(
        torch, sub_coords, sub_counts, sub_routes, main_types, shingle_counts, figures
    )
    del sub_coords
    phase_minhash_kernel(torch, dev, main_types, sub_types)
    del main_types, sub_types
    phase_baselines_small(torch, dev)
    phase_accuracy(torch, dev)
    minhash_counts, minhash_types = phase_minhash_scale(torch, dev)
    entries += phase_timing_minhash(torch, minhash_types, minhash_counts)
    del minhash_types
    phase_brp_scale(torch, dev)
    phase_centralized_scale(torch, dev)
    small_launches, _ = phase_stream_small(torch, dev)
    stream, world, forest, stream_figures = phase_stream(torch, dev)
    serve_launches, serve_figures, _, serve_cases = phase_serve(torch, dev, stream, world)
    del stream
    device_small_launches, _ = phase_stream_device_small(torch, dev)
    dstream, device_figures = phase_stream_device(torch, dev, world, forest, stream_figures)
    serve_device_launches, serve_device_figures, _ = phase_serve_world(torch, dev, dstream,
                                                                       serve_cases, "serve device")
    del dstream
    torch.cuda.empty_cache()
    # the sharded streams and serving, held against the one-shard finals
    t0 = time.perf_counter()
    stream_sharded_paths = {"stream sharded small": phase_stream_sharded_small(torch, dev)[0]}
    sstream, sharded_stream_figures = phase_stream_sharded(torch, dev, world, forest, stream_figures)
    stream_sharded_paths["stream sharded"] = sharded_stream_figures["counts"]
    stream_sharded_paths["serve sharded"], serve_sharded_figures, _ = phase_serve_world(
        torch, dev, sstream, serve_cases, "serve sharded")
    del sstream
    dsstream, device_sharded_figures = phase_stream_device_sharded(torch, dev, world, forest,
                                                                   device_figures)
    stream_sharded_paths["stream device sharded"] = device_sharded_figures["counts"]
    stream_sharded_paths["serve device sharded"], serve_device_sharded_figures, _ = \
        phase_serve_world(torch, dev, dsstream, serve_cases, "serve device sharded")
    stream_sharded_s = time.perf_counter() - t0
    log(f"sharded streaming and serving: phases in {stream_sharded_s:.1f} s")
    del dsstream, world, serve_cases
    for key in ("final", "one_shot"):
        stream_figures.pop(key)
    device_figures.pop("final")
    torch.cuda.empty_cache()
    new_paths = {"stream small": small_launches, "stream": stream_figures["counts"],
                 "stream kernel/jit": stream_figures["kernel_counts"]["kernel"],
                 "stream fused/unionfind": stream_figures["kernel_counts"]["fused"],
                 "serve": serve_launches, "stream device small": device_small_launches,
                 "stream device": device_figures["counts"], "serve device": serve_device_launches,
                 **stream_sharded_paths}
    for name in ("fused_gather_score", "lcs_kernel", "minhash_kernel"):
        check(sum(c.get(name, 0) for c in stream_sharded_paths.values()) > 0,
              f"kernel {name} was launched on no sharded streaming or serving path")
    for e in entries:
        if e["name"] in ("fused_gather_score", "lcs_kernel", "minhash_kernel"):
            e["launches_streaming_serving"] = {path: c.get(e["name"], 0) for path, c in new_paths.items()}
        if e["name"] in ("fused_gather_score", "lcs_kernel", "fused_windowed_gather_score",
                         "minhash_kernel"):
            e["launches_sharded"] = {path: c.get(e["name"], 0) for path, c in sharded_paths.items()}
    for name in ("fused_gather_score", "lcs_kernel", "fused_windowed_gather_score", "minhash_kernel"):
        check(sum(c[name] for c in sharded_paths.values()) > 0,
              f"kernel {name} was launched on no sharded path")
    log(json.dumps({"sharded": sharded_figures, "sharded_phase_s": sharded_seconds}))
    log(json.dumps({"stream_updates": stream_figures["updates"], "serve": serve_figures,
                    "stream_device_updates": device_figures["updates"],
                    "serve_device": serve_device_figures}))
    log(json.dumps({"stream_sharded_updates": sharded_stream_figures["updates"],
                    "stream_sharded_peak_gib": sharded_stream_figures["peak_gib"],
                    "stream_device_sharded_updates": device_sharded_figures["updates"],
                    "stream_device_sharded": {k: device_sharded_figures[k] for k in (
                        "peak_gib", "mirror_s", "join_program_s", "stack_ms", "stack_bytes",
                        "feed_s")},
                    "serve_sharded": serve_sharded_figures,
                    "serve_device_sharded": serve_device_sharded_figures,
                    "stream_sharded_phases_s": stream_sharded_s}))
    # tuning and autotune=True, the GeoLife world, SSH corpus dedup and the
    # examples: #1, #2 (both routes) and #5 on new paths
    tuning_paths, tuning_seconds = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        tuning_seconds[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tuning_paths["tune"] = timed("tune", lambda: phase_tune(torch, dev, Path(tmp)))
        tuning_paths["autotune"] = timed("autotune", lambda: phase_autotune(torch, dev, Path(tmp)))
    torch.cuda.empty_cache()
    tuning_paths["geolife"], geolife_figures = timed("geolife", lambda: phase_geolife(torch, dev))
    torch.cuda.empty_cache()
    dedup_figures = timed("dedup", lambda: phase_dedup(torch, dev))
    timed("examples", lambda: phase_examples(dev))
    torch.cuda.empty_cache()
    for name in ("fused_gather_score", "lcs_kernel", "minhash_kernel"):
        check(sum(c.get(name, 0) for c in tuning_paths.values()) > 0,
              f"kernel {name} was launched on no tuning or GeoLife path")
    for e in entries:
        if e["name"] in ("fused_gather_score", "lcs_kernel", "minhash_kernel"):
            e["launches_tuning_geolife"] = {path: c.get(e["name"], 0)
                                            for path, c in tuning_paths.items()}
    log(json.dumps({"tuning_geolife_dedup_phase_s": tuning_seconds, "geolife": geolife_figures,
                    "dedup": dedup_figures}))
    entries += phase_lm(torch, dev, figures)
    torch.cuda.empty_cache()
    phase_train(torch, dev, entries)
    torch.cuda.empty_cache()
    phase_mesh(torch, dev, entries)
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
