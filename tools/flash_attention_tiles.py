#!/usr/bin/env python3
"""Key tiles of the tensor-core flash-attention kernel past head dim 128, on
one card.

    python3 tools/flash_attention_tiles.py [--parent DIR]

Compiles ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu`` as it is
and with other entries in its Tile table for D 144-192 (3 chunks of 64
columns) and D 208-256 (4 chunks), into ``build/kernels/tiles/``, one nvcc
each, in parallel, and prints each build's ptxas registers, spill bytes and
any wgmma serialization warning by instantiation (``KS,NS,NC``).  Each
candidate is first held against the plain version at edge shapes (S
1/65/1000, GQA 1 and 4, causal and not, 3e-2); then it is timed at
deepseek-v2-236b's prefill operands (q/k/v [4, 2048, 128, 192] bfloat16,
v zero past column 128, causal) or at the same shape with D 256, the launch
alone (CUDA events over 10 launches, median of 10), in two rounds (the
second in the reverse order), beside
the CUDA-core kernel (``flash_attention.cu``) and
``scaled_dot_product_attention`` on the same operands.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked with
``git archive`` into a gitignored directory) it also builds that commit's
``flash_attention_sm90.cu`` and times it against this one, in turns
(parent, this, this, parent), at the D <= 128 rows of ``chip_smoke.py``'s
timing phase (zamba2-2.7b, granite-3-8b, minicpm3-4b, kimi-k2's and
hubert-xlarge's heads, prefill_32k's length), and prints both builds' ptxas
figures side by side.  The last line is every number as one JSON object
(also written to ``chiprun_out/flash_attention_tiles.json``).  Needs nvcc
and a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import _ptxas_by_kernel, _time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn  # noqa: E402

OUT = _build.BUILD_DIR / "tiles"
SOURCE = "flash_attention_sm90"
BF16_TENSOR_FLOPS = 989e12
# (keys, stages) for 3 chunks (D 144-192) and 4 chunks (D 208-256); the
# first is the source as it is
CANDIDATES = {
    3: [(64, 3), (64, 2), (80, 2), (96, 2), (112, 2)],
    4: [(64, 2), (80, 2)],
}
# chip_smoke.py's D <= 128 timing rows: (what, B, S, H, KH, D, causal)
ROWS_128 = [("zamba2-2.7b", 4, 2048, 32, 32, 80, True), ("granite-3-8b", 4, 2048, 32, 8, 128, True),
            ("minicpm3-4b", 4, 2048, 40, 40, 96, True), ("kimi-k2 heads", 4, 2048, 64, 8, 112, True),
            ("hubert heads", 4, 2048, 16, 16, 80, False), ("prefill_32k", 1, 32768, 32, 8, 128, True)]


def with_tile(src: str, nc: int, bk: int, ns: int) -> str:
    """The source with Tile<nc> set to (bk, ns)."""
    pat = re.compile(r"(struct Tile<%d> \{\s*static constexpr int BK = )\d+, NS = \d+;" % nc)
    if not pat.search(src):
        raise SystemExit(f"the kernel source changed: Tile<{nc}> not found; update this script")
    return pat.sub(lambda m: f"{m.group(1)}{bk}, NS = {ns};", src)


def tile_of(src: str, nc: int) -> tuple[int, int]:
    m = re.search(r"struct Tile<%d> \{\s*static constexpr int BK = (\d+), NS = (\d+);" % nc, src)
    return int(m.group(1)), int(m.group(2))


def build(variants: dict[str, tuple[str, Path]]) -> tuple[dict[str, ctypes.CDLL], dict[str, str]]:
    """{name: (source text, directory of its headers)} -> libraries and logs."""
    procs = {}
    t0 = time.perf_counter()
    for name, (text, headers) in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for cuh in headers.glob("*.cuh"):
            (d / cuh.name).write_text(cuh.read_text())
        (d / f"{SOURCE}.cu").write_text(text)
        procs[name] = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                        str(d / f"{SOURCE}.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        logs[name] = f"nvcc {name}: {time.perf_counter() - t0:.2f} s (from the common start)\n" + log
        if proc.returncode:  # a candidate that does not build is reported, not timed
            print(f"nvcc failed for {name}:\n{log[-3000:]}", flush=True)
            if name == "kernel":
                raise SystemExit("the kernel source does not build")
            continue
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs, logs


def launcher(lib):
    fn = lib.flash_attention_sm90_launch
    fn.argtypes, fn.restype = attn.LAUNCHERS["wgmma"][2], ctypes.c_int
    return fn


def call(fn, q, k, v, out, causal):
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KH, D,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_sm90 variant")
    return out


def time_ms(fn, reps=10, batch=10) -> float:
    """Median of ``reps`` CUDA-event timings of ``batch`` calls, a call."""
    return _time_ms(torch, fn, reps=reps, batch=batch)


def operands(dev, rng, B, Sq, Skv, H, KH, D, pad_v_from=None):
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev).to(torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    if pad_v_from is not None:
        v[..., pad_v_from:] = 0
    return q, k, v


def bound_ms(B, S, H, D, causal):
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return 4 * D * pairs / BF16_TENSOR_FLOPS * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of an earlier checkout whose flash_attention_sm90.cu is timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_tiles: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t_start = time.perf_counter()
    src = (_build.CSRC / f"{SOURCE}.cu").read_text()
    variants, tiles = {"kernel": (src, _build.CSRC)}, {}
    tiles["kernel"] = {3: tile_of(src, 3), 4: tile_of(src, 4)}
    for nc, cands in CANDIDATES.items():
        for bk, ns in cands:
            if (bk, ns) == tiles["kernel"][nc]:
                continue
            name = f"nc{nc}_bk{bk}_ns{ns}"
            variants[name] = (with_tile(src, nc, bk, ns), _build.CSRC)
            tiles[name] = {**tiles["kernel"], nc: (bk, ns)}
    if args.parent is not None:
        csrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc"
        variants["parent"] = ((csrc / f"{SOURCE}.cu").read_text(), csrc)
    libs, logs = build(variants)
    fns = {name: launcher(lib) for name, lib in libs.items()}
    result = dict(device=smi, tiles={k: {str(nc): v for nc, v in t.items()} for k, t in tiles.items()},
                  ptxas={}, build_s={}, errors={}, d192={}, d256={}, rows_128=[])
    for name, text in logs.items():
        result["ptxas"][name] = _ptxas_by_kernel(text)
        result["build_s"][name] = float(re.search(r": ([\d.]+) s", text.splitlines()[0]).group(1))
        print(f"ptxas {name} (KS,NS,NC: registers, spill-store bytes, serialized): "
              + "; ".join(f"{k} {v.get('registers')} {v.get('spill_store_bytes')}"
                          + (" SERIALIZED" if v.get("serialized") else "")
                          for k, v in sorted(result["ptxas"][name].items(),
                                             key=lambda kv: [int(x) for x in kv[0].split(",") if x.isdigit()]))
              + f"; built in {result['build_s'][name]:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    # edge shapes: every build at the head dims past 128
    for name, fn in fns.items():
        if name == "parent":
            continue
        worst = 0.0
        for D in (144, 192, 208, 256):
            for S in (1, 65, 1000):
                for rep in (1, 4):
                    q, k, v = operands(dev, rng, 2, S, S, 2 * rep, 2, D)
                    for causal in (True, False):
                        out = torch.empty_like(q)
                        got = call(fn, q, k, v, out, causal)
                        want = attn.flash_attention_plain(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        worst = max(worst, float((got.float() - want.float()).abs().max()))
        result["errors"][name] = worst
        print(f"{name}: edge shapes (D 144/192/208/256, S 1/65/1000, rep 1/4, causal and not) max |kernel - "
              f"plain| {worst:.4g}" + ("" if worst <= 3e-2 else "  > 3e-2: FAILS"), flush=True)

    for D, key in ((192, "d192"), (256, "d256")):
        B, S, H = 4, 2048, 128
        q, k, v = operands(dev, rng, B, S, S, H, H, D, pad_v_from=128 if D == 192 else None)
        out = torch.empty_like(q)
        want = attn.flash_attention_plain(q, k, v)
        bound = bound_ms(B, S, H, D, True)
        nc = D // 64
        names = [n for n in fns if n != "parent" and result["errors"][n] <= 3e-2
                 and (n == "kernel" or tiles[n][nc] != tiles["kernel"][nc])]
        rounds = []
        for order in (names, names[::-1]):  # in turns: no candidate always runs first
            rounds.append({n: time_ms(lambda n=n: call(fns[n], q, k, v, out, True)) for n in order})
        cc = time_ms(lambda: attn.launch("cuda_cores", q, k, v, causal=True), reps=3, batch=1)
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True))
        errs = {}
        for n in names:
            errs[n] = float((call(fns[n], q, k, v, out, True).float() - want.float()).abs().max())
        for n in names:
            ms = statistics.mean(r[n] for r in rounds)
            result[key][n] = dict(tile=tiles[n][nc], ms=ms, rounds=[r[n] for r in rounds],
                                  bound_share=bound / ms, max_abs_err=errs[n])
        result[key]["cuda_cores_ms"], result[key]["sdpa_ms"], result[key]["bound_ms"] = cc, sdpa, bound
        print(f"D={D} q/k/v [{B}, {S}, {H}, {D}] causal (bound {bound:.4f} ms by operations; the CUDA-core "
              f"kernel {cc:.3f} ms, sdpa {sdpa:.3f} ms): "
              + "; ".join(f"{n} (BK {tiles[n][nc][0]}, NS {tiles[n][nc][1]}) {result[key][n]['ms']:.4f} ms "
                          f"{result[key][n]['rounds']} = {result[key][n]['bound_share']:.1%} of bound, "
                          f"{cc / result[key][n]['ms']:.1f}x faster than the CUDA cores, "
                          f"{result[key][n]['ms'] / sdpa:.2f}x sdpa, err {errs[n]:.3g}" for n in names),
              flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()

    if "parent" in fns:
        for what, B, S, H, KH, D, causal in ROWS_128:
            q, k, v = operands(dev, rng, B, S, S, H, KH, D)
            out = torch.empty_like(q)
            turns = [time_ms(lambda n=n: call(fns[n], q, k, v, out, causal))
                     for n in ("parent", "kernel", "kernel", "parent")]
            got = call(fns["kernel"], q, k, v, torch.empty_like(q), causal)
            ref = call(fns["parent"], q, k, v, torch.empty_like(q), causal)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, ref))
            row = dict(what=what, shape=[B, S, H, KH, D], causal=causal, parent_ms=(turns[0] + turns[3]) / 2,
                       ms=(turns[1] + turns[2]) / 2, turns=turns, bit_equal_to_parent=same,
                       bound_ms=bound_ms(B, S, H, D, causal))
            result["rows_128"].append(row)
            print(f"D<=128 {what} q [{B}, {S}, {H}, {D}] kv heads {KH} causal={causal}: this "
                  f"{row['ms']:.4f} ms, parent {row['parent_ms']:.4f} ms (turns parent, this, this, parent "
                  f"{[round(t, 4) for t in turns]}; {row['ms'] / row['parent_ms']:.3f}x); outputs bit-equal "
                  f"{same}", flush=True)
            del q, k, v, out
        same_ptxas = {k: (v.get("registers"), v.get("spill_store_bytes"))
                      for k, v in result["ptxas"]["parent"].items()}
        this_ptxas = {k: (v.get("registers"), v.get("spill_store_bytes"))
                      for k, v in result["ptxas"]["kernel"].items() if k in same_ptxas}
        result["ptxas_d128_equal_to_parent"] = same_ptxas == this_ptxas
        print(f"ptxas at D <= 128 (KS,NS,NC: registers, spills): this {this_ptxas}, parent {same_ptxas}; "
              f"equal {same_ptxas == this_ptxas}", flush=True)
    result["seconds"] = time.perf_counter() - t_start
    line = json.dumps(result)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_attention_tiles.json").write_text(line + "\n")
    print(f"flash_attention_tiles: done in {result['seconds']:.1f} s; {smi}", flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
