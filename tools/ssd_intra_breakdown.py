#!/usr/bin/env python3
"""Where the tensor-core SSD intra-chunk kernel's time goes, on one card.

    python3 tools/ssd_intra_breakdown.py

Compiles ``src/repro_torch/kernels/csrc/ssd_intra_sm90.cu`` as it is and in
variants with one part of its work cut out or done another way, into
``build/kernels/variants/``, and times each at zamba2-2.7b's prefill
operands (x [64, 128, 80, 64] bfloat16, N 64; CUDA events over 10 launches,
median of 20), beside the CUDA-core kernel on the same operands.  The cut
variants compute wrong numbers on purpose: they exist to be timed.

- ``kernel``: the source as it is (its error against the plain version is
  printed);
- ``branchy``: M formed under a branch around each entry's exp instead of
  a select after it;
- ``no_y``: no y (no M, no y products, no y stores);
- ``no_state``: no chunk states;
- ``no_store``: y and the states computed but not stored;
- ``kernel HG=h``: the source with h heads a block (the wrapper's choice is
  printed).

Needs nvcc and a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402

OUT = _build.BUILD_DIR / "variants"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"the kernel source changed: {old!r} not found; update this script")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    select = "  return keep ? m : 0.f;\n"
    branchy = _sub(_sub(src, "  float m;\n  if (BF) {", "  float m = 0.f;\n  if (!keep) {\n  } else if (BF) {"),
                   select, "  return m;\n")
    no_store = _sub(_sub(src, "    if (row >= p.Q) continue;", "    if (row >= 0) continue;"),
                    "    if (n >= p.N) continue;", "    if (n >= 0) continue;")
    return {
        "kernel": src,
        "branchy": branchy,
        "no_y": _sub(src, "    if (has_rows) {\n      const float* cum_h", "    if (false) {\n      const float* cum_h"),
        "no_state": _sub(src, "      head_state<NCP, BF>(x_st,", "      if (false) head_state<NCP, BF>(x_st,"),
        "no_store": no_store,
    }


def build(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    for cuh in _build.CSRC.glob("*.cuh"):
        (OUT / cuh.name).write_text(cuh.read_text())
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
                                        str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def time_ms(fn, reps=20, batch=10) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_intra_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(variants((_build.CSRC / "ssd_intra_sm90.cu").read_text()))
    BC, Q, H, P, N = 64, 128, 80, 64, 64
    rng = np.random.default_rng(0)
    dt = rng.uniform(1e-3, 1e-1, size=(BC, Q, H)).astype(np.float32)
    cum = np.cumsum(dt * -rng.uniform(1.0, 16.0, size=H).astype(np.float32), axis=1)
    x, B_, C_ = (rng.normal(size=s).astype(np.float32) for s in ((BC, Q, H, P), (BC, Q, N), (BC, Q, N)))
    on = lambda a, t=torch.float32: torch.as_tensor(a, device=dev).to(t)  # noqa: E731
    ops = (on(x, torch.bfloat16), on(cum), on(dt), on(B_, torch.bfloat16), on(C_, torch.bfloat16))
    y = torch.empty((BC, Q, H, P), device=dev)
    st = torch.empty((BC, H, P, N), device=dev)
    cd = torch.empty((BC, H), device=dev)
    fns = {}
    for name, lib in libs.items():
        fn = lib.ssd_intra_sm90_launch
        fn.argtypes, fn.restype = ssd.LAUNCHERS["wgmma"][2], ctypes.c_int
        fns[name] = fn

    def call(name, hg):
        err = fns[name](*(t.data_ptr() for t in ops), y.data_ptr(), st.data_ptr(), cd.data_ptr(),
                        BC, Q, H, P, N, hg, 0, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, f"ssd_intra_sm90 variant {name}")

    hg = ssd.heads_per_block(BC, H, P, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    call("kernel", hg)
    want = ssd.ssd_intra_plain(*ops)
    errs = [float((g.reshape(w.shape) - w).abs().max()) for g, w in zip((y, st, cd), want)]
    print(f"x {[BC, Q, H, P]} N={N}; the wrapper's heads a block: {hg}; kernel vs plain (y, state, "
          f"cdecay): {errs}", flush=True)
    for rnd in range(2):
        parts = [f"{name} {time_ms(lambda: call(name, hg)):.4f}" for name in fns]
        parts += [f"kernel HG={h} {time_ms(lambda: call('kernel', h)):.4f}" for h in (4, 5, 8, 10)]
        parts.append(f"CUDA-core kernel {time_ms(lambda: ssd.launch('cuda_cores', *ops)):.4f}")
        print(f"round {rnd} (ms): " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
