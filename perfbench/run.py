"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; the run sets up (weights and inputs made on the card from
the seed, the program's kernels loaded from ``build/kernels`` in the
checkout, every shape the traffic uses warmed), measures for ``--seconds``
(closing at the first completion at or after it), with ``--trace 1`` runs
a further stretch under ``torch.profiler``, compares what the timed path
produced with the plain reference (``perfbench/reference/``), and prints
one JSON object as the last line of standard output.  The compared numbers
and their limits are the last lines of standard error.

Exits 2, printing no result, without a CUDA device (or with fewer than the
cell asks for), and 3 if a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.bench import runner, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}")
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START, device="cuda:0", root=ROOT, log=log)
    found = runner.forbidden_modules()
    if found:
        log(f"the run loaded modules it must not: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
