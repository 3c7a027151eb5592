"""Readings that set a cell's limits: the program's compared numbers and
the control's, seed by seed, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--program] [--control] [--faults]

``--program`` runs the cell as a run does, with a window of no length
(it closes at the first completion past the checked batches or steps),
and prints its compared numbers; ``--control`` puts the reference in fp8
in the program's place and prints the same numbers against the float32
reference; ``--faults`` (training cells) plants the
faults the limits are held against in the reference.  One JSON line a
seed and reading.  The benchmark's runs do not run this; it is run on the
card when a cell or a limit is set, and its readings are kept in PERF.md.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    device = "cuda:0"

    import torch

    from perfbench.bench import runner, spec

    def emit(**rec):
        print(json.dumps(rec), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            t0 = time.perf_counter()
            res = runner.run_cell(args.workload, seed, 0.0, False, t_start=t0, device=device,
                                  root=ROOT, log=lambda m: print(m, file=sys.stderr, flush=True))
            emit(seed=seed, reading="program", correct=res["correct"],
                 numbers={k: v["value"] for k, v in res["checks"].items()},
                 seconds=time.perf_counter() - t0)
        if args.control or args.faults:
            cell = spec.load_cell(args.workload, ROOT)
            run = runner.Run(cell=cell, seed=seed, device=torch.device(device),
                             reference=spec.reference(ROOT, cell.config["reference"]))
            drv = spec.driver(ROOT, cell.kind).Driver(run)
            if args.control:
                t0 = time.perf_counter()
                emit(seed=seed, reading="control fp8", numbers=drv.control("fp8"),
                     seconds=time.perf_counter() - t0)
            if args.faults and hasattr(drv, "fault_half_batch"):
                t0 = time.perf_counter()
                emit(seed=seed, reading="fault: half of the batch left out", numbers=drv.fault_half_batch(),
                     seconds=time.perf_counter() - t0)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
