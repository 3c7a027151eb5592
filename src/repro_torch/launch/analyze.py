"""Analytics CLI: run AnotherMe over synthetic or GeoLife-surrogate
trajectories and report the communities and the phase timings.

    PYTHONPATH=src python -m repro_torch.launch.analyze --n 5000
    PYTHONPATH=src python -m repro_torch.launch.analyze --dataset geolife --device cpu

The flags of ``repro/launch/analyze.py``, plus ``--device`` (default: the
CUDA card).
"""
from __future__ import annotations

import argparse

from repro_torch.core import AnotherMeConfig, run_anotherme
from repro_torch.data import geolife_surrogate, synthetic_setup


def main(argv=None):
    """Run the pipeline and print its stats; returns the result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic", "geolife"])
    ap.add_argument("--n", type=int, default=5_000)
    ap.add_argument("--num-types", type=int, default=30)
    ap.add_argument("--rho", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--communities", default="cliques", choices=["cliques", "components"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.dataset == "geolife":
        batch, forest = geolife_surrogate(seed=args.seed, device=args.device)
    else:
        batch, forest = synthetic_setup(args.n, num_types=args.num_types, seed=args.seed,
                                        device=args.device)
    cfg = AnotherMeConfig(k=args.k, rho=args.rho, community_mode=args.communities)
    res = run_anotherme(batch, forest, cfg)
    print(f"trajectories          : {batch.num_trajectories}")
    for key, val in res.stats.items():
        if isinstance(val, float):
            print(f"{key:22s}: {val:.3f}")
        else:
            print(f"{key:22s}: {val}")
    sizes = sorted((len(c) for c in res.communities), reverse=True)[:10]
    print(f"largest communities   : {sizes}")
    return res


if __name__ == "__main__":
    main()
