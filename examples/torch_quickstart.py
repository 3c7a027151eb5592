"""Quickstart on the PyTorch port: the full AnotherMe pipeline in ~30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

from repro_torch.api import AnotherMeEngine, EngineConfig
from repro_torch.core import (
    centralized_similar_pairs, encode_batch, forest_tables, maximal_cliques,
    qa1, qa2,
)
from repro_torch.data import synthetic_setup


def main(device=None):
    # 1. data: 2,000 synthetic trajectories over the paper's world
    #    (30 types x 10 classes x 10,000 places, lengths 5..10)
    batch, forest = synthetic_setup(2_000, seed=0, device=device)
    print(f"trajectories: {batch.num_trajectories}, "
          f"semantic forest sizes: {forest.sizes}")

    # 2. run AnotherMe: encode -> SSH join -> similarity -> communities.
    #    EngineConfig(backend=...) swaps the candidate join by name:
    #    "ssh" (the paper's lossless join), "minhash", "brp", "udf".
    engine = AnotherMeEngine(forest, EngineConfig(backend="ssh", rho=2.0), device=device)
    result = engine.run(batch)
    s = result.stats
    print(f"candidates from SSH join : {s['num_candidates']:>8d}")
    print(f"similar pairs (MSS > 2)  : {s['num_similar']:>8d}")
    print(f"communities of interest  : {s['num_communities']:>8d}")
    print(f"phase times: encode {s['t_encode']:.2f}s  "
          f"candidates {s['t_candidates']:.2f}s  score {s['t_score']:.2f}s")

    # 3. validate against the centralized ground truth on a subsample
    sub, _ = synthetic_setup(400, seed=0, device=device)
    res_small = engine.run(sub)
    enc = encode_batch(sub, forest_tables(forest, device=engine.device))
    cl, cr, _ = centralized_similar_pairs(enc, rho=2.0)
    cen = {(int(a), int(b)) for a, b in zip(cl, cr)}
    print(f"QA1 = {qa1(res_small.communities, maximal_cliques(cen)):.3f}  "
          f"QA2 = {qa2(res_small.similar_pairs, cen):.3f}  (paper: 1.000)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    main(ap.parse_args().device)
