"""Find Another Me on the PyTorch port — the paper's Fig. 1 scenario, end to end.

Carol lives in Sydney, Dave in Chicago; their trajectories never overlap
geographically, yet both are frequent flyers visiting
lodging -> airports -> company -> dining -> airports -> lodging.  The
pipeline must place them in the same community while keeping the
stay-at-home neighbour out.

    PYTHONPATH=src python examples/torch_find_another_me.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse

from repro_torch.api import AnotherMeEngine, EngineConfig
from repro_torch.core.encoding import encode_places, forest_tables
from repro_torch.data.fig1 import PEOPLE, fig1_world


def main(device=None):
    batch, forest = fig1_world(device=device)
    tables = forest_tables(forest, device=batch.device)
    for (who, traj), ids, length in zip(
        PEOPLE.items(), batch.places.tolist(), batch.lengths.tolist()
    ):
        print(f"{who}:")
        for p, enc in zip(traj, encode_places(ids[:length], tables)):
            print(f"    {enc:10s} {p}")

    engine = AnotherMeEngine(forest, EngineConfig(rho=3.0), device=batch.device)
    res = engine.run(batch)
    names = list(PEOPLE)
    print("\nsimilar pairs (MSS > 3):")
    for a, b in sorted(res.similar_pairs):
        print(f"    {names[a]}  <->  {names[b]}")
    print("communities of interest:")
    for c in res.communities:
        print("    {" + ", ".join(names[i] for i in sorted(c)) + "}")
    if (0, 1) not in res.similar_pairs:
        raise AssertionError("Carol should find her other me!")
    print("\nCarol found another her across the world ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    main(ap.parse_args().device)
