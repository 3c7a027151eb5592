"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a few
hundred steps with the paper's SSH near-duplicate detection running in the
data pipeline (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py                 # 300 steps, on the card
    PYTHONPATH=src python examples/torch_train_lm.py --steps 50 --device cpu
"""
import os
import sys
import tempfile

from repro_torch.launch.train import build_parser, train


def main(argv=None):
    """Train with the defaults below overridden by ``argv``; returns
    ``train``'s result.  Exits if the loss did not fall."""
    argv = sys.argv[1:] if argv is None else list(argv)
    defaults = [
        "--arch", "tiny-100m", "--steps", "300", "--global-batch", "8",
        "--seq-len", "256", "--num-docs", "4096", "--dedup", "ssh",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"),
        "--ckpt-every", "100", "--log-every", "20",
    ]
    args = build_parser().parse_args(defaults + argv)
    out = train(args)
    losses = out["losses"]
    n = max(1, min(10, len(losses) // 2))
    print(f"\nfirst-{n} mean loss {sum(losses[:n])/n:.3f} -> "
          f"last-{n} mean loss {sum(losses[-n:])/n:.3f}")
    if not sum(losses[-n:]) < sum(losses[:n]):
        raise SystemExit("model did not learn")
    print("training improved the loss ✓")
    return out


if __name__ == "__main__":
    main()
