"""Serving CLI: batched prefill + greedy decode on an arch config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --device cpu

The flags of ``repro/launch/serve.py``, plus ``--device`` (default: the
CUDA card) and ``--mesh DATAxMODEL`` (default: none, one device): the
reference serves on its ``(1, 1)`` smoke mesh; with ``--mesh 2x2`` the
MoE layers run expert-parallel over four ranks on ``--device``
(``models/moe.py``).  As in the reference, ``--reduced`` is a ``store_true`` flag
that defaults to true, so the CLI always serves the reduced config; a full-
width config is served through ``prefill_with_cache`` and
``make_decode_step`` directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import compat
from repro_torch.core.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve.kvcache import cache_bytes
from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache


def main(argv=None) -> np.ndarray:
    """Serve ``--batch`` random prompts; prints and returns the generated
    tokens, int [batch, gen_len]."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL ranks, all on --device (default: one device, no mesh)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "none":
        cfg = dataclasses.replace(cfg, frontend="none")
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        mesh = compat.make_mesh(shape, ("data", "model"), devices=(device,) * math.prod(shape))
    params = init_params(cfg, args.seed, device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)), device=device
    )
    print(f"{cfg.name}: cache {cache_bytes(cfg, args.batch, args.max_len) / 1e6:.2f} MB")
    with torch.inference_mode():
        logits, cache = prefill_with_cache(params, prompts, cfg, args.max_len, mesh=mesh)
        tok = logits[:, -1:, : cfg.vocab_size].argmax(dim=-1)
        step = make_decode_step(cfg, mesh)
        out = [tok]
        for _ in range(args.gen_len - 1):
            logits, cache = step(params, cache, tok)
            tok = logits[:, :, : cfg.vocab_size].argmax(dim=-1)
            out.append(tok)
    gen = torch.cat(out, dim=1).cpu().numpy()
    for b in range(args.batch):
        print(f"  seq {b}: {gen[b].tolist()}")
    return gen


if __name__ == "__main__":
    main()
