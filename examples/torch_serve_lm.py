"""Serving example on the PyTorch port: batched prefill + greedy decode with
per-family caches (GQA KV / MLA latent / SSM state), on reduced configs of
four assigned architectures.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve.kvcache import cache_bytes
from repro_torch.serve.serve_step import make_decode_step, prefill_with_cache


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, device, *, batch=4, prompt_len=12, gen_len=16, max_len=64):
    cfg = get_config(arch).reduced()
    if cfg.frontend != "none":
        cfg = dataclasses.replace(cfg, frontend="none")
    params = init_params(cfg, 0, device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill_with_cache(params, prompts, cfg, max_len)
        next_tok = logits[:, -1:, : cfg.vocab_size].argmax(dim=-1)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        dstep = make_decode_step(cfg)
        out_tokens = [next_tok]
        t0 = time.perf_counter()
        for _ in range(gen_len - 1):
            logits, cache = dstep(params, cache, next_tok)
            next_tok = logits[:, :, : cfg.vocab_size].argmax(dim=-1)
            out_tokens.append(next_tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"{arch:22s} family={cfg.family:7s} "
          f"cache={cache_bytes(cfg, batch, max_len)/1e6:7.2f}MB  "
          f"prefill={t_prefill*1e3:7.1f}ms  "
          f"decode={t_decode/max(gen_len-1,1)*1e3:6.1f}ms/tok  "
          f"sample={gen[0, :8].tolist()}")
    assert gen.shape == (batch, gen_len)
    assert (gen >= 0).all() and (gen < cfg.vocab_size).all()


def main(device=None):
    device = resolve_device(device)
    print("batched serving across cache families (reduced configs):")
    for arch in ("granite-3-8b", "deepseek-v2-236b", "mamba2-1.3b",
                 "zamba2-2.7b"):
        serve(arch, device)
    print("all families served ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    main(ap.parse_args().device)
