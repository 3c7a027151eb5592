"""End-to-end training driver.

Port of ``repro/launch/train.py``: the config registry, the SSH-dedup
data pipeline, the data-parallel train step on a ``(n, 1)`` ``("data",
"model")`` mesh (grad accumulation, optional int8 error-feedback gradient
compression), async atomic checkpoints with resume (onto any mesh and
device: the reference's elastic reshard; checkpoints hold whole tensors)
and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced \\
        --steps 20 --ckpt-dir /tmp/ck --resume --device cpu

The reference's flags, plus ``--device`` (default: the CUDA cards, one
data rank each; with ``--device``, one rank there).  A caller may pass
``train`` its own mesh (``make_mesh_for_devices(devices=(card,) * n)``
runs n data ranks on one card).  The weights are drawn by the port's ``init_params`` (bfloat16, from
``--seed``), not the reference's draws.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import compat
from repro_torch.core.device import resolve_device
from repro_torch.data.tokens import TokenDataset, ssh_dedup, synthetic_corpus
from repro_torch.models.model import init_params, param_count
from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.straggler import StragglerWatchdog
from repro_torch.train.train_step import TrainConfig, make_train_state, make_train_step

TINY_100M = ModelConfig(
    name="tiny-100m", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32_000,
    attn="gqa",
)


def resolve_config(name: str, reduced: bool) -> ModelConfig:
    if name == "tiny-100m":
        return TINY_100M
    cfg = get_config(name)
    return cfg.reduced() if reduced else cfg


def make_mesh_for_devices(n: int | None = None, *, devices=None) -> compat.ShardMesh:
    """The reference's ``(n, 1)`` ``("data", "model")`` training mesh:
    over ``devices`` when given (repeats allowed), else over the first
    ``n`` CUDA devices (default: every one)."""
    if devices is not None:
        devices = tuple(devices)
        n = len(devices)
    else:
        n = n or torch.cuda.device_count()
    return compat.make_mesh((n, 1), ("data", "model"), devices=devices)


def train(args, mesh=None) -> dict:
    """Train ``args.steps`` steps (from the last checkpoint with
    ``--resume``) on ``mesh`` (default: :func:`make_mesh_for_devices`, or
    one rank on ``--device``); returns {"losses" (the steps run),
    "params", "state", "straggler_events"}."""
    cfg = resolve_config(args.arch, args.reduced)
    device = resolve_device(args.device)
    if mesh is None:
        mesh = make_mesh_for_devices(devices=(device,) if args.device is not None else None)
    print(f"arch={cfg.name} params={param_count(cfg)/1e6:.1f}M device={device} "
          f"data ranks={mesh.size}")

    # ----- data (with the paper's SSH dedup) ------------------------------
    corpus, _ = synthetic_corpus(
        args.num_docs, args.seq_len + 1, cfg.vocab_size,
        dup_fraction=args.dup_fraction, seed=args.seed,
    )
    if args.dedup == "ssh":
        keep, stats = ssh_dedup(corpus, vocab_size=cfg.vocab_size, device=device)
        print(f"ssh-dedup: {stats}")
        corpus = corpus[keep]
    ds = TokenDataset(corpus, global_batch=args.global_batch, seed=args.seed, device=device)

    # ----- state -----------------------------------------------------------
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=args.warmup),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
    )
    params = init_params(cfg, args.seed, device)
    state = make_train_state(params, tcfg)
    start_step = 0
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree = restore_checkpoint(args.ckpt_dir, last, {"params": params, "state": state},
                                      device=device)
            params, state = tree["params"], tree["state"]
            start_step = last
            print(f"resumed from step {last} (onto {device}, {mesh.size} data ranks)")

    step_fn = make_train_step(cfg, tcfg, mesh if mesh.size > 1 else None)
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StragglerWatchdog(
        threshold=args.straggler_threshold,
        on_event=lambda ev: print(
            f"[straggler] step={ev.step} host={ev.host} "
            f"{ev.duration*1e3:.0f}ms vs median {ev.median*1e3:.0f}ms"
        ),
    )

    losses = []
    for step in range(start_step, args.steps):
        batch = ds.batch(step)
        watchdog.step_start()
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])  # waits for the step
        flagged = watchdog.step_end(step)
        if flagged and ckpt is not None:
            ckpt.save(step + 1, {"params": params, "state": state})
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "state": state})
    if ckpt is not None:
        ckpt.save(args.steps, {"params": params, "state": state})
        ckpt.wait()
    return {"losses": losses, "params": params, "state": state,
            "straggler_events": len(watchdog.events)}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--num-docs", type=int, default=2048)
    ap.add_argument("--dup-fraction", type=float, default=0.2)
    ap.add_argument("--dedup", default="ssh", choices=["ssh", "none"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-threshold", type=float, default=8.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA cards)")
    return ap


if __name__ == "__main__":
    train(build_parser().parse_args())
