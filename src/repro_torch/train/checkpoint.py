"""Fault-tolerant checkpointing: atomic manifests, async writes, elastic
resume.

Port of ``repro/train/checkpoint.py``, with its on-disk format, so that
checkpoints interchange between the two packages:

    <dir>/step_<N:010d>/
        arrays/<flat.key.path>.npy     one file per leaf
        MANIFEST.json                  written LAST -> atomicity marker

* A checkpoint is valid iff MANIFEST.json exists; a crash mid-write leaves
  a ``.tmp_step_*`` directory and no manifest, and the next save deletes
  it.  The last ``keep`` steps are kept.
* Keys are the tree's paths joined by ".", dict keys sorted.  bfloat16
  leaves are stored as float32 (which holds every bfloat16 exactly) with
  ``"bfloat16"`` as the manifest's dtype, and restore casts back to the
  template's dtype; numpy needs no bfloat16 type for either.
* Arrays are stored whole, so a restore can place every leaf on any device
  (``device=``): the elastic path of a one-device port.
* :class:`AsyncCheckpointer` copies the tree to host memory synchronously
  and writes the files on a background thread, overlapping the I/O with
  the next step; ``wait()`` joins it.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch


def _is_seq(node) -> bool:
    # a named tuple (``ShapeDtype``) is a leaf
    return isinstance(node, (list, tuple)) and not hasattr(node, "_fields")


def _flatten_with_paths(tree) -> dict[str, Any]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_seq(node):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat[".".join(path)] = node

    walk(tree, ())
    return flat


def _unflatten_like(template, flat: dict[str, Any]):
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in node}
        if _is_seq(node):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        return flat[".".join(path)]

    return walk(template, ())


def _to_host(val) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, the manifest's dtype name)."""
    if isinstance(val, torch.Tensor):
        name = str(val.dtype).removeprefix("torch.")
        t = val.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # every bfloat16 is exact in float32
        # a copy: the train step updates its tensors in place while an
        # asynchronous write may still be reading this one
        return t.to("cpu", copy=True).numpy(), name
    arr = np.array(val)
    return arr, str(arr.dtype)


def _write(step_dir_parent: pathlib.Path, step: int, host: dict, keep: int) -> pathlib.Path:
    step_dir = step_dir_parent / f"step_{step:010d}"
    tmp = step_dir_parent / f".tmp_step_{step:010d}_{int(time.time() * 1e6)}"
    arrays = tmp / "arrays"
    arrays.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, (arr, dtype_name) in host.items():
        np.save(arrays / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype_name}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp.rename(step_dir)
    _gc(step_dir_parent, keep)
    return step_dir


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3) -> pathlib.Path:
    """Synchronous atomic save of a tree of tensors (or arrays).  Returns
    the checkpoint's path."""
    host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}
    return _write(pathlib.Path(ckpt_dir), step, host, keep)


def _gc(ckpt_dir: pathlib.Path, keep: int):
    # drop orphaned temp dirs (crashed writes) and old steps
    for p in ckpt_dir.glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)
    steps = sorted(ckpt_dir.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    """The newest step with a manifest, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best = None
    for p in sorted(ckpt_dir.glob("step_*")):
        if (p / "MANIFEST.json").exists():
            best = int(p.name.split("_")[1])
    return best


def restore_checkpoint(ckpt_dir, step: int, template, device=None):
    """Restore into the structure of ``template`` (a tree of tensors or
    ``ShapeDtype``): each leaf a tensor of its template's shape and dtype,
    on ``device`` (None: the template leaf's device, the CPU for a
    ``ShapeDtype``).  Raises on a missing leaf or a shape mismatch."""
    step_dir = pathlib.Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    flat_t = _flatten_with_paths(template)
    missing = set(flat_t) - set(manifest["leaves"])
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    out = {}
    for key, want in flat_t.items():
        arr = np.load(step_dir / "arrays" / f"{key}.npy")
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(want.shape)}")
        where = device if device is not None else getattr(want, "device", "cpu")
        t = torch.from_numpy(np.array(arr, order="C"))  # 0-d stays 0-d
        out[key] = t.to(device=where, dtype=want.dtype)
    return _unflatten_like(template, out)


class AsyncCheckpointer:
    """Copy to host synchronously, write the files on a background thread."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree):
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, host, self.keep), daemon=True,
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
