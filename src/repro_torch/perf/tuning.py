"""Cached autotune table for the LCS score stage.

Port of ``repro/perf/tuning.py``.  The score stage's free parameters — the
batched LCS kernel's block cap ``block_b`` and the plain wavefront's
anti-diagonal carry dtype (int8 vs int32) — are stored as measured winners
in a small JSON table keyed per ``(P, H, L, device kind)``, so the engine
can look them up instead of guessing.

Three rules keep the table safe to consult from the hot path:

1. **Eager resolution only.**  Lookups happen where a runner is built or a
   score call is dispatched (the engine, ``lcs_impl_fn``), exactly like
   ``similarity.wavefront_dtype_from_env``; a tuned value becomes a fixed
   launch argument, and the runner caches key on the resolved record.
2. **Bit-identical candidates only.**  ``block_b`` only changes the
   kernel's block and int8 and int32 diagonals agree for L < 127 (refused
   at record time otherwise), so the table can change throughput but never
   results; the sweep (``repro_torch.perf.tune``) checks every candidate
   bit for bit before it may win.
3. **Environment pins win.**  An explicit ``REPRO_LCS_DTYPE`` pin overrides
   the tuned dtype.

Keys quantize ``P`` (the pair-buffer size) to its ceiling power of two, the
capacity planner's padding granularity.  Misses fall back to the nearest
recorded ``P`` for the same ``(H, L, device kind)``, then to ``None``
(callers keep their defaults).

What differs from the JAX table: the header records the torch version and
the device kind (``"cpu"``, or ``torch.cuda.get_device_name`` of the card)
where the JAX table records the jax version and backend; the schema string
is this package's own; and the default file is ``<repo>/TUNING_torch.json``
(``$REPRO_TORCH_TUNING_PATH`` overrides it), so neither package reads or
rewrites the other's table.  ``load`` returns an EMPTY table on any
mismatch, so a table tuned on one card is never read on the CPU or on
another kind of card.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from pathlib import Path

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.similarity import wavefront_dtype_from_env

SCHEMA = "repro-torch-tuning/v1"

# default on-disk location; override with REPRO_TORCH_TUNING_PATH
DEFAULT_PATH = Path(__file__).resolve().parents[3] / "TUNING_torch.json"

_ENV_PATH = "REPRO_TORCH_TUNING_PATH"

_DTYPES = ("int8", "int32")


def tuning_path() -> Path:
    """The table location: $REPRO_TORCH_TUNING_PATH or <repo-root>/TUNING_torch.json."""
    override = os.environ.get(_ENV_PATH)
    return Path(override) if override else DEFAULT_PATH


def device_kind(device=None) -> str:
    """The kind of device a table is tuned for: ``"cpu"``, or the card's
    name (``torch.cuda.get_device_name``); ``None`` is the card."""
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def quantize_pairs(pairs: int) -> int:
    """Ceiling power of two — the planner's buffer-padding granularity."""
    p = 1
    while p < max(1, pairs):
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class LCSTuning:
    """Measured winner for one (P, H, L, device kind) cell.

    ``block_b``           cap on the threads per block of the LCS kernel's
                          shared route (``kernels/lcs/ops.lcs``).
    ``wavefront_dtype``   "int8" | "int32" diagonal carry for the plain
                          wavefront (overridden by REPRO_LCS_DTYPE).
    ``pairs_per_sec``     throughput of the winner when measured — carried
                          for the report, not consulted at dispatch time.
    """

    block_b: int
    wavefront_dtype: str
    pairs_per_sec: float = 0.0

    def __post_init__(self):
        if self.block_b < 1 or (self.block_b & (self.block_b - 1)):
            raise ValueError(f"block_b must be a power of two, got {self.block_b}")
        if self.wavefront_dtype not in _DTYPES:
            raise ValueError(
                f"wavefront_dtype must be one of {_DTYPES}, "
                f"got {self.wavefront_dtype!r}"
            )


def _key(pairs: int, levels: int, length: int, kind: str) -> str:
    return f"P{quantize_pairs(pairs)}-H{levels}-L{length}-{kind}"


class TuningTable:
    """In-memory view of the JSON tuning table for one device kind.

    ``device`` (``None``: the card) fixes the kind the table's cells are
    recorded and looked up under, and the kind its header must name.  Load
    with :meth:`load` (an EMPTY table on any mismatch — missing file,
    schema, torch version or device kind — so a stale table degrades to
    untuned defaults), mutate with :meth:`record`, persist with
    :meth:`save`.
    """

    def __init__(self, entries: dict[str, LCSTuning] | None = None, *, device=None):
        self.kind = device_kind(device)
        self.entries: dict[str, LCSTuning] = dict(entries or {})

    # -- persistence ------------------------------------------------------

    @classmethod
    def load(cls, path: Path | str | None = None, *, device=None) -> "TuningTable":
        table = cls(device=device)
        path = Path(path) if path else tuning_path()
        try:
            raw = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return table
        if (
            raw.get("schema") != SCHEMA
            or raw.get("torch_version") != torch.__version__
            or raw.get("device_kind") != table.kind
        ):
            return table
        for key, val in raw.get("entries", {}).items():
            try:
                table.entries[key] = LCSTuning(**val)
            except (TypeError, ValueError):
                return cls(device=device)  # corrupt cell -> whole table untrusted
        return table

    def save(self, path: Path | str | None = None) -> Path:
        path = Path(path) if path else tuning_path()
        payload = {
            "schema": SCHEMA,
            "torch_version": torch.__version__,
            "device_kind": self.kind,
            "entries": {
                key: dataclasses.asdict(t) for key, t in sorted(self.entries.items())
            },
        }
        # write-then-rename: a reader sees the old table or the new one,
        # and every save gives the file a new inode (see cached_table)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    # -- access -----------------------------------------------------------

    def record(self, pairs: int, levels: int, length: int, tuning: LCSTuning) -> None:
        if length >= 127 and tuning.wavefront_dtype == "int8":
            # int8 diagonals saturate at 127; the sweep must never record a
            # dtype that could diverge from int32 results
            raise ValueError(f"int8 diagonals unsafe at L={length} (>= 127)")
        self.entries[_key(pairs, levels, length, self.kind)] = tuning

    def lookup(self, pairs: int, levels: int, length: int) -> LCSTuning | None:
        """Exact (quantized-P) hit, else nearest recorded P for the same
        (H, L, device kind), else None (caller keeps its defaults)."""
        hit = self.entries.get(_key(pairs, levels, length, self.kind))
        if hit is not None:
            return hit
        want_p = quantize_pairs(pairs)
        suffix = f"-H{levels}-L{length}-{self.kind}"
        best, best_dist = None, None
        for key, t in self.entries.items():
            if not (key.startswith("P") and key.endswith(suffix)):
                continue
            have_p = int(key[1 : len(key) - len(suffix)].split("-")[0])
            dist = abs(have_p.bit_length() - want_p.bit_length())
            if best_dist is None or dist < best_dist:
                best, best_dist = t, dist
        return best


def cached_table(device=None) -> TuningTable:
    """The table at :func:`tuning_path` for ``device``'s kind, parsed once
    per version of the file: it is read again only when the file's inode,
    mtime or size changes (every :meth:`TuningTable.save` replaces the
    file), so a score call or a runner lookup costs one ``stat``.  The
    returned table is shared; treat it as read-only."""
    path = tuning_path()
    try:
        st = path.stat()
        stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    return _load_stamped(str(path), stamp, resolve_device(device))


@functools.lru_cache(maxsize=16)
def _load_stamped(path: str, stamp, device) -> TuningTable:
    return TuningTable.load(path, device=device)


def resolve_wavefront_dtype(tuning: LCSTuning | None) -> torch.dtype:
    """The dtype the wavefront should actually run with.

    Precedence: explicit REPRO_LCS_DTYPE env pin (reproducibility) > tuned
    dtype (performance) > the env-probe default.
    """
    if os.environ.get("REPRO_LCS_DTYPE"):
        return wavefront_dtype_from_env()
    if tuning is not None:
        return torch.int32 if tuning.wavefront_dtype == "int32" else torch.int8
    return wavefront_dtype_from_env()
