"""Roofline terms for the dry-run and perf drivers, with the H100's rates.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference reads
FLOPs and bytes from XLA's ``cost_analysis()`` and parses collective bytes
out of the post-SPMD HLO text; the port has no compiler to ask.  Its
counts come from two places instead:

* derived from the configs and the port's own program
  (``launch/dryrun.py``: the analytic FLOPs of the layers the port runs,
  per-rank parameter, optimizer-state and cache bytes from the placements
  on a ``meta`` mesh, and the bytes each of the program's collectives
  hands the mesh);
* measured on the card (``torch.cuda.max_memory_allocated``, device time
  by kernel kind from ``torch.profiler``).

:func:`collective_bytes` is the counterpart of the reference's function of
that name: it reads a ``core.compat.ShardMesh``'s counters, which sum each
rank's operand bytes a collective kind, as the reference sums each
device's operand bytes, and gives them per device.

:class:`Roofline` is the reference's record, field for field, with the
peak rate, memory bandwidth and collective bandwidth as fields.  The
defaults are the H100 SXM's: dense bf16 989 TFLOP/s and 3.35 TB/s of HBM3
(the bound rule of ``PERF.md``), and 450 GB/s a direction of NVLink 4
(the datasheet's 900 GB/s a GPU, both directions together).  These are
datasheet values, not measurements.
"""
from __future__ import annotations

import dataclasses

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s (datasheet)
H100_HBM_BW = 3.35e12         # HBM3 bytes/s (datasheet)
H100_NVLINK_BW = 450e9        # NVLink 4, one direction, bytes/s (datasheet: 900 GB/s both ways)
# int32 operations/s: 132 SMs x 64 int32 lanes x the 1,980 MHz boost clock
# (the H100 architecture paper; the rate PERF.md bounds the LCS kernels by)
H100_INT32_OPS = 132 * 64 * 1.98e9


def collective_bytes(mesh) -> dict:
    """The mesh's collective counters since its last
    ``reset_collective_bytes``, in the reference's shape: ``{"bytes": {kind:
    bytes a device}, "total_bytes"}`` (each kind's operand bytes summed over
    the ranks, divided by the ranks)."""
    per_dev = {k: v / mesh.size for k, v in mesh.collective_bytes.items()}
    return {"bytes": per_dev, "total_bytes": sum(per_dev.values())}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float                # per device
    bytes_accessed: float       # per device
    coll_bytes: float           # per device
    model_flops: float          # analytic 6*N*D (global)
    chips: int
    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW

    @classmethod
    def from_counts(cls, flops: float, bytes_accessed: float, coll_bytes: float, *, model_flops: float,
                    chips: int, **rates) -> "Roofline":
        """The three terms from per-device counts at the record's rates."""
        r = cls(0.0, 0.0, 0.0, flops, bytes_accessed, coll_bytes, model_flops, chips, **rates)
        r.compute_s = flops / r.peak_flops
        r.memory_s = bytes_accessed / r.hbm_bw
        r.collective_s = coll_bytes / r.link_bw
        return r

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (chips * peak * step_time) at the roofline bound."""
        if self.step_time_s == 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * self.step_time_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_bound_s": self.step_time_s,
            "mfu_bound": self.mfu,
            "chips": self.chips,
            "rates": {"peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw, "link_bw": self.link_bw},
        }


# ---------------------------------------------------------------------------
# measured on the card
# ---------------------------------------------------------------------------
def kernel_kind(name: str) -> str:
    """A device kernel's kind, by its name: the port's two LM kernels, the
    cuBLAS matmuls, copies and casts, reductions, the rest."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention (#6)"
    if "ssd_intra" in n:
        return "ssd_intra (#7)"
    if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk", "sm90_")):
        return "matmul (cuBLAS)"
    if any(w in n for w in ("copy", "memcpy", "memset", "fill")):
        return "copies and casts"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


def profile_device(fn, device=None, *, top: int = 0) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (device activity only) and
    return ``{"wall_ms", "busy_ms", "device_ms_by_kind"}``: the host wall
    around it (after a sync), the device's summed kernel time and that time
    by :func:`kernel_kind`; with ``top``, also ``"top_kernels"``: the
    ``top`` kernel names by device time, as (name, ms).  On a CPU
    ``device`` (a rehearsal) only the wall is taken, and the device times
    are None."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device is not None and torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return {"wall_ms": (time.perf_counter() - t0) * 1e3, "busy_ms": None, "device_ms_by_kind": None}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by: dict = {}
    names: dict = {}
    # the raw device events (``prof.events()`` builds a Python record an
    # event, ~0.1 ms each, ~10^5 events a training step)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k, ms = kernel_kind(e.name()), e.duration_ns() / 1e6
            by[k] = by.get(k, 0.0) + ms
            names[e.name()] = names.get(e.name(), 0.0) + ms
    out = {"wall_ms": wall, "busy_ms": sum(by.values()), "device_ms_by_kind": by}
    if top:
        out["top_kernels"] = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return out


def reset_peak(device) -> None:
    """Zero the card's peak-memory counter (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    """``torch.cuda.max_memory_allocated`` since :func:`reset_peak` (None
    on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else None
