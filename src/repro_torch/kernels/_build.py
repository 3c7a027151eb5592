"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher and compiles on its own,
with the shared ``csrc/*.cuh`` headers it includes, with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``).  No PyTorch header is included, so
a build takes seconds, not minutes.  Only sources in this package are read.
A missing ``nvcc`` or a failed build raises: there is no fallback.

    from repro_torch.kernels import _build
    _build.build_all()            # every source at once, one nvcc each
    lib = _build.load("lcs")      # ctypes.CDLL of build/kernels/lcs-<hash>.so
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels cannot be built on this machine"
    )


def _target(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's key
    files = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    src = b"".join(p.read_bytes() for p in files)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=None) -> dict[str, str]:
    """Compile every stale source in parallel (one ``nvcc`` each).

    Returns ``{name: compiler output}`` for the sources built by this call,
    each led by a line ``nvcc <name>.cu: <seconds> s`` (its own wall time
    from the common start) and holding the ptxas register/shared-memory
    report.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _target(n).is_file()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        with open(tmp.with_suffix(".log"), "w") as out:  # a file: no pipe to fill while polling
            procs[n] = (tmp, subprocess.Popen(_command(n, tmp), stdout=out,
                                              stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):
        for n, (_, proc) in procs.items():
            if n not in seconds and proc.poll() is not None:
                seconds[n] = time.perf_counter() - t0
        time.sleep(0.02)
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log_file = tmp.with_suffix(".log")
        out = f"nvcc {n}.cu: {seconds[n]:.2f} s\n" + log_file.read_text()
        log_file.unlink()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if missing)."""
    build_all([name])
    return ctypes.CDLL(str(_target(name)))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
