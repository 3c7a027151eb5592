#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/lm_phases.py            # the serving phases
    python3 tools/lm_phases.py --train    # the training phases alone
    python3 tools/lm_phases.py --mesh     # the mesh phases alone

Builds every kernel and runs ``chip_smoke.py``'s phases 19-22 (flash
attention and the SSD step at edge shapes, the reduced models card against
CPU, zamba2-2.7b, granite-3-8b, deepseek-v2-236b at 4 of its 60 layers and
minicpm3-4b at 31 of its 62 layers, at full width, the #6 and #7 timing rows) with the same checks,
in about 2.5 minutes instead of the whole script's ten; with ``--train``
its phases 23-26 instead (the two autograd ops' gradients and times, the
reduced models' gradients card against CPU, zamba2-2.7b trained at full
width, the training example); with ``--mesh`` its phases 27-30 (expert-
parallel deepseek-v2 serving on (1, 2) and (2, 2) meshes of the card,
data-parallel zamba2 training on a (2, 1) mesh, the dry-run and the perf
variants).  The last line is the ``{"kernels": [...]}``
JSON of the phases run.  Needs nvcc and a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    smi = chip_smoke.phase_device(torch)
    figures = chip_smoke.phase_build()
    if "--train" in sys.argv[1:]:
        entries = chip_smoke.phase_train(torch, dev, [])
    elif "--mesh" in sys.argv[1:]:
        entries = chip_smoke.phase_mesh(torch, dev, [])
    else:
        entries = chip_smoke.phase_lm(torch, dev, figures)
    chip_smoke.log(f"lm_phases: passed in {time.perf_counter() - t0:.1f} s; {smi}")
    chip_smoke.log(json.dumps({"kernels": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
