"""The port's two examples on the CPU, against the JAX package's examples.

``examples/torch_quickstart.py`` and ``examples/torch_find_another_me.py``
run with ``main(device="cpu")``; their output must be the JAX examples'
line for line (the quickstart's phase-times line aside), ending in
``QA1 = 1.000  QA2 = 1.000`` and in Carol's line.  ``examples/
torch_serve_lm.py`` and ``examples/torch_train_lm.py`` (at a few steps)
run on the CPU and are held to the JAX examples' lines where the random
weights do not enter.
"""
import contextlib
import importlib.util
import io
import os

import pytest
import torch

from conftest import REPO


def _main(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def _lines(main, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(**kw)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name,last", [
    ("quickstart", "QA1 = 1.000  QA2 = 1.000  (paper: 1.000)"),
    ("find_another_me", "Carol found another her across the world ✓"),
])
def test_torch_example_matches_jax_example(name, last):
    got = _lines(_main(f"torch_{name}"), device="cpu")
    want = _lines(_main(name))
    assert got[-1] == last
    same = lambda lines: [ln for ln in lines if not ln.startswith("phase times")]  # noqa: E731
    assert same(got) == same(want)


def test_torch_serve_lm_example():
    """``examples/torch_serve_lm.py`` on the CPU: one line for each of the
    JAX example's four architectures, with its family and cache size (from
    the JAX package's configs and ``cache_bytes``), then the closing line.
    The JAX example itself takes ~90 s on the CPU (its eager MoE prefill),
    so its lines are rebuilt here rather than run; the sampled tokens
    differ, since the two packages draw their random weights differently."""
    import dataclasses

    from repro.configs import get_config
    from repro.serve.kvcache import cache_bytes

    got = _lines(_main("torch_serve_lm"), device="cpu")
    archs = ("granite-3-8b", "deepseek-v2-236b", "mamba2-1.3b", "zamba2-2.7b")
    assert got[0] == "batched serving across cache families (reduced configs):"
    assert got[-1] == "all families served ✓"
    assert len(got) == len(archs) + 2
    for arch, line in zip(archs, got[1:-1]):
        cfg = dataclasses.replace(get_config(arch).reduced(), frontend="none")
        want = (f"{arch:22s} family={cfg.family:7s} "
                f"cache={cache_bytes(cfg, 4, 64) / 1e6:7.2f}MB  prefill=")
        assert line.startswith(want), (line, want)
        assert "ms/tok  sample=[" in line


def test_torch_train_lm_example(tmp_path):
    """``examples/torch_train_lm.py`` on the CPU at a few steps, on the
    reduced granite-3-8b without dedup (tiny-100m's 66.6M parameters cost
    the parallel CPU suite minutes, and a 512-token vocabulary is under the
    3,000 SSH dedup's ``vocab_forest`` needs; ``chip_smoke.py`` runs the
    example's own tiny-100m with SSH dedup on the card), a corpus small
    enough that batches repeat: the loss falls, the last step's checkpoint
    is written, and the JAX example's closing line is printed.  torch runs
    on one thread beside the suite's other workers."""
    argv = ["--arch", "granite-3-8b", "--reduced", "--dedup", "none", "--steps", "6",
            "--num-docs", "16", "--seq-len", "64", "--global-batch", "4", "--lr", "1e-3",
            "--warmup", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            result = _main("torch_train_lm")(argv)
    finally:
        torch.set_num_threads(threads)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("arch=granite-3-8b params=")
    assert lines[-1] == "training improved the loss ✓"
    assert len(result["losses"]) == 6
    assert (tmp_path / "step_0000000006" / "MANIFEST.json").is_file()
