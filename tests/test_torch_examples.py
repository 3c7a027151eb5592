"""The port's two examples on the CPU, against the JAX package's examples.

``examples/torch_quickstart.py`` and ``examples/torch_find_another_me.py``
run with ``main(device="cpu")``; their output must be the JAX examples'
line for line (the quickstart's phase-times line aside), ending in
``QA1 = 1.000  QA2 = 1.000`` and in Carol's line.
"""
import contextlib
import importlib.util
import io
import os

import pytest

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
