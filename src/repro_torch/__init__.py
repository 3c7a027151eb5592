"""PyTorch/CUDA port of the AnotherMe semantic-trajectory engine.

Mirrors the JAX package ``repro`` module for module (``core/``, ``api/``,
``kernels/``, ``data/``) and never imports it or ``jax``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``; the
kernels are hand-written CUDA C++ for Hopper (``kernels/csrc/``), each with
a plain PyTorch version beside it.
"""
