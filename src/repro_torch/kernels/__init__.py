"""Hand-written CUDA kernels for Hopper (``csrc/``), built on first use by
``_build.py``, with their plain PyTorch versions and dispatch wrappers."""
