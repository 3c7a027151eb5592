"""Architecture and run-shape configurations of the LM scaffold.

The same data as ``repro.configs`` (one file per architecture, the same
published hyperparameters), kept here so the port imports nothing of the
JAX package.
"""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from repro_torch.configs.registry import get_config, all_archs
