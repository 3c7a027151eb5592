"""Architecture registry: --arch <id> -> ModelConfig.

Every assigned architecture from the public pool, with the exact published
hyperparameters from the assignment table ([source] given per config file).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import repro_torch.configs.mamba2_1p3b      # noqa: F401
    import repro_torch.configs.kimi_k2_1t_a32b  # noqa: F401
    import repro_torch.configs.deepseek_v2_236b # noqa: F401
    import repro_torch.configs.zamba2_2p7b      # noqa: F401
    import repro_torch.configs.granite_3_8b     # noqa: F401
    import repro_torch.configs.mistral_nemo_12b # noqa: F401
    import repro_torch.configs.minicpm3_4b      # noqa: F401
    import repro_torch.configs.qwen1p5_110b     # noqa: F401
    import repro_torch.configs.hubert_xlarge    # noqa: F401
    import repro_torch.configs.internvl2_76b    # noqa: F401
