"""Architecture registry: ``arch`` id resolution and smoke variants.
Port of ``repro/configs/registry.py`` for the archs the port serves so far
(each later slice adds its config module here)."""
from __future__ import annotations

import importlib
from typing import List, Optional

from repro_torch.configs.base import reduced
from repro_torch.models.common import ModelConfig

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}


def get_config(arch: str, variant: Optional[str] = None) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    if variant:
        return getattr(mod, f"CONFIG_{variant.upper()}")
    return mod.CONFIG


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def list_archs() -> List[str]:
    return list(_MODULES)
