"""Architecture registry: ``arch`` id resolution, smoke variants, and
per-arch input-shape applicability. Port of ``repro/configs/registry.py``
(all 11 archs; the port serves every family: the dense, vlm and moe ones
through ``LLMEngine``, the ssm, hybrid and audio ones through the
dense-cache entry points of ``models/transformer.py``)."""
from __future__ import annotations

import importlib
from typing import List, Optional

from repro_torch.configs.base import reduced
from repro_torch.models.common import ModelConfig

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    # the paper's own model, used by the figure benchmarks
    "llama3-70b": "repro_torch.configs.llama3_70b",
}

ASSIGNED = [a for a in _MODULES if a != "llama3-70b"]

# long_500k applicability. Entries absent here run all shapes.
LONG_500K = {
    "rwkv6-7b": "runs — O(1) recurrent state",
    "zamba2-1.2b": "runs — mamba state + seq-sharded shared-attn KV",
    "gemma2-27b": "runs — native sliding-window local layers; global layers "
                  "use sequence-sharded KV + partial combine",
    "llama3-8b": "runs — via CONFIG_SW sliding-window(8192) variant",
    "pixtral-12b": "skip — pure full attention (see DESIGN.md §4)",
    "qwen3-moe-30b-a3b": "skip — pure full attention",
    "glm4-9b": "runs — via CONFIG_SINKS StreamingLLM variant "
               "(4 sinks + 8k window, paper §7 sparse attention)",
    "kimi-k2-1t-a32b": "skip — pure full attention",
    "tinyllama-1.1b": "skip — pure full attention",
    "seamless-m4t-medium": "skip — 524k-frame decode outside enc-dec "
                           "operating range (N/A)",
}


def get_config(arch: str, variant: Optional[str] = None) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    if variant:
        return getattr(mod, f"CONFIG_{variant.upper()}")
    return mod.CONFIG


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def applicable_shapes(arch: str) -> List[str]:
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if LONG_500K.get(arch, "runs").startswith("runs"):
        shapes.append("long_500k")
    return shapes


def config_for_shape(arch: str, shape: str) -> ModelConfig:
    """Resolve arch + shape to the concrete config (the llama3-8b
    sliding-window and the glm4-9b sinks variants at long_500k)."""
    if shape == "long_500k" and arch == "llama3-8b":
        return get_config(arch, variant="sw")
    if shape == "long_500k" and arch == "glm4-9b":
        return get_config(arch, variant="sinks")
    return get_config(arch)


def list_archs() -> List[str]:
    return list(_MODULES)
