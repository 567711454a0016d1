"""Dense feed-forward (SwiGLU) layer. Port of ``repro/models/ffn.py``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ModelConfig, dense_init, swiglu


def init_ffn(gen: torch.Generator, cfg: ModelConfig, device, d_ff: int = 0,
             dtype=None) -> Dict:
    dtype = dtype or cfg.dtype
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (cfg.d_model, d_ff), dtype, device),
        "w_up": dense_init(gen, (cfg.d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, cfg.d_model), dtype, device),
    }


def ffn_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
