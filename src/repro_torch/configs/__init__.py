"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro/configs/__init__.py``, with the imports pointed at the port's
``ModelConfig``).

Each module defines CONFIG with the exact assigned dimensions and cites its
source in the docstring.  ``get_config(arch, variant)`` applies serving
variants (``swa``: rolling-window serving for full-attention archs).
``shapes.py`` holds the four assigned input shapes and their meta-tensor
input specs.
"""
from __future__ import annotations

from dataclasses import replace
from importlib import import_module

from ..models.config import ModelConfig
from .shapes import SHAPES, InputShape, decode_cache_width, input_specs

__all__ = ["ARCH_IDS", "SWA_SERVE_WINDOW", "get_config", "SHAPES",
           "InputShape", "input_specs", "decode_cache_width"]

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-0.5b": "qwen2_0_5b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "mamba2-370m": "mamba2_370m",
    "qwen1.5-110b": "qwen1_5_110b",
    "whisper-small": "whisper_small",
    "paligemma-3b": "paligemma_3b",
    "starcoder2-7b": "starcoder2_7b",
}

ARCH_IDS = tuple(_MODULES)

SWA_SERVE_WINDOW = 8192


def get_config(arch: str, variant: str | None = None) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    cfg: ModelConfig = import_module(
        f"repro_torch.configs.{_MODULES[arch]}").CONFIG
    if variant == "swa" and cfg.sliding_window is None:
        cfg = replace(cfg, sliding_window=SWA_SERVE_WINDOW,
                      name=f"{cfg.name}+swa")
    elif variant not in (None, "", "base"):
        raise ValueError(f"unknown variant {variant!r}")
    return cfg
