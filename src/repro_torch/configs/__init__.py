"""Architecture registry of the port: the 10 configs of the reference (+ reduced smoke variants).

``get(name)`` returns the full published config; ``get_reduced(name)`` a tiny
same-family config for CPU smoke tests.  ``ARCHS`` lists the selectable
``--arch`` ids.  The configs are the reference's (``repro.configs``), copied
as data, in its order.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}

ARCHS: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get(name), **overrides)


def all_configs() -> Dict[str, ModelConfig]:
    """Every published config, by ``--arch`` id, in :data:`ARCHS`' order."""
    return {n: get(n) for n in ARCHS}
