"""Architecture registry of the port: the dense, ssm and hybrid configs (+ reduced smoke variants).

``get(name)`` returns the full published config; ``get_reduced(name)`` a tiny
same-family config for CPU smoke tests.  ``ARCHS`` lists the selectable
``--arch`` ids.  The configs are the reference's (``repro.configs``), copied
as data.  The reference's other four architectures (the moe, vlm and audio
families) need modules the port does not have yet: ``get`` raises a
``KeyError`` naming ROADMAP Queue 1 item 13b for them.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_27b",
}
# Registered by the reference, waiting for their model families in the port.
NOT_PORTED = ("phi3.5-moe-42b-a6.6b", "arctic-480b", "llama-3.2-vision-11b", "musicgen-medium")

ARCHS: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: its family waits for ROADMAP "
                       f"Queue 1 item 13b (the moe, vlm and audio modules); ported: {ARCHS}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get(name), **overrides)
