"""Registry of assigned architectures (+ reduced smoke variants).

Each ``<arch>.py`` module defines ``CONFIG`` (exact published config) and
``smoke_config()`` (same family, tiny dims, CPU-runnable).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from ..arch.config import ArchConfig

ARCH_IDS: List[str] = [
    "qwen3_32b",
    "gemma3_27b",
    "minitron_4b",
    "qwen2_1_5b",
    "xlstm_125m",
    "seamless_m4t_large_v2",
    "recurrentgemma_9b",
    "moonshot_v1_16b_a3b",
    "qwen2_moe_a2_7b",
    "internvl2_2b",
]

# canonical CLI ids use dashes
CLI_TO_MODULE = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module_name(arch: str) -> str:
    """Normalize any spelling (qwen2-1.5b, qwen2_1_5b, ...) to the module."""
    norm = arch.replace("-", "_").replace(".", "_")
    if norm in ARCH_IDS:
        return norm
    for a in ARCH_IDS:  # prefix match for convenience
        if a.startswith(norm):
            return a
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch)}")
    return mod.smoke_config()


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
