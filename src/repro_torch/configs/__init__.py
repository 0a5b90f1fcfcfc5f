"""Architecture registry: one module per assigned architecture.

Usage: ``get_config("qwen3-0.6b")`` or via ``--arch`` on any launcher.
"""

from __future__ import annotations

from ..models.api import ArchConfig

from . import (
    deepseek_moe_16b,
    deepseek_v3_671b,
    gemma2_9b,
    gemma2_27b,
    hymba_1_5b,
    mistral_nemo_12b,
    paligemma_3b,
    qwen3_0_6b,
    whisper_small,
    xlstm_125m,
)

_MODULES = {
    "deepseek-v3-671b": deepseek_v3_671b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "whisper-small": whisper_small,
    "qwen3-0.6b": qwen3_0_6b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "gemma2-9b": gemma2_9b,
    "gemma2-27b": gemma2_27b,
    "paligemma-3b": paligemma_3b,
    "xlstm-125m": xlstm_125m,
    "hymba-1.5b": hymba_1_5b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return _MODULES[name].config()


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}
