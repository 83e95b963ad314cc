"""Assigned architecture configs. ``get(name)`` -> full ModelConfig;
``get_smoke(name)`` -> reduced same-family config for CPU smoke tests.

The port's copy of ``repro.configs``, field for field."""
from __future__ import annotations

import importlib

ARCHS = [
    "mixtral_8x7b", "deepseek_v2_236b", "qwen3_0_6b", "granite_3_2b",
    "gemma2_9b", "stablelm_1_6b", "internvl2_2b", "whisper_large_v3",
    "hymba_1_5b", "mamba2_1_3b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    n = name.replace("-", "_").replace(".", "_")
    if n not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return n


def get(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE
