"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "qwen2-72b",
    "starcoder2-15b",
    "minitron-4b",
    "phi3-mini-3.8b",
    "internvl2-26b",
    "recurrentgemma-2b",
    "xlstm-350m",
    "llama4-scout-17b-a16e",
    "deepseek-v3-671b",
    "seamless-m4t-large-v2",
    "paper-bayes-fusion",      # the paper's own workload as a config
)

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "starcoder2-15b": "starcoder2_15b",
    "minitron-4b": "minitron_4b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internvl2-26b": "internvl2_26b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "paper-bayes-fusion": "paper_bayes",
}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).full_config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()
