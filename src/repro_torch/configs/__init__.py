"""Workload configurations of the port: the paper's sampling workloads
(``paper_workloads``) and the registry of the ten LM architectures, the
JAX package's list in its order.

Each architecture module defines ``CONFIG`` (the published widths) and
``REDUCED`` (the CPU smoke scale); ``get(name)`` and ``get_reduced(name)``
take either the module name or the published name (``qwen1.5-0.5b``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "jamba_1_5_large_398b",
    "llama4_maverick_400b_a17b",
    "kimi_k2_1t_a32b",
    "whisper_small",
    "internvl2_76b",
    "xlstm_1_3b",
    "qwen1_5_0_5b",
    "stablelm_3b",
    "qwen3_4b",
    "granite_3_8b",
]

_ALIAS = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-small": "whisper_small",
    "internvl2-76b": "internvl2_76b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "stablelm-3b": "stablelm_3b",
    "qwen3-4b": "qwen3_4b",
    "granite-3-8b": "granite_3_8b",
}


def canonical(name: str) -> str:
    return _ALIAS.get(name, name)


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; the registry has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED


def all_configs() -> dict[str, ModelConfig]:
    """``{arch: get(arch)}`` over ``ARCHS``, in its order."""
    return {a: get(a) for a in ARCHS}
