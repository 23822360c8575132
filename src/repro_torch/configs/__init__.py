"""Workload configurations of the port: the paper's sampling workloads
(``paper_workloads``) and the registry of the LM architectures the port
builds so far (the dense family).

Each architecture module defines ``CONFIG`` (the published widths) and
``REDUCED`` (the CPU smoke scale); ``get(name)`` and ``get_reduced(name)``
take either the module name or the published name (``qwen1.5-0.5b``).
The moe, hybrid, ssm, audio and vlm configurations come with their model
families (ROADMAP A8).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen1_5_0_5b",
    "stablelm_3b",
    "qwen3_4b",
    "granite_3_8b",
]

_ALIAS = {
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
        raise KeyError(f"unknown or not yet ported architecture {name!r}; "
                       f"the port has {ARCHS} (the rest: ROADMAP A8)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
