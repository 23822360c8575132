"""Assigned input shapes and the (arch x shape) cell matrix, the port of
the JAX package's ``launch/shapes.py``.

The ``*_struct`` functions describe every model input, parameter and cache
leaf as tensors on the ``meta`` device (shape and dtype, no storage), where
JAX returns ``ShapeDtypeStruct``s: ``params_struct`` builds the
:class:`~repro_torch.models.LM` there without drawing its init, so a
published configuration's train state is sized without allocating it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

import repro_torch.configs as configs
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long"),
}


def cell_matrix() -> list[tuple[str, str, str]]:
    """All 40 (arch, shape, status) cells; status 'run' or a skip reason."""
    out = []
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for sname in SHAPES:
            if sname == "long_500k" and not cfg.subquadratic:
                out.append((arch, sname, "skip: pure full-attention at 512k"))
            else:
                out.append((arch, sname, "run"))
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_struct(cfg: ModelConfig, sh: ShapeSpec) -> dict[str, Any]:
    """Training/prefill batch leaves on ``meta``."""
    B, S = sh.global_batch, sh.seq_len
    batch: dict[str, Any] = {}
    if cfg.frontend == "embed":
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.encoder_layers:
        batch["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    batch["labels"] = _meta((B, S), torch.int32)
    return batch


def params_struct(cfg: ModelConfig):
    """The :class:`~repro_torch.models.LM` on ``meta`` with float32 leaves,
    as JAX's ``init_params`` makes them (masters)."""
    from repro_torch.models import LM

    return LM(cfg, META, param_dtype=torch.float32)


def cache_struct(cfg: ModelConfig, B: int, max_seq: int):
    from repro_torch.models import init_cache

    return init_cache(cfg, B, max_seq, META)


def decode_inputs_struct(cfg: ModelConfig, sh: ShapeSpec) -> dict[str, Any]:
    """serve_step inputs: cache holds seq_len-1 tokens, one new token in."""
    B, S = sh.global_batch, sh.seq_len
    d: dict[str, Any] = {
        "cache": cache_struct(cfg, B, S),
        "pos": _meta((B,), torch.int32),
        "xi": _meta((B,), torch.float32),
    }
    if cfg.frontend == "embed":
        d["token"] = _meta((B, 1, cfg.d_model), torch.bfloat16)
    else:
        d["token"] = _meta((B,), torch.int32)
    if cfg.encoder_layers:
        d["enc_out"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    return d
