"""Precision policy: bf16 compute with fp32 master parameters (the port of
``clip_finegrained_alignment_tpu/core/precision.py``). bf16 has fp32's
exponent range, so no loss scaling is needed; losses and the optimizer
reduce in fp32."""

from __future__ import annotations

import torch

from ..config import PrecisionConfig, TrainConfig

_DTYPES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "f16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    """The activation and matmul dtype; ``use_amp`` off means fp32."""
    if not cfg.use_amp:
        return torch.float32
    return resolve_dtype(cfg.precision.compute_dtype)


def param_dtype(precision: PrecisionConfig) -> torch.dtype:
    return resolve_dtype(precision.param_dtype)
