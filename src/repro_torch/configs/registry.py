"""Architecture registry.  The port serves SmolLM2-135M (dense) and
whisper-small (encdec) so far; the other architectures of the JAX package
join as their model families are ported."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config"]

ARCHS = {"smollm2-135m": "smollm2_135m", "whisper-small": "whisper_small"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").config()
