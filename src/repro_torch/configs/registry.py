"""Architecture registry and the assigned (arch x shape) cell matrix, as
the JAX package's ``configs/registry.py`` has them.  Every architecture
has its config here, and the port builds a model of each
(``launch/serve.py:SERVABLE`` names those it serves)."""

from __future__ import annotations

import importlib
from typing import Iterator, Optional

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

__all__ = ["ARCHS", "ASSIGNED", "get_config", "cells", "cell_status"]

ARCHS = {
    "qwen2-7b": "qwen2_7b",
    "qwen3-8b": "qwen3_8b",
    "olmo-1b": "olmo_1b",
    "chatglm3-6b": "chatglm3_6b",
    "whisper-small": "whisper_small",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "arctic-480b": "arctic_480b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "internvl2-26b": "internvl2_26b",
    # the paper's own end-to-end model (extra, beyond the assigned ten)
    "smollm2-135m": "smollm2_135m",
}

ASSIGNED = [a for a in ARCHS if a != "smollm2-135m"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").config()


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs, reason-if-skipped) for one (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("skip: pure full-attention arch at 524288 ctx "
                       "(assignment rule: long_500k only for SSM/hybrid)")
    return True, ""


def cells(include_skipped: bool = False,
          archs: Optional[list[str]] = None) -> Iterator[tuple[str, str, bool, str]]:
    """Yield (arch, shape, runs, reason) over the assigned 40-cell matrix."""
    for arch in (archs or ASSIGNED):
        cfg = get_config(arch)
        for shape in SHAPES.values():
            runs, reason = cell_status(cfg, shape)
            if runs or include_skipped:
                yield arch, shape.name, runs, reason
