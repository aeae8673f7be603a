"""Gated / plain MLP blocks in the packed domain: pack once at entry, and
the chained matmuls (with the activation fused into the first) never
unpack in between."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.models.common import Stream

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(generator: torch.Generator, d: int, d_ff: int, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32, *, bias: bool = False) -> dict:
    p = {"wu": linear_init(generator, d, d_ff, bias=bias, dtype=dtype),
         "wd": linear_init(generator, d_ff, d, bias=bias, dtype=dtype,
                           scale=d_ff ** -0.5 / max(1, cfg.n_layers) ** 0.5)}
    if cfg.glu:
        p["wg"] = linear_init(generator, d, d_ff, bias=bias, dtype=dtype)
    return p


def mlp_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig,
              *, keep_packed: bool = False) -> Stream:
    inner_packed = ctx.packed and ctx.propagate
    if cfg.glu:
        g = linear_apply(params["wg"], x, ctx, activation=cfg.act,
                         keep_packed=inner_packed)
        u = linear_apply(params["wu"], x, ctx, keep_packed=inner_packed)
        h = g * u
    else:
        h = linear_apply(params["wu"], x, ctx, activation=cfg.act,
                         keep_packed=inner_packed)
    return linear_apply(params["wd"], h, ctx, keep_packed=keep_packed)
