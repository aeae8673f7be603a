"""Decoder LM assembly: blocks, the layer stack, logits.

Parameters keep the JAX package's tree: layers grouped into the repeating
pattern period and stacked ``[G, ...]`` per leaf, so the reference's
parameters carry across leaf for leaf.  Where the JAX package scans over
the groups, the port runs a Python loop over the leading dim.  Only
attention blocks with a dense MLP are ported so far.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.core.propagation import PackedArray
from repro_torch.models import attention
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (Stream, embed_init, maybe_pack,
                                       maybe_unpack, norm_apply, norm_init,
                                       stream_add)

__all__ = ["pattern_period", "block_init", "block_apply", "layers_init",
           "layers_apply", "lm_init", "lm_apply", "logits_apply",
           "init_paged_caches", "tree_map"]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict (other leaves,
    such as a prepacked weight's ``w_n``, pass through)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def pattern_period(cfg: ModelConfig) -> int:
    p = len(cfg.block_pattern)
    if cfg.moe:
        p = math.lcm(p, cfg.moe_every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not divide "
                         f"into pattern groups of {p}")
    return p


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense",) or cfg.moe \
            or any(t != "attn" for t in cfg.layer_types):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}, "
                                  f"{set(cfg.layer_types)}): only dense "
                                  f"attention models are ported so far")


def block_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    return {"ln1": norm_init(cfg.norm, cfg.d_model, dtype),
            "mixer": attention.attn_init(generator, cfg, dtype),
            "ln2": norm_init(cfg.norm, cfg.d_model, dtype),
            "ffn": mlp_mod.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg,
                                    dtype)}


def _as_stream_like(out: Stream, like: Stream, ctx: MatmulContext) -> Stream:
    if isinstance(like, PackedArray) and not isinstance(out, PackedArray):
        return maybe_pack(out, ctx)
    if not isinstance(like, PackedArray) and isinstance(out, PackedArray):
        return out.unpack()
    return out


def block_apply(p: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: dict, paged: dict):
    """Pre-norm residual block.  Returns (x', cache)."""
    keep = isinstance(x, PackedArray)
    h = norm_apply(p["ln1"], x, cfg.norm)
    out, kv = attention.attn_apply(p["mixer"], h, ctx, cfg, positions=positions,
                                   kv_cache=cache["kv"], keep_packed=keep,
                                   paged=paged)
    x = stream_add(x, _as_stream_like(out, x, ctx))
    h2 = norm_apply(p["ln2"], x, cfg.norm)
    out2 = mlp_mod.mlp_apply(p["ffn"], h2, ctx, cfg, keep_packed=keep)
    x = stream_add(x, _as_stream_like(out2, x, ctx))
    return x, {"kv": kv}


def layers_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> dict:
    """Stacked ``{"p<i>": block}`` groups, every leaf ``[G, ...]``."""
    period = pattern_period(cfg)
    groups = [{f"p{i}": block_init(generator, cfg, dtype) for i in range(period)}
              for _ in range(cfg.n_layers // period)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    return stack(*groups)


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_tokens: int,
                      dtype: torch.dtype, device) -> dict:
    """Stacked ``[G, P, T, Hkv, dh]`` K/V page pools, one per pattern slot
    (page ids are shared by every layer)."""
    _check_ported(cfg)
    period = pattern_period(cfg)
    groups = cfg.n_layers // period
    one = attention.init_paged_kv_cache(cfg, num_pages, page_tokens, dtype,
                                        device)
    return {f"p{i}": {"kv": {k: torch.zeros((groups, *v.shape), dtype=v.dtype,
                                            device=device)
                             for k, v in one.items()}}
            for i in range(period)}


def layers_apply(params_groups: dict, x: Stream, ctx: MatmulContext,
                 cfg: ModelConfig, *, positions: torch.Tensor, caches: dict,
                 paged: dict) -> Stream:
    """Run every group in order over a paged step; the pools in
    ``caches`` are written in place (each group's slice is a view)."""
    period = pattern_period(cfg)
    for g in range(cfg.n_layers // period):
        for i in range(period):
            gp = tree_map(lambda t: t[g], params_groups[f"p{i}"])
            gc = tree_map(lambda t: t[g], caches[f"p{i}"])
            x, _ = block_apply(gp, x, ctx, cfg, positions=positions, cache=gc,
                               paged=paged)
    return x


def lm_init(generator: torch.Generator, cfg: ModelConfig, run: RunConfig) -> dict:
    _check_ported(cfg)
    dtype = getattr(torch, run.param_dtype)
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype),
         "groups": layers_init(generator, cfg, dtype),
         "ln_f": norm_init(cfg.norm, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(generator, cfg.d_model, cfg.vocab,
                                   dtype=dtype, scale=cfg.d_model ** -0.5)
    return p


def logits_apply(params: dict, x: Stream, ctx: MatmulContext,
                 cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        # packs embed.T on every call: pack_rhs reads it back as the
        # contiguous [V, D] table, so no copy precedes the pack kernel
        return maybe_unpack(linear_apply({"w": params["embed"]["e"].T}, x, ctx))
    return maybe_unpack(linear_apply(params["lm_head"], x, ctx))


def lm_apply(params: dict, embeds: torch.Tensor, ctx: MatmulContext,
             cfg: ModelConfig, run: RunConfig, *, positions: torch.Tensor,
             caches: dict, paged: dict,
             logits_at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """embeds: [B, S, D].  Returns logits [B, S, V], or [B, K, V] at the
    per-row positions ``logits_at`` ([B] or [B, K])."""
    del run
    x: Stream = maybe_pack(embeds, ctx)
    x = layers_apply(params["groups"], x, ctx, cfg, positions=positions,
                     caches=caches, paged=paged)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    if logits_at is not None:
        idx = (logits_at if logits_at.ndim == 2 else logits_at[:, None]).long()
        xu = maybe_unpack(x)
        rows = torch.arange(xu.shape[0], device=xu.device)[:, None]
        x = maybe_pack(xu[rows, idx], ctx)
    return logits_apply(params, x, ctx, cfg)
