"""Decoder LM assembly: blocks, the layer stack, logits.

Parameters keep the JAX package's tree: layers grouped into the repeating
pattern period and stacked ``[G, ...]`` per leaf, so the reference's
parameters carry across leaf for leaf.  Where the JAX package scans over
the groups, the port runs a Python loop over the leading dim (each leaf
unbound once per call, so the gradient of the stack is one stack of the
groups' gradients).  Only attention blocks with a dense MLP are ported so
far (the dense, vlm and encdec families), in the train/prefill mode (no
cache, causal or bidirectional), the dense-cache decode mode with
whisper's cross-attention, and the two paged serving modes.  The vlm
family is the dense LM with a ``vision_proj`` linear over stub patch
embeddings (``models/model.py`` prepends them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

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
           "init_layer_caches", "init_paged_caches", "tree_map", "AUX_ZERO"]

# the aux losses of the MoE family, zero for every other family
AUX_ZERO = {"load_balance": 0.0, "router_z": 0.0, "dropped_frac": 0.0}


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
    """Raise for a family the port has no model of yet, naming the
    ROADMAP items that bring it."""
    missing = []
    if cfg.moe:
        missing.append("the moe family (ROADMAP B3, then A8b moe)")
    if cfg.family not in ("dense", "vlm", "encdec") \
            or any(t != "attn" for t in cfg.layer_types):
        missing.append("the hybrid and ssm mixers (ROADMAP A8b hybrids)")
    if missing:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}, layers "
                                  f"{sorted(set(cfg.layer_types))}) needs "
                                  f"{' and '.join(missing)}, not ported yet")


def block_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, *, cross: bool = False) -> dict:
    """One block; ``cross`` adds whisper's decoder cross-attention (``ln_c``
    and ``cross``).  The encdec family's MLPs carry biases."""
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, dtype),
         "mixer": attention.attn_init(generator, cfg, dtype)}
    if cross:
        p["ln_c"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["cross"] = attention.attn_init(generator, cfg, dtype)
    p["ln2"] = norm_init(cfg.norm, cfg.d_model, dtype)
    p["ffn"] = mlp_mod.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg, dtype,
                                bias=cfg.attn_bias and cfg.family == "encdec")
    return p


def _as_stream_like(out: Stream, like: Stream, ctx: MatmulContext) -> Stream:
    if isinstance(like, PackedArray) and not isinstance(out, PackedArray):
        return maybe_pack(out, ctx)
    if not isinstance(like, PackedArray) and isinstance(out, PackedArray):
        return out.unpack()
    return out


def block_apply(p: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig, *,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[dict] = None,
                cache_pos: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_kv: Optional[dict] = None,
                paged: Optional[dict] = None):
    """Pre-norm residual block.  Returns (x', cache); no cache (None) in
    the train/prefill mode.  A block with ``cross`` attends over the
    encoder: through ``enc_out`` (train/prefill: K/V projected here) or
    the precomputed ``cross_kv`` {"k","v"} [B, S_enc, Hkv, dh] (decode)."""
    keep = isinstance(x, PackedArray)
    h = norm_apply(p["ln1"], x, cfg.norm)
    out, kv = attention.attn_apply(
        p["mixer"], h, ctx, cfg, positions=positions, causal=causal,
        kv_cache=None if cache is None else cache["kv"], cache_pos=cache_pos,
        keep_packed=keep, paged=paged)
    x = stream_add(x, _as_stream_like(out, x, ctx))
    if "cross" in p:
        hc = norm_apply(p["ln_c"], x, cfg.norm)
        if cross_kv is not None:
            q = maybe_unpack(linear_apply(p["cross"]["wq"], hc, ctx))
            b, sq = q.shape[0], q.shape[1]
            q = q.reshape(b, sq, cfg.n_heads, cfg.d_head)
            if cfg.qk_norm:
                q = norm_apply(p["cross"]["q_norm"], q, "rmsnorm")
            o = attention.core_attention(
                q, cross_kv["k"], cross_kv["v"], causal=False,
                q_pos=torch.zeros((sq,), dtype=torch.int32, device=q.device))
            out = linear_apply(p["cross"]["wo"], o.reshape(b, sq, -1), ctx,
                               keep_packed=keep)
        else:
            out, _ = attention.attn_apply(
                p["cross"], hc, ctx, cfg, positions=positions, causal=False,
                kv_source=enc_out, keep_packed=keep)
        x = stream_add(x, _as_stream_like(out, x, ctx))
    h2 = norm_apply(p["ln2"], x, cfg.norm)
    out2 = mlp_mod.mlp_apply(p["ffn"], h2, ctx, cfg, keep_packed=keep)
    x = stream_add(x, _as_stream_like(out2, x, ctx))
    return x, (None if cache is None else {"kv": kv})


def layers_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, *, cross: bool = False) -> dict:
    """Stacked ``{"p<i>": block}`` groups, every leaf ``[G, ...]``."""
    period = pattern_period(cfg)
    groups = [{f"p{i}": block_init(generator, cfg, dtype, cross=cross)
               for i in range(period)}
              for _ in range(cfg.n_layers // period)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    return stack(*groups)


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> dict:
    """Stacked ``[G, batch, max_len, Hkv, dh]`` dense decode caches, one
    per pattern slot, zero."""
    _check_ported(cfg)
    period = pattern_period(cfg)
    groups = cfg.n_layers // period
    one = attention.init_kv_cache(cfg, batch, max_len, dtype, device)
    return {f"p{i}": {"kv": {k: torch.zeros((groups, *v.shape), dtype=v.dtype,
                                            device=device)
                             for k, v in one.items()}}
            for i in range(period)}


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


def _unbind(tree):
    """Each tensor leaf ``[G, ...]`` as a tuple of its G slices (one view
    op per leaf, whose gradient is one stack)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0) if isinstance(tree, torch.Tensor) else tree


def _group(tree, g: int):
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, tuple) else tree


def _apply_group(x: Stream, gp: dict, ctx: MatmulContext, cfg: ModelConfig,
                 positions: torch.Tensor, causal: bool,
                 enc_out: Optional[torch.Tensor]) -> Stream:
    for i in range(pattern_period(cfg)):
        x, _ = block_apply(gp[f"p{i}"], x, ctx, cfg, positions=positions,
                           causal=causal, enc_out=enc_out)
    return x


def layers_apply(params_groups: dict, x: Stream, ctx: MatmulContext,
                 cfg: ModelConfig, *, positions: torch.Tensor,
                 causal: bool = True, caches: Optional[dict] = None,
                 cache_pos: Optional[torch.Tensor] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 cross_kv: Optional[dict] = None,
                 paged: Optional[dict] = None, remat: bool = False) -> Stream:
    """Run every group in order.

    - train/prefill (``caches`` None): causal unless ``causal=False`` (an
      encoder); ``enc_out`` feeds the cross-attention of a decoder's
      blocks; ``remat`` recomputes each group's forward on the backward
      pass (``torch.utils.checkpoint``, where the JAX package wraps its
      scan body in ``jax.checkpoint``), so only the stream between groups
      is kept;
    - dense-cache decode (``caches`` from :func:`init_layer_caches`,
      ``cache_pos`` a 0-d device tensor) and the paged steps: the caches
      are written in place (each group's slice is a view); whisper's
      decoder also reads the stacked ``[G, ...]`` ``cross_kv``."""
    period = pattern_period(cfg)
    if caches is None:
        groups = _unbind(params_groups)
        for g in range(cfg.n_layers // period):
            gp = _group(groups, g)
            if remat:
                # the forward draws no random numbers, and a CUDA graph
                # capture may not read the generator's state
                x = checkpoint(_apply_group, x, gp, ctx, cfg, positions,
                               causal, enc_out, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _apply_group(x, gp, ctx, cfg, positions, causal, enc_out)
        return x
    for g in range(cfg.n_layers // period):
        for i in range(period):
            gp = tree_map(lambda t: t[g], params_groups[f"p{i}"])
            gc = tree_map(lambda t: t[g], caches[f"p{i}"])
            gkv = (None if cross_kv is None
                   else tree_map(lambda t: t[g], cross_kv[f"p{i}"]))
            x, _ = block_apply(gp, x, ctx, cfg, positions=positions,
                               causal=causal, cache=gc, cache_pos=cache_pos,
                               cross_kv=gkv, paged=paged)
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
    if cfg.family == "vlm":
        p["vision_proj"] = linear_init(generator, cfg.d_model, cfg.d_model,
                                       dtype=dtype)
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
             caches: Optional[dict] = None,
             cache_pos: Optional[torch.Tensor] = None,
             paged: Optional[dict] = None,
             last_only: bool = False,
             logits_at: Optional[torch.Tensor] = None):
    """embeds: [B, S, D].  Returns (logits, caches, aux): logits [B, S, V];
    [B, 1, V] for the last position with ``last_only`` (serving prefill);
    or [B, K, V] at the per-row positions ``logits_at`` ([B] or [B, K]).
    ``caches`` is None in the train/prefill mode and the same object,
    updated in place, in the dense-cache (``cache_pos``) and paged modes; ``aux`` is :data:`AUX_ZERO` (the
    dense family has no aux loss).  ``run.remat`` recomputes each layer
    group's forward on the backward pass (train mode)."""
    x: Stream = maybe_pack(embeds, ctx)
    x = layers_apply(params["groups"], x, ctx, cfg, positions=positions,
                     caches=caches, cache_pos=cache_pos, paged=paged,
                     remat=caches is None and run.remat)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    if logits_at is not None:
        idx = (logits_at if logits_at.ndim == 2 else logits_at[:, None]).long()
        xu = maybe_unpack(x)
        rows = torch.arange(xu.shape[0], device=xu.device)[:, None]
        x = maybe_pack(xu[rows, idx], ctx)
    elif last_only:
        x = maybe_pack(maybe_unpack(x)[:, -1:, :], ctx)
    return logits_apply(params, x, ctx, cfg), caches, dict(AUX_ZERO)
