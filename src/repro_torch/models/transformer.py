"""Decoder LM assembly: blocks, the layer stack, logits.

Parameters keep the JAX package's tree: layers grouped into the repeating
pattern period and stacked ``[G, ...]`` per leaf, so the reference's
parameters carry across leaf for leaf.  Where the JAX package scans over
the groups, the port runs a Python loop over the leading dim (each leaf
unbound once per call, so the gradient of the stack is one stack of the
groups' gradients).  A block's mixer follows ``cfg.layer_types``:
attention, mamba (``models/mamba.py``) or RWKV-6's time-mix
(``models/rwkv6.py``, whose block takes the channel-mix as its FFN); its
FFN is the moe layer (``models/moe.py``) where ``cfg.moe_on_layer(pos)``,
else the dense MLP.  The moe layers' aux losses are summed over the
layers in the train/prefill mode, as in the JAX package.
Modes: train/prefill (no cache, causal or bidirectional), the dense-cache
decode with whisper's cross-attention, and the two paged serving modes.
A recurrent mixer's cache is per-row state (``[G, rows, ...]``), beside
the attention layers' page pools in the paged modes; every mode updates
it in place.  The vlm family is the dense LM with a ``vision_proj``
linear over stub patch embeddings (``models/model.py`` prepends them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.linear import (MatmulContext, linear_apply, linear_init,
                                     tp_enter)
from repro_torch.core.propagation import PackedArray
from repro_torch.models import attention, mamba, moe, rwkv6
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (Stream, embed_init, maybe_pack,
                                       maybe_unpack, norm_apply, norm_init,
                                       stream_add)

__all__ = ["pattern_period", "block_init", "block_apply", "group_init",
           "layers_init", "layers_apply", "lm_init", "lm_apply",
           "logits_apply", "head_columns", "init_layer_caches",
           "init_paged_caches",
           "tree_map", "AUX_ZERO"]

# the aux losses of the MoE family, zero for every other family (and in the
# serving modes, as in the JAX package)
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


def block_init(generator: torch.Generator, cfg: ModelConfig, pos: int,
               dtype: torch.dtype, *, cross: bool = False) -> dict:
    """The block at pattern position ``pos``: its mixer by
    ``cfg.layer_types[pos]``; its FFN the moe layer where
    ``cfg.moe_on_layer(pos)``, else RWKV-6's channel-mix in an rwkv block
    and the MLP in every other.  ``cross`` adds whisper's decoder
    cross-attention (``ln_c`` and ``cross``).  The encdec family's MLPs
    carry biases."""
    t = cfg.layer_types[pos]
    init = {"attn": attention.attn_init, "mamba": mamba.mamba_init,
            "rwkv": rwkv6.rwkv_tm_init}[t]
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, dtype),
         "mixer": init(generator, cfg, dtype)}
    if cross:
        p["ln_c"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["cross"] = attention.attn_init(generator, cfg, dtype)
    p["ln2"] = norm_init(cfg.norm, cfg.d_model, dtype)
    if cfg.moe_on_layer(pos):
        p["ffn"] = moe.moe_init(generator, cfg, dtype)
    elif t == "rwkv":
        p["ffn"] = rwkv6.rwkv_cm_init(generator, cfg, dtype)
    else:
        p["ffn"] = mlp_mod.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg,
                                    dtype, bias=cfg.attn_bias
                                    and cfg.family == "encdec")
    return p


def _as_stream_like(out: Stream, like: Stream, ctx: MatmulContext) -> Stream:
    if isinstance(like, PackedArray) and not isinstance(out, PackedArray):
        return maybe_pack(out, ctx)
    if not isinstance(like, PackedArray) and isinstance(out, PackedArray):
        return out.unpack()
    return out


def block_apply(p: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig,
                pos: int, *, positions: torch.Tensor, causal: bool = True,
                cache: Optional[dict] = None,
                cache_pos: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_kv: Optional[dict] = None,
                paged: Optional[dict] = None, windows: tuple = (None, None)):
    """Pre-norm residual block at pattern position ``pos``.  Returns (x',
    cache, aux); no cache (None) in the train/prefill mode; ``aux`` the
    moe layer's aux losses (:data:`AUX_ZERO` for another FFN).  The cache of an
    attention block is {"kv": ...}, of a mamba block {"mamba": {"conv",
    "ssm"}}, of an rwkv block {"tm_shift", "cm_shift", "state"}; each is
    updated in place.  A block with ``cross`` attends over the
    encoder: through ``enc_out`` (train/prefill: K/V projected here) or
    the precomputed ``cross_kv`` {"k","v"} [B, S_enc, Hkv, dh] (decode).
    ``windows``: across ranks, the rank's windows
    (``models/attention.py:SeqWindow``) of the dense cache's sequence and
    of the cross K/V's encoder positions (None: whole); a windowed
    cross-attention is the rank's share, combined over its axis."""
    t = cfg.layer_types[pos]
    keep = isinstance(x, PackedArray)
    h = norm_apply(p["ln1"], x, cfg.norm)
    if t == "attn":
        out, _ = attention.attn_apply(
            p["mixer"], h, ctx, cfg, positions=positions, causal=causal,
            kv_cache=None if cache is None else cache["kv"],
            cache_pos=cache_pos, keep_packed=keep, paged=paged,
            window=windows[0])
    elif t == "mamba":
        out, _ = mamba.mamba_apply(p["mixer"], h, ctx, cfg,
                                   cache=None if cache is None else cache["mamba"])
    else:
        out, _ = rwkv6.rwkv_tm_apply(p["mixer"], h, ctx, cfg, cache=cache)
    x = stream_add(x, _as_stream_like(out, x, ctx))
    if "cross" in p:
        hc = norm_apply(p["ln_c"], x, cfg.norm)
        if cross_kv is not None:
            q = maybe_unpack(linear_apply(p["cross"]["wq"], tp_enter(ctx, hc),
                                          ctx, tp="col"))
            b, sq = q.shape[0], q.shape[1]
            q = q.reshape(b, sq, cfg.n_heads, cfg.d_head)
            if cfg.qk_norm:
                q = norm_apply(p["cross"]["q_norm"], q, "rmsnorm")
            if windows[1] is None:
                o = attention.core_attention(
                    q, cross_kv["k"], cross_kv["v"], causal=False,
                    q_pos=torch.zeros((sq,), dtype=torch.int32, device=q.device))
            else:
                o, lse = attention.core_attention_partial(
                    q, cross_kv["k"], cross_kv["v"], q_pos=None, kv_len_mask=None)
                o = attention.combine_ranks(o, lse, windows[1].axis)
            out = linear_apply(p["cross"]["wo"], o.reshape(b, sq, -1), ctx,
                               keep_packed=keep, tp="row")
        else:
            out, _ = attention.attn_apply(
                p["cross"], hc, ctx, cfg, positions=positions, causal=False,
                kv_source=enc_out, keep_packed=keep)
        x = stream_add(x, _as_stream_like(out, x, ctx))
    h2 = norm_apply(p["ln2"], x, cfg.norm)
    aux = AUX_ZERO
    if cfg.moe_on_layer(pos):
        out2, aux = moe.moe_apply(p["ffn"], h2, ctx, cfg, paged=paged)
    elif t == "rwkv":
        out2, _ = rwkv6.rwkv_cm_apply(p["ffn"], h2, ctx, cfg, cache=cache)
    else:
        out2 = mlp_mod.mlp_apply(p["ffn"], h2, ctx, cfg, keep_packed=keep)
    x = stream_add(x, _as_stream_like(out2, x, ctx))
    return x, cache, aux


def group_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, *, cross: bool = False) -> dict:
    """One group of the layer pattern, ``{"p<i>": block}`` unstacked: the
    blocks :func:`layers_init` draws, in its order, for each group."""
    return {f"p{i}": block_init(generator, cfg, i, dtype, cross=cross)
            for i in range(pattern_period(cfg))}


def layers_init(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, *, cross: bool = False) -> dict:
    """Stacked ``{"p<i>": block}`` groups, every leaf ``[G, ...]``, drawn
    block by block and copied into the stack as each is drawn, so the
    memory peak is the stack and one block (a single group is the stack,
    no copy): a moe model's layers fill most of the card, and one of
    jamba's 8-layer groups holds four moe layers.  On the meta device
    (shapes only) one group is drawn: the stack's shape is all there is."""
    period = pattern_period(cfg)
    n = cfg.n_layers // period
    groups = 1 if generator.device.type == "meta" else n

    def put(dst, src, g):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, g)
            else:
                dst[k][g].copy_(v)

    stacked = {}
    for g in range(groups):
        for i in range(period):
            block = block_init(generator, cfg, i, dtype, cross=cross)
            if n == 1:
                stacked[f"p{i}"] = tree_map(lambda t: t[None], block)
                continue
            if g == 0:
                stacked[f"p{i}"] = tree_map(lambda t: t.new_empty((n, *t.shape)),
                                            block)
            put(stacked[f"p{i}"], block, g)
            del block
    return stacked


def _stacked_caches(cfg: ModelConfig, kv, rows: int, dtype: torch.dtype,
                    device) -> dict:
    """Zero ``[G, ...]`` caches, one per pattern slot: ``kv(device)`` for
    an attention slot, the per-row state of ``rows`` rows for a recurrent
    one (mamba's {"mamba": {"conv", "ssm"}}, RWKV-6's {"tm_shift",
    "cm_shift", "state"})."""
    period = pattern_period(cfg)
    meta = torch.device("meta")       # shapes and dtypes only

    def slot(t):
        if t == "attn":
            return {"kv": kv(meta)}
        if t == "mamba":
            return {"mamba": mamba.init_mamba_cache(cfg, rows, dtype, meta)}
        return rwkv6.init_rwkv_cache(cfg, rows, dtype, meta)

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return torch.zeros((cfg.n_layers // period, *tree.shape),
                           dtype=tree.dtype, device=device)

    return stacked({f"p{i}": slot(t)
                    for i, t in enumerate(cfg.layer_types[:period])})


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device) -> dict:
    """Stacked ``[G, ...]`` dense decode caches, one per pattern slot,
    zero: attention K/V ``[G, batch, max_len, Hkv, dh]``, a recurrent
    block's per-row state ``[G, batch, ...]``.  Across ranks a rank's
    window of them: its ``batch`` rows and ``max_len`` positions
    (``ReproModel.init_cache``)."""
    return _stacked_caches(
        cfg, lambda dev: attention.init_kv_cache(cfg, batch, max_len, dtype, dev),
        batch, dtype, device)


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_tokens: int,
                      slots: int, dtype: torch.dtype, device) -> dict:
    """Stacked ``[G, ...]`` caches of continuous batching: an attention
    slot's K/V page pools ``[G, P, T, Hkv, dh]`` (page ids are shared by
    every layer), a recurrent slot's per-slot state ``[G, slots, ...]``."""
    return _stacked_caches(
        cfg, lambda dev: attention.init_paged_kv_cache(cfg, num_pages,
                                                       page_tokens, dtype, dev),
        slots, dtype, device)


class _Slices(tuple):
    """A stacked leaf's G slices (a ``w_split`` tuple is no such leaf)."""


def _unbind(tree):
    """Each tensor leaf ``[G, ...]`` as a tuple of its G slices (one view
    op per leaf, whose gradient is one stack)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return _Slices(tree.unbind(0)) if isinstance(tree, torch.Tensor) else tree


def _group(tree, g: int):
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, _Slices) else tree


def _apply_group(x: Stream, gp: dict, ctx: MatmulContext, cfg: ModelConfig,
                 positions: torch.Tensor, causal: bool,
                 enc_out: Optional[torch.Tensor]):
    """(x', the group's aux losses summed over its blocks)."""
    aux = dict(AUX_ZERO)
    for i in range(pattern_period(cfg)):
        x, _, a = block_apply(gp[f"p{i}"], x, ctx, cfg, i, positions=positions,
                              causal=causal, enc_out=enc_out)
        aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def layers_apply(params_groups: dict, x: Stream, ctx: MatmulContext,
                 cfg: ModelConfig, *, positions: torch.Tensor,
                 causal: bool = True, caches: Optional[dict] = None,
                 cache_pos: Optional[torch.Tensor] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 cross_kv: Optional[dict] = None,
                 paged: Optional[dict] = None, remat: bool = False,
                 aux: Optional[dict] = None,
                 windows: tuple = (None, None)) -> Stream:
    """Run every group in order.

    - train/prefill (``caches`` None): causal unless ``causal=False`` (an
      encoder); ``enc_out`` feeds the cross-attention of a decoder's
      blocks; ``remat`` recomputes each group's forward on the backward
      pass (``torch.utils.checkpoint``, where the JAX package wraps its
      scan body in ``jax.checkpoint``), so only the stream between groups
      is kept; ``aux`` (a dict of the :data:`AUX_ZERO` keys), when given,
      has each group's moe aux losses added to it;
    - dense-cache decode (``caches`` from :func:`init_layer_caches`,
      ``cache_pos`` a 0-d device tensor) and the paged steps: the caches
      are written in place (each group's slice is a view); whisper's
      decoder also reads the stacked ``[G, ...]`` ``cross_kv``; across
      ranks ``windows`` (:func:`block_apply`) reach every layer."""
    period = pattern_period(cfg)
    if caches is None:
        groups = _unbind(params_groups)
        for g in range(cfg.n_layers // period):
            gp = _group(groups, g)
            if remat:
                # the forward draws no random numbers, and a CUDA graph
                # capture may not read the generator's state
                x, aux_g = checkpoint(_apply_group, x, gp, ctx, cfg, positions,
                                      causal, enc_out, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, aux_g = _apply_group(x, gp, ctx, cfg, positions, causal,
                                        enc_out)
            if aux is not None:
                for k in aux:
                    aux[k] = aux[k] + aux_g[k]
        return x
    for g in range(cfg.n_layers // period):
        for i in range(period):
            gp = tree_map(lambda t: t[g], params_groups[f"p{i}"])
            gc = tree_map(lambda t: t[g], caches[f"p{i}"])
            gkv = (None if cross_kv is None
                   else tree_map(lambda t: t[g], cross_kv[f"p{i}"]))
            x, _, _ = block_apply(gp, x, ctx, cfg, i, positions=positions,
                               causal=causal, cache=gc, cache_pos=cache_pos,
                               cross_kv=gkv, paged=paged, windows=windows)
    return x


def lm_init(generator: torch.Generator, cfg: ModelConfig, run: RunConfig) -> dict:
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


def _head_cut(ctx: MatmulContext, cfg: ModelConfig, dtype) -> Optional[tuple]:
    """The tied head's vocab tiles ``[lo, hi)`` on this rank (None: whole)."""
    if ctx.tp is None:
        return None
    from repro_torch.distributed.sharding import head_split
    return head_split(cfg.vocab, cfg.d_model, ctx.tp.rank, ctx.tp.size,
                      ctx.layout(dtype).n_r)


def head_columns(params: dict, ctx: MatmulContext,
                 cfg: ModelConfig) -> Optional[int]:
    """The first vocab column of this rank's share of the logits that
    :func:`logits_apply` computes with ``gather=False``; None where the
    head is whole on every rank."""
    if cfg.tie_embeddings:
        e = params["embed"]["e"]
        cut = _head_cut(ctx, cfg, e.dtype)
        return None if cut is None else min(cut[0] * ctx.layout(e.dtype).n_r,
                                            cfg.vocab)
    split = params["lm_head"].get("w_split")
    if split is None:
        return None
    n_r = ctx.layout(params["lm_head"]["w"].dtype).n_r
    return min(split[1] * n_r, split[3])


def logits_apply(params: dict, x: Stream, ctx: MatmulContext,
                 cfg: ModelConfig, gather: bool = True) -> torch.Tensor:
    """The head, column-parallel across ranks: an untied ``lm_head`` as its
    shard holds it; the tied head over the rank's vocab tiles of the
    (replicated) embedding table, cut by an ``lm_head``'s rule
    (:func:`repro_torch.distributed.sharding.head_split`); the logits
    gathered whole on every rank, or with ``gather=False`` the rank's
    columns (from :func:`head_columns`), for a loss across the ranks.  The
    stream and the table enter the region (their gradients summed over
    the ranks)."""
    x = tp_enter(ctx, x)
    if cfg.tie_embeddings:
        # packs embed.T on every call: pack_rhs reads it back as the
        # contiguous [V, D] table, so no copy precedes the pack kernel
        e = params["embed"]["e"]
        head = {"w": e.T}
        cut = _head_cut(ctx, cfg, e.dtype)
        if cut is not None:
            n_r = ctx.layout(e.dtype).n_r
            head = {"w": ctx.tp.enter(e)[cut[0] * n_r:cut[1] * n_r].T,
                    "w_split": ("col", *cut, cfg.vocab)}
        return maybe_unpack(linear_apply(head, x, ctx, tp="col", gather=gather))
    return maybe_unpack(linear_apply(params["lm_head"], x, ctx, tp="col",
                                     gather=gather))


def lm_apply(params: dict, embeds: torch.Tensor, ctx: MatmulContext,
             cfg: ModelConfig, run: RunConfig, *, positions: torch.Tensor,
             caches: Optional[dict] = None,
             cache_pos: Optional[torch.Tensor] = None,
             paged: Optional[dict] = None,
             last_only: bool = False,
             logits_at: Optional[torch.Tensor] = None,
             gather_logits: bool = True,
             kv_window=None):
    """embeds: [B, S, D].  Returns (logits, caches, aux): logits [B, S, V];
    [B, 1, V] for the last position with ``last_only`` (serving prefill);
    or [B, K, V] at the per-row positions ``logits_at`` ([B] or [B, K]).
    ``caches`` is None in the train/prefill mode and the same object,
    updated in place, in the dense-cache (``cache_pos``) and paged modes; ``aux`` the moe layers'
    aux losses summed over the layers in the train/prefill mode, else
    :data:`AUX_ZERO` (as in the JAX package).  ``run.remat`` recomputes each layer
    group's forward on the backward pass (train mode).  Across ranks
    ``gather_logits=False`` keeps each rank's vocab columns
    (:func:`logits_apply`), and ``kv_window`` is the rank's window of the
    dense caches' sequence (``models/attention.py:SeqWindow``; None:
    whole)."""
    x: Stream = maybe_pack(embeds, ctx)
    aux = dict(AUX_ZERO)
    x = layers_apply(params["groups"], x, ctx, cfg, positions=positions,
                     caches=caches, cache_pos=cache_pos, paged=paged,
                     remat=caches is None and run.remat,
                     aux=aux if caches is None else None,
                     windows=(kv_window, None))
    x = norm_apply(params["ln_f"], x, cfg.norm)
    if logits_at is not None:
        idx = (logits_at if logits_at.ndim == 2 else logits_at[:, None]).long()
        xu = maybe_unpack(x)
        rows = torch.arange(xu.shape[0], device=xu.device)[:, None]
        x = maybe_pack(xu[rows, idx], ctx)
    elif last_only:
        x = maybe_pack(maybe_unpack(x)[:, -1:, :], ctx)
    return logits_apply(params, x, ctx, cfg, gather_logits), caches, aux
