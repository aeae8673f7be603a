"""Encoder-decoder LM (the whisper-small family).

The audio frontend is a stub, as in the JAX package: the model reads
precomputed frame embeddings ``[B, S_enc, d]``; a biased linear projector
and learned positions stand in for the conv stem.  Encoder layers are
bidirectional; decoder layers are causal, with cross-attention over the
encoder output.  Decode computes the cross K/V once per batch
(:func:`compute_cross_kv`) and reads it every step.

The parameter tree is the JAX package's, so its parameters carry across
leaf for leaf (:func:`repro_torch.weights.from_jax_params`).  Where the
JAX package slices ``pe_dec`` at a traced position with
``lax.dynamic_slice_in_dim``, :func:`encdec_decode_step` indexes it with a
device tensor, so no step reads its position back to the host.

Across the ranks of a mesh the products are the Megatron ones of the
decoder-only family (``core/linear.py``), the learned positions, which
the rules cut over ``model`` along ``d``, are gathered whole for the rows
a call reads (:func:`_pe_rows`), and the decode caches are the rank's
windows (``models/attention.py:SeqWindow``): :func:`compute_cross_kv`
keeps the rank's encoder positions of the cross K/V, and
:func:`encdec_decode_step` attends over them as a share combined over
the ranks.
"""

from __future__ import annotations

import dataclasses
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (embed_apply, embed_init, maybe_pack,
                                       maybe_unpack, norm_apply, norm_init)

__all__ = ["enc_config", "encdec_init", "encode", "decode_train",
           "compute_cross_kv", "encdec_forward", "encdec_decode_step"]


def _pe_rows(pe: torch.Tensor, rows, ctx: MatmulContext, d: int) -> torch.Tensor:
    """The learned positions ``pe[rows]`` [n, d], whole: across ranks the
    rank holds the columns ``param_specs`` cut over ``model`` (its share of
    ``d``), gathered over the model ranks."""
    x = pe[rows]
    if x.shape[-1] == d:
        return x
    from repro_torch.distributed.sharding import tile_range
    lo = tile_range(d, ctx.tp.size, ctx.tp.rank)[0]
    return ctx.tp.gather(x.contiguous(), -1, lo, d)


def enc_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: ``encoder_layers`` layers of the same widths."""
    return dataclasses.replace(cfg, name=cfg.name + "-enc",
                               n_layers=cfg.encoder_layers, moe=False,
                               encoder_layers=0)


def encdec_init(generator: torch.Generator, cfg: ModelConfig, run: RunConfig,
                *, max_src: int, max_tgt: int) -> dict:
    """Random parameters with the JAX package's tree, shapes and scales:
    learned positions ``pe_enc`` [max_src, d] and ``pe_dec`` [max_tgt, d]
    (N(0, 0.01^2)), the frontend projector, the encoder stack and the
    decoder stack with cross-attention."""
    dtype = getattr(torch, run.param_dtype)
    d = cfg.d_model

    def pe(n):
        return (torch.randn((n, d), generator=generator, device=generator.device)
                * 0.01).to(dtype)

    return {
        "embed": embed_init(generator, cfg.vocab, d, dtype),
        "pe_enc": pe(max_src),
        "pe_dec": pe(max_tgt),
        "frontend_proj": linear_init(generator, d, d, bias=True, dtype=dtype),
        "enc_groups": tfm.layers_init(generator, enc_config(cfg), dtype),
        "enc_ln_f": norm_init(cfg.norm, d, dtype),
        "dec_groups": tfm.layers_init(generator, cfg, dtype, cross=True),
        "ln_f": norm_init(cfg.norm, d, dtype),
    }


def encode(params: dict, frames: torch.Tensor, ctx: MatmulContext,
           cfg: ModelConfig, run: RunConfig) -> torch.Tensor:
    """frames [B, S_enc, d] -> the encoder output [B, S_enc, d].
    ``run.remat`` recomputes each layer's forward on the backward pass, as
    the JAX package's ``layers_apply`` does."""
    s = frames.shape[1]
    x = linear_apply(params["frontend_proj"], frames, ctx)
    x = x + _pe_rows(params["pe_enc"], slice(0, s), ctx, cfg.d_model).to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = tfm.layers_apply(params["enc_groups"], maybe_pack(x, ctx), ctx,
                         enc_config(cfg), positions=positions, causal=False,
                         remat=run.remat)
    return maybe_unpack(norm_apply(params["enc_ln_f"], x, cfg.norm))


def decode_train(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 ctx: MatmulContext, cfg: ModelConfig,
                 run: RunConfig) -> torch.Tensor:
    """The decoder over whole sequences ``tokens`` [B, S], attending over
    ``enc_out``.  Returns logits [B, S, V]; ``run.remat`` as for
    :func:`encode`."""
    s = tokens.shape[1]
    x = embed_apply(params["embed"], tokens)
    x = x + _pe_rows(params["pe_dec"], slice(0, s), ctx, cfg.d_model).to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = tfm.layers_apply(params["dec_groups"], maybe_pack(x, ctx), ctx, cfg,
                         positions=positions, causal=True, enc_out=enc_out,
                         remat=run.remat)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return tfm.logits_apply(params, x, ctx, cfg)


def encdec_forward(params: dict, batch: dict, ctx: MatmulContext,
                   cfg: ModelConfig, run: RunConfig) -> torch.Tensor:
    """Encoder over ``batch["frames"]``, decoder over ``batch["tokens"]``;
    logits [B, S, V]."""
    enc_out = encode(params, batch["frames"], ctx, cfg, run)
    return decode_train(params, batch["tokens"], enc_out, ctx, cfg, run)


def compute_cross_kv(params: dict, enc_out: torch.Tensor, ctx: MatmulContext,
                     cfg: ModelConfig, window=None) -> dict:
    """The decoder's cross-attention K/V from the encoder output, stacked
    ``[G, B, S_enc, Hkv, dh]`` per pattern slot as the JAX package's scan
    leaves them: ``{"p<i>": {"k", "v"}}``.  ``window`` (across ranks, a
    ``SeqWindow`` of the encoder positions): the rank's positions only."""
    b, s = enc_out.shape[0], enc_out.shape[1]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    groups = cfg.n_layers // tfm.pattern_period(cfg)
    out = {}
    for name, bp in params["dec_groups"].items():
        ks, vs = [], []
        for g in range(groups):
            cp = tfm.tree_map(lambda t: t[g], bp["cross"])
            k = maybe_unpack(linear_apply(cp["wk"], enc_out, ctx)).reshape(b, s, hkv, dh)
            v = maybe_unpack(linear_apply(cp["wv"], enc_out, ctx)).reshape(b, s, hkv, dh)
            if cfg.qk_norm:
                k = norm_apply(cp["k_norm"], k, "rmsnorm")
            ks.append(k)
            vs.append(v)
        out[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if window is not None:
            out[name] = {k: t[:, :, window.lo:window.lo + window.held].contiguous()
                         for k, t in out[name].items()}
    return out


def encdec_decode_step(params: dict, caches: dict, token: torch.Tensor,
                       pos: torch.Tensor, ctx: MatmulContext, cfg: ModelConfig,
                       run: RunConfig, windows: tuple = (None, None)):
    """Decoder tokens ``token`` [B, s] at positions ``pos ..`` against
    ``caches`` = {"layers": [G, ...] dense caches, "cross": [G, ...] cross
    K/V}.  ``pos`` is a 0-d device tensor: the learned positions are
    gathered at ``clamp(pos, 0, max_tgt - s) + arange(s)`` (the clamp of
    ``lax.dynamic_slice_in_dim``) on the device.  The layer caches are
    written in place.  ``windows``: across ranks, the rank's windows of the
    layer caches and of the cross K/V (``transformer.block_apply``).
    Returns (logits [B, s, V], caches)."""
    del run
    s = token.shape[1]
    x = embed_apply(params["embed"], token)
    pe = params["pe_dec"]
    ar = torch.arange(s, device=x.device)
    x = x + _pe_rows(pe, torch.clamp(pos.long(), 0, pe.shape[0] - s) + ar, ctx,
                     cfg.d_model).to(x.dtype)
    positions = pos + ar.to(pos.dtype)             # 1-D: shared by the batch
    x = tfm.layers_apply(params["dec_groups"], maybe_pack(x, ctx), ctx, cfg,
                         positions=positions, causal=True,
                         caches=caches["layers"], cache_pos=pos,
                         cross_kv=caches["cross"], windows=windows)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return tfm.logits_apply(params, x, ctx, cfg), caches
