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
    """frames [B, S_enc, d] -> the encoder output [B, S_enc, d]."""
    del run
    s = frames.shape[1]
    x = linear_apply(params["frontend_proj"], frames, ctx)
    x = x + params["pe_enc"][:s].to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = tfm.layers_apply(params["enc_groups"], maybe_pack(x, ctx), ctx,
                         enc_config(cfg), positions=positions, causal=False)
    return maybe_unpack(norm_apply(params["enc_ln_f"], x, cfg.norm))


def decode_train(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 ctx: MatmulContext, cfg: ModelConfig,
                 run: RunConfig) -> torch.Tensor:
    """The decoder over whole sequences ``tokens`` [B, S], attending over
    ``enc_out``.  Returns logits [B, S, V]."""
    del run
    s = tokens.shape[1]
    x = embed_apply(params["embed"], tokens)
    x = x + params["pe_dec"][:s].to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = tfm.layers_apply(params["dec_groups"], maybe_pack(x, ctx), ctx, cfg,
                         positions=positions, causal=True, enc_out=enc_out)
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return tfm.logits_apply(params, x, ctx, cfg)


def encdec_forward(params: dict, batch: dict, ctx: MatmulContext,
                   cfg: ModelConfig, run: RunConfig) -> torch.Tensor:
    """Encoder over ``batch["frames"]``, decoder over ``batch["tokens"]``;
    logits [B, S, V]."""
    enc_out = encode(params, batch["frames"], ctx, cfg, run)
    return decode_train(params, batch["tokens"], enc_out, ctx, cfg, run)


def compute_cross_kv(params: dict, enc_out: torch.Tensor, ctx: MatmulContext,
                     cfg: ModelConfig) -> dict:
    """The decoder's cross-attention K/V from the encoder output, stacked
    ``[G, B, S_enc, Hkv, dh]`` per pattern slot as the JAX package's scan
    leaves them: ``{"p<i>": {"k", "v"}}``."""
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
    return out


def encdec_decode_step(params: dict, caches: dict, token: torch.Tensor,
                       pos: torch.Tensor, ctx: MatmulContext, cfg: ModelConfig,
                       run: RunConfig):
    """Decoder tokens ``token`` [B, s] at positions ``pos ..`` against
    ``caches`` = {"layers": [G, ...] dense caches, "cross": [G, ...] cross
    K/V}.  ``pos`` is a 0-d device tensor: the learned positions are
    gathered at ``clamp(pos, 0, max_tgt - s) + arange(s)`` (the clamp of
    ``lax.dynamic_slice_in_dim``) on the device.  The layer caches are
    written in place.  Returns (logits [B, s, V], caches)."""
    del run
    s = token.shape[1]
    x = embed_apply(params["embed"], token)
    pe = params["pe_dec"]
    ar = torch.arange(s, device=x.device)
    x = x + pe[torch.clamp(pos.long(), 0, pe.shape[0] - s) + ar].to(x.dtype)
    positions = pos + ar.to(pos.dtype)             # 1-D: shared by the batch
    x = tfm.layers_apply(params["dec_groups"], maybe_pack(x, ctx), ctx, cfg,
                         positions=positions, causal=True,
                         caches=caches["layers"], cache_pos=pos,
                         cross_kv=caches["cross"])
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return tfm.logits_apply(params, x, ctx, cfg), caches
