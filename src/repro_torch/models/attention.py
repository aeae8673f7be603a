"""Grouped-query attention with packed-layout projections.

The Q/K/V/O weight matmuls run through the packed pipeline.  The flat
serving step scatters K/V into the page pool and runs the ragged
paged-attention kernel; the paged step (dense chunked and monolithic)
scatters into the pool, gathers each row's pages back and attends through
:func:`core_attention`, which the JAX package also computes outside
Pallas.  Only the two paged modes of :func:`attn_apply` are ported so
far; the others raise.  No mode reads an index back to the host, so a
step can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.kernels.ragged_attn.ops import ragged_attention
from repro_torch.models.common import (Stream, apply_rope, maybe_unpack,
                                       norm_apply, norm_init)

__all__ = ["attn_init", "attn_apply", "init_paged_kv_cache", "core_attention",
           "paged_kv_update", "flat_paged_kv_update"]


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype = torch.float32) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    bias = cfg.attn_bias
    p = {
        "wq": linear_init(generator, d, hq * dh, bias=bias, dtype=dtype),
        "wk": linear_init(generator, d, hkv * dh, bias=bias, dtype=dtype),
        "wv": linear_init(generator, d, hkv * dh, bias=bias, dtype=dtype),
        "wo": linear_init(generator, hq * dh, d, dtype=dtype,
                          scale=(hq * dh) ** -0.5 / max(1, cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init("rmsnorm", dh, dtype)
        p["k_norm"] = norm_init("rmsnorm", dh, dtype)
    return p


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_tokens: int,
                        dtype: torch.dtype, device) -> dict:
    """Paged pool of ``num_pages`` pages of ``page_tokens`` tokens; page 0
    is the trash page that padded positions write to."""
    shp = (num_pages, page_tokens, cfg.n_kv_heads, cfg.d_head)
    return {"k_pages": torch.zeros(shp, dtype=dtype, device=device),
            "v_pages": torch.zeros(shp, dtype=dtype, device=device)}


def paged_kv_update(cache: dict, k: torch.Tensor, v: torch.Tensor, *,
                    block_tables: torch.Tensor, lens: torch.Tensor,
                    new_counts: torch.Tensor):
    """Scatter a ``[B, S]`` step's K/V into the page pool, in place, and
    gather each row's pages back.

    Row ``b``'s token ``s`` sits at position ``lens[b] + s`` and is valid
    iff ``s < new_counts[b]``; it writes page ``block_tables[b, min(pos //
    T, MP - 1)]`` at offset ``pos % T``, and an invalid one writes the
    trash page 0 at offset 0.  cache: {"k_pages","v_pages"} [P, T, Hkv,
    dh]; k, v: [B, S, Hkv, dh]; block_tables: [B, MP].  Returns (cache,
    k_all [B, MP*T, Hkv, dh], v_all, kv_len_mask [B, MP*T]), the mask
    holding the first ``lens + new_counts`` positions of each row."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    t = kp.shape[1]
    b, s = k.shape[0], k.shape[1]
    bt = block_tables.long()
    ar = torch.arange(s, device=k.device)
    pos = lens.long()[:, None] + ar[None, :]                   # [B, S]
    valid = ar[None, :] < new_counts.long()[:, None]
    slot = torch.clamp(pos // t, max=bt.shape[1] - 1)
    page = torch.where(valid, torch.gather(bt, 1, slot), 0)
    off = torch.where(valid, pos % t, 0)
    kp[page, off] = k.to(kp.dtype)
    vp[page, off] = v.to(vp.dtype)
    k_all = kp[bt].reshape(b, -1, *kp.shape[2:])
    v_all = vp[bt].reshape(b, -1, *vp.shape[2:])
    mask = torch.arange(k_all.shape[1], device=k.device)[None, :] \
        < (lens.long() + new_counts.long())[:, None]
    return cache, k_all, v_all, mask


def flat_paged_kv_update(cache: dict, k: torch.Tensor, v: torch.Tensor, *,
                         block_tables: torch.Tensor, row_ids: torch.Tensor,
                         q_pos: torch.Tensor) -> dict:
    """Scatter one flat ``[1, W]`` stream's K/V into the page pool, in place.

    Position ``i`` belongs to row ``row_ids[i]`` (-1 = padding, routed to
    the trash page) at absolute position ``q_pos[i]``: it writes page
    ``block_tables[row, min(q_pos // T, MP - 1)]`` at offset ``q_pos % T``.
    cache: {"k_pages","v_pages"} [P, T, Hkv, dh]; k, v: [1, W, Hkv, dh].
    Only padding positions share a destination (page 0), so the order of
    duplicate writes never matters.  Returns ``cache``."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    t = kp.shape[1]
    row_ids, q_pos = row_ids.long(), q_pos.long()
    valid = row_ids >= 0
    slot = torch.clamp(q_pos // t, max=block_tables.shape[1] - 1)
    page = torch.where(valid, block_tables[row_ids.clamp(min=0), slot].long(), 0)
    off = torch.where(valid, q_pos % t, 0)
    kp[page, off] = k[0].to(kp.dtype)
    vp[page, off] = v[0].to(vp.dtype)
    return cache


def core_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_pos: torch.Tensor,
                   kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,Sq,Hq,dh]; k,v: [B,Skv,Hkv,dh].  float32 softmax, GQA grouping.
    ``q_pos``: [Sq] or [B,Sq] absolute query positions for the causal mask;
    ``kv_len_mask``: optional [B,Skv] validity mask."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * dh ** -0.5
    kv_pos = torch.arange(skv, device=q.device)
    # -1e30 as a Python scalar, not a tensor built from one: no copy from
    # the host, which a captured step may not make
    neg = -1e30
    if causal:
        if q_pos.ndim == 1:
            bias = torch.where(q_pos[:, None] >= kv_pos[None, :], 0.0, neg)
            scores = scores + bias[None, None, None, :, :]
        else:
            m = q_pos[:, None, None, :, None] >= kv_pos[None, None, None, None, :]
            scores = torch.where(m, scores, neg)
    if kv_len_mask is not None:
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores, neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def attn_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig, *,
               positions: torch.Tensor, kv_cache: dict,
               keep_packed: bool = False, paged: Optional[dict] = None):
    """The two paged modes.  Q/K/V projections (unpacked at exit) -> RoPE
    -> in-place K/V scatter -> attention -> O projection (kept packed when
    ``keep_packed``).  Returns (out_stream, kv_cache).

    - flat: ``paged`` carries {block_tables [B,MP], row_ids [W], q_pos
      [W], and on the card the ragged-attention plan} and x is one
      ``[1, W]`` stream; attention is the ragged paged kernel.
    - paged (dense chunked and monolithic): ``paged`` carries
      {block_tables [B,MP], lens [B], new_counts [B]}, x is ``[B, S]`` and
      ``positions`` [B, S]; each row attends over its gathered pages
      through :func:`core_attention` with per-row 2-D positions."""
    if paged is None:
        raise NotImplementedError("only the paged attention modes are "
                                  "ported so far")
    dh, hq, hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    q = maybe_unpack(linear_apply(params["wq"], x, ctx))
    k = maybe_unpack(linear_apply(params["wk"], x, ctx))
    v = maybe_unpack(linear_apply(params["wv"], x, ctx))
    b, sq = q.shape[0], q.shape[1]
    q = q.reshape(b, sq, hq, dh)
    k = k.reshape(b, sq, hkv, dh)
    v = v.reshape(b, sq, hkv, dh)
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q, "rmsnorm")
        k = norm_apply(params["k_norm"], k, "rmsnorm")
    if cfg.rope != "none":
        pct = cfg.rope_pct if cfg.rope == "partial2d" else 1.0
        q, k = apply_rope(q, k, positions, theta=cfg.rope_theta, pct=pct)
    if "row_ids" in paged:
        kv_cache = flat_paged_kv_update(
            kv_cache, k, v, block_tables=paged["block_tables"],
            row_ids=paged["row_ids"], q_pos=paged["q_pos"])
        out = ragged_attention(
            q[0].contiguous(), kv_cache["k_pages"], kv_cache["v_pages"],
            block_tables=paged["block_tables"], row_ids=paged["row_ids"],
            q_pos=paged["q_pos"], plan=paged.get("plan"))[None]
    else:
        kv_cache, k_all, v_all, mask = paged_kv_update(
            kv_cache, k, v, block_tables=paged["block_tables"],
            lens=paged["lens"], new_counts=paged["new_counts"])
        out = core_attention(q, k_all, v_all, causal=True, q_pos=positions,
                             kv_len_mask=mask)
    out = linear_apply(params["wo"], out.reshape(b, sq, hq * dh), ctx,
                       keep_packed=keep_packed)
    return out, kv_cache
