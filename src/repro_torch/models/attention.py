"""Grouped-query attention with packed-layout projections.

The Q/K/V/O weight matmuls run through the packed pipeline.  The flat
serving step scatters K/V into the page pool and runs the ragged
paged-attention kernel; the paged step (dense chunked and monolithic)
scatters into the pool, gathers each row's pages back and attends through
:func:`core_attention`, which the JAX package also computes outside
Pallas.  The train/prefill mode (no cache) attends over the whole
sequence through :func:`core_attention`, or :func:`chunked_attention`
past 512 positions, causally or not (whisper's encoder).  The dense-cache
mode (the static batch loop) writes K/V at a device-side position and
attends over the whole cache; cross-attention reads K/V from an encoder
output.  No mode reads an index back to the host, so a step can be
captured in a CUDA graph.

Across the ranks of a mesh's ``model`` axis (``ctx.tp``) the projections
are the JAX package's Megatron products (Q/K/V column-parallel, gathered
whole; O row-parallel; in the train/prefill mode every rank then attends
over every head, and the O product's slice of the whole output enters
its region, so the gradients are the one-rank ones) and, where
``cache_specs`` shard the pools' page
dim, each rank holds the global pages ``[page_lo, page_lo + page_count)``
(``paged["kv_shard"]``) as its pages ``0 .. page_count - 1`` plus a trash
slot of its own after them (``page_count``): a rank writes the K/V of the
positions whose page it holds, every other write goes to its trash slot,
and attention is a flash-decode across ranks: each rank attends over its
own pages (the flat step through ``ragged_attention_partial``, the paged
step through :func:`core_attention_partial`), and :func:`combine_ranks`
weighs the ranks' outputs by their log-sum-exps.

The dense-cache mode across ranks (the reference's decode cell): where
``cache_specs`` cut a dense cache's sequence dim, a rank's cache is its
window, the global positions ``[lo, lo + S_rank)`` of ``total``
(:class:`SeqWindow`, the axis of ranks it is cut over beside them).  The
write clamps its start on the global ``total``, as
``lax.dynamic_update_slice`` does, and the rank writes the positions it
holds (:func:`dense_kv_update`); the length and causal masks are built on
global key positions; each rank attends over its window
(:func:`core_attention_partial`) and :func:`combine_ranks` weighs the
shares over the window's axis.  Whisper's cross K/V is cut so over the
encoder positions, and its cross-attention is such a share, not causal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import (MatmulContext, gather_columns,
                                     linear_apply, linear_init, tp_enter)
from repro_torch.kernels.ragged_attn.ops import (ragged_attention,
                                                 ragged_attention_partial)
from repro_torch.kernels.ragged_attn.ref import combine_partials
from repro_torch.models.common import (Stream, apply_rope, maybe_unpack,
                                       norm_apply, norm_init)

__all__ = ["attn_init", "attn_apply", "init_kv_cache", "init_paged_kv_cache",
           "core_attention", "core_attention_partial", "combine_ranks",
           "chunked_attention", "dense_kv_update", "paged_kv_update",
           "flat_paged_kv_update", "local_pages", "SeqWindow"]


class SeqWindow(NamedTuple):
    """A rank's window of a dense cache's sequence dim: the global
    positions ``[lo, lo + n)`` of ``total``, ``n`` the rank's cache's
    extent there, cut over the ranks of ``axis`` (a
    :class:`~repro_torch.distributed.comm.MeshAxis`), over which the
    attention's shares are combined."""
    lo: int
    total: int
    axis: object

    @property
    def held(self) -> int:
        """The positions the rank holds (the axis's ranks divide ``total``:
        ``cache_specs`` keeps a dim whole that they do not)."""
        return self.total // self.axis.size


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


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> dict:
    """The dense decode cache: K and V ``[batch, max_len, Hkv, dh]``, zero."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def dense_kv_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                    cache_pos: torch.Tensor,
                    window: Optional[SeqWindow] = None):
    """Write a ``[B, S]`` step's K/V into the dense cache at positions
    ``cache_pos ..`` in place, and mask the cache to what is written.

    ``cache_pos`` is a 0-d integer tensor on the cache's device: the write
    and the mask are device work, with no read of the position on the
    host.  The start is clamped to ``[0, S_max - S]`` as
    ``lax.dynamic_update_slice`` clamps it; the mask holds the first
    ``cache_pos + S`` positions of every row.  cache: {"k","v"} [B, S_max,
    Hkv, dh].  Returns (cache, k_all, v_all, kv_len_mask [B, S_max]).

    ``window`` (across ranks): the cache holds the global positions
    ``[window.lo, window.lo + n)`` of ``window.total``; the clamp is on
    ``window.total``, the rank writes only the positions it holds (a
    write of more positions than it holds spans ranks), and the mask is
    over its positions, by their global index."""
    kc, vc = cache["k"], cache["v"]
    b, s, s_max = k.shape[0], k.shape[1], kc.shape[1]
    ar = torch.arange(s, device=kc.device)
    if window is None:
        idx = torch.clamp(cache_pos.long(), 0, s_max - s) + ar
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
        mask = torch.arange(s_max, device=kc.device) < cache_pos.long() + s
        return cache, kc, vc, mask[None, :].expand(b, s_max)
    start = torch.clamp(cache_pos.long(), 0, window.total - s)
    # each written position as a local index, those off the window clamped
    # onto its edges; every index carries the value its position ends up
    # with (the new K/V where the rank holds a written position, the
    # cache's own elsewhere), so indices written twice agree
    local = torch.clamp(start + ar - window.lo, 0, s_max - 1)
    src = local + window.lo - start
    ok = ((src >= 0) & (src < s))[None, :, None, None]
    src = torch.clamp(src, 0, s - 1)
    kc.index_copy_(1, local, torch.where(ok, k[:, src].to(kc.dtype), kc[:, local]))
    vc.index_copy_(1, local, torch.where(ok, v[:, src].to(vc.dtype), vc[:, local]))
    pos = window.lo + torch.arange(s_max, device=kc.device)
    mask = pos < cache_pos.long() + s
    return cache, kc, vc, mask[None, :].expand(b, s_max)


def init_paged_kv_cache(cfg: ModelConfig, num_pages: int, page_tokens: int,
                        dtype: torch.dtype, device) -> dict:
    """Paged pool of ``num_pages`` pages of ``page_tokens`` tokens; page 0
    is the trash page that padded positions write to."""
    shp = (num_pages, page_tokens, cfg.n_kv_heads, cfg.d_head)
    return {"k_pages": torch.zeros(shp, dtype=dtype, device=device),
            "v_pages": torch.zeros(shp, dtype=dtype, device=device)}


def local_pages(page: torch.Tensor, kv_shard) -> tuple:
    """Global page ids as a rank's pool indices: (index, held), the pages
    ``[page_lo, page_lo + page_count)`` of ``kv_shard`` at ``page -
    page_lo`` and every other page at the rank's trash slot
    ``page_count``; without a shard the ids themselves, all held."""
    if kv_shard is None:
        return page, torch.ones_like(page, dtype=torch.bool)
    lo, count = kv_shard
    local = page - lo
    held = (local >= 0) & (local < count)
    return torch.where(held, local, count), held


def paged_kv_update(cache: dict, k: torch.Tensor, v: torch.Tensor, *,
                    block_tables: torch.Tensor, lens: torch.Tensor,
                    new_counts: torch.Tensor, kv_shard=None):
    """Scatter a ``[B, S]`` step's K/V into the page pool, in place, and
    gather each row's pages back.

    Row ``b``'s token ``s`` sits at position ``lens[b] + s`` and is valid
    iff ``s < new_counts[b]``; it writes page ``block_tables[b, min(pos //
    T, MP - 1)]`` at offset ``pos % T``, and an invalid one writes the
    trash page 0 at offset 0.  cache: {"k_pages","v_pages"} [P, T, Hkv,
    dh]; k, v: [B, S, Hkv, dh]; block_tables: [B, MP].  Returns (cache,
    k_all [B, MP*T, Hkv, dh], v_all, kv_len_mask [B, MP*T]), the mask
    holding the first ``lens + new_counts`` positions of each row.

    ``kv_shard`` (a rank's ``(page_lo, page_count)``): the pool holds only
    those pages (module docstring); the write and the gather go through
    :func:`local_pages`, and the mask also drops every key of a page the
    rank does not hold."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    t = kp.shape[1]
    b, s = k.shape[0], k.shape[1]
    bt = block_tables.long()
    ar = torch.arange(s, device=k.device)
    pos = lens.long()[:, None] + ar[None, :]                   # [B, S]
    valid = ar[None, :] < new_counts.long()[:, None]
    slot = torch.clamp(pos // t, max=bt.shape[1] - 1)
    page = torch.where(valid, torch.gather(bt, 1, slot), 0)
    page = local_pages(page, kv_shard)[0]
    off = torch.where(valid, pos % t, 0)
    kp[page, off] = k.to(kp.dtype)
    vp[page, off] = v.to(vp.dtype)
    bt, held = local_pages(bt, kv_shard)
    k_all = kp[bt].reshape(b, -1, *kp.shape[2:])
    v_all = vp[bt].reshape(b, -1, *vp.shape[2:])
    mask = torch.arange(k_all.shape[1], device=k.device)[None, :] \
        < (lens.long() + new_counts.long())[:, None]
    if kv_shard is not None:
        mask = mask & held.repeat_interleave(t, dim=1)
    return cache, k_all, v_all, mask


def flat_paged_kv_update(cache: dict, k: torch.Tensor, v: torch.Tensor, *,
                         block_tables: torch.Tensor, row_ids: torch.Tensor,
                         q_pos: torch.Tensor, kv_shard=None) -> dict:
    """Scatter one flat ``[1, W]`` stream's K/V into the page pool, in place.

    Position ``i`` belongs to row ``row_ids[i]`` (-1 = padding, routed to
    the trash page) at absolute position ``q_pos[i]``: it writes page
    ``block_tables[row, min(q_pos // T, MP - 1)]`` at offset ``q_pos % T``.
    cache: {"k_pages","v_pages"} [P, T, Hkv, dh]; k, v: [1, W, Hkv, dh].
    Only padding positions share a destination (page 0), so the order of
    duplicate writes never matters.  ``kv_shard``: a rank's pool
    (:func:`local_pages`), whose trash slot takes every write of a page
    it does not hold.  Returns ``cache``."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    t = kp.shape[1]
    row_ids, q_pos = row_ids.long(), q_pos.long()
    valid = row_ids >= 0
    slot = torch.clamp(q_pos // t, max=block_tables.shape[1] - 1)
    page = torch.where(valid, block_tables[row_ids.clamp(min=0), slot].long(), 0)
    page = local_pages(page, kv_shard)[0]
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


def core_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, q_pos: Optional[torch.Tensor],
                           kv_len_mask: Optional[torch.Tensor],
                           kv_lo: int = 0) -> tuple:
    """A rank's share of a causal attention: q [B,Sq,Hq,dh] at positions
    ``q_pos`` [B,Sq] or [Sq] (None: not causal); k, v [B,Skv,Hkv,dh], the
    keys at the global positions ``kv_lo ..``, with ``kv_len_mask``
    [B,Skv] those the rank counts (None: all).  Returns (out [B,Sq,Hq,dh]
    in q's dtype, lse [B,Sq,Hq] float32): the softmax over the counted
    keys and its log-sum-exp; a row with none gives zeros and ``-inf``
    (:func:`combine_ranks` weighs it 0)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * dh ** -0.5
    m = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if q_pos is not None:
        if q_pos.ndim == 1:
            q_pos = q_pos[None, :].expand(b, sq)
        kv_pos = kv_lo + torch.arange(skv, device=q.device)
        m = m & (q_pos[:, :, None] >= kv_pos[None, None, :])
    if kv_len_mask is not None:
        m = m & kv_len_mask[:, None, :]
    scores = scores.masked_fill(~m[:, None, None], -torch.inf)
    top = scores.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isinf(top), 0.0, top)
    e = torch.exp(scores - top)
    l = e.sum(dim=-1)                                      # [B, h, g, Sq]
    out = torch.einsum("bhgqk,bkhd->bqhgd", e, v.float()) \
        / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    lse = torch.where(l > 0, top[..., 0] + torch.log(l), -torch.inf)
    return (out.reshape(b, sq, hq, dh).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, sq, hq))


def combine_ranks(out: torch.Tensor, lse: torch.Tensor, axis) -> torch.Tensor:
    """The flash-decode's combine across the ranks of ``axis`` (any
    :class:`~repro_torch.distributed.comm.MeshAxis`: the model axis of a
    page-sharded pool, the :class:`~repro_torch.distributed.comm.SeqAxis`
    of a dense cache's windows): every rank's
    partial ``out`` [..., H, dh] and float32 ``lse`` [..., H] gathered in
    one collective, then on every rank alike
    ``sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M)``, ``M`` the
    rows' max over the ranks, in float32, in rank order
    (``kernels/ragged_attn/ref.py:combine_partials``), cast to ``out``'s
    dtype.  A share with ``lse = -inf`` weighs 0, and a row no rank holds
    comes out 0."""
    mine = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    every = axis.gather(mine, 0, axis.rank, axis.size)
    return combine_partials(list(every[..., :-1]),
                            list(every[..., -1])).to(out.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_pos: torch.Tensor,
                      chunk: int = 512) -> torch.Tensor:
    """Memory-linear attention: the queries in chunks of ``chunk`` (scores
    [B,h,g,chunk,Skv] instead of [B,h,g,Sq,Skv]), each chunk recomputed on
    the backward pass (``torch.utils.checkpoint``, where the JAX package
    uses ``jax.checkpoint``).  Numerics are :func:`core_attention`'s.  Falls
    back to it, as the JAX package does, unless ``Sq`` is a multiple of
    ``chunk`` above it and the positions are shared by the batch (1-D)."""
    b, sq, hq, dh = q.shape
    if sq <= chunk or sq % chunk != 0 or q_pos.ndim != 1:
        return core_attention(q, k, v, causal=causal, q_pos=q_pos)
    # no random numbers drawn, so no generator state kept (a CUDA graph
    # capture may not read it)
    outs = [checkpoint(core_attention, q[:, i:i + chunk], k, v, causal=causal,
                       q_pos=q_pos[i:i + chunk], use_reentrant=False,
                       preserve_rng_state=False)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def attn_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool = True,
               kv_cache: Optional[dict] = None,
               cache_pos: Optional[torch.Tensor] = None,
               kv_source: Optional[torch.Tensor] = None,
               keep_packed: bool = False, paged: Optional[dict] = None,
               window: Optional[SeqWindow] = None):
    """Q/K/V projections (unpacked at exit) -> RoPE -> attention -> O
    projection (kept packed when ``keep_packed``).  Returns (out_stream,
    kv_cache).

    - train/prefill: no ``kv_cache`` and no ``paged``; x is ``[B, S]`` and
      ``positions`` [S]; attention over the whole sequence (causal unless
      ``causal=False``), :func:`chunked_attention` past 512 positions, as
      in the JAX package.
    - dense-cache decode: ``kv_cache`` {"k","v"} [B, S_max, Hkv, dh] and
      ``cache_pos`` a 0-d device tensor; K/V are written at ``cache_pos``
      in place (:func:`dense_kv_update`) and the queries attend over the
      cache up to ``cache_pos + S``, causally by ``positions`` [S].
    - cross-attention: ``kv_source`` [B, S_enc, D] (the encoder output)
      gives K and V; no RoPE, not causal, no cache.
    - flat: ``paged`` carries {block_tables [B,MP], row_ids [W], q_pos
      [W], and on the card the ragged-attention plan} and x is one
      ``[1, W]`` stream; K/V are scattered into the pool in place and
      attention is the ragged paged kernel.
    - paged (dense chunked and monolithic): ``paged`` carries
      {block_tables [B,MP], lens [B], new_counts [B]}, x is ``[B, S]`` and
      ``positions`` [B, S]; K/V are scattered in place and each row attends
      over its gathered pages through :func:`core_attention` with per-row
      2-D positions.
    - either paged mode across ranks: ``paged["kv_shard"]``, the rank's
      pages (module docstring).
    - dense-cache decode across ranks: ``window``, the rank's window of
      the cache's sequence (module docstring)."""
    dh, hq, hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    x = tp_enter(ctx, x)
    kv_in = x if kv_source is None else tp_enter(ctx, kv_source)
    kv_tp = "col" if hkv >= ctx.tp_size else None
    q, k, v = gather_columns(ctx, [
        (params[w], maybe_unpack(linear_apply(params[w], src, ctx, tp=tp,
                                              gather=False)))
        for w, src, tp in (("wq", x, "col"), ("wk", kv_in, kv_tp),
                           ("wv", kv_in, kv_tp))])
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    q = q.reshape(b, sq, hq, dh)
    k = k.reshape(b, skv, hkv, dh)
    v = v.reshape(b, skv, hkv, dh)
    if cfg.qk_norm:
        q = norm_apply(params["q_norm"], q, "rmsnorm")
        k = norm_apply(params["k_norm"], k, "rmsnorm")
    if cfg.rope != "none" and kv_source is None:
        pct = cfg.rope_pct if cfg.rope == "partial2d" else 1.0
        q, k = apply_rope(q, k, positions, theta=cfg.rope_theta, pct=pct)
    shard = None if paged is None else paged.get("kv_shard")
    if paged is not None and "row_ids" in paged:
        kv_cache = flat_paged_kv_update(
            kv_cache, k, v, block_tables=paged["block_tables"],
            row_ids=paged["row_ids"], q_pos=paged["q_pos"], kv_shard=shard)
        args = (q[0].contiguous(), kv_cache["k_pages"], kv_cache["v_pages"])
        kw = dict(block_tables=paged["block_tables"], row_ids=paged["row_ids"],
                  q_pos=paged["q_pos"], plan=paged.get("plan"))
        if shard is None:
            out = ragged_attention(*args, **kw)[None]
        else:
            o, lse = ragged_attention_partial(*args, page_lo=shard[0],
                                              page_count=shard[1], **kw)
            out = combine_ranks(o, lse, ctx.tp)[None]
    else:
        mask = None
        if paged is not None:
            kv_cache, k, v, mask = paged_kv_update(
                kv_cache, k, v, block_tables=paged["block_tables"],
                lens=paged["lens"], new_counts=paged["new_counts"],
                kv_shard=shard)
        elif kv_cache is not None:
            kv_cache, k, v, mask = dense_kv_update(kv_cache, k, v, cache_pos,
                                                   window)
        if shard is not None:
            o, lse = core_attention_partial(q, k, v, q_pos=positions,
                                            kv_len_mask=mask)
            out = combine_ranks(o, lse, ctx.tp)
        elif window is not None:
            o, lse = core_attention_partial(q, k, v, q_pos=positions,
                                            kv_len_mask=mask, kv_lo=window.lo)
            out = combine_ranks(o, lse, window.axis)
        elif kv_cache is None and kv_source is None and sq > 512:
            out = chunked_attention(q, k, v, causal=causal, q_pos=positions)
        else:
            out = core_attention(q, k, v, causal=causal and kv_source is None,
                                 q_pos=positions, kv_len_mask=mask)
    out = linear_apply(params["wo"], out.reshape(b, sq, hq * dh), ctx,
                       keep_packed=keep_packed, tp="row")
    return out, kv_cache
