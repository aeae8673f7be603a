"""Plain PyTorch version of segment-masked ragged paged attention.

Flat token-level batching: queries arrive as one ``[W, Hq, dh]`` stream;
position ``i`` belongs to engine row ``row_ids[i]`` and sits at absolute
position ``q_pos[i]`` of that row.  Each query gathers its own row's pages
and attends causally within its segment (``kv_pos <= q_pos[i]``).  A
transcription of the JAX package's oracle (float32 scores and softmax,
``-1e30`` masking).  :func:`ragged_attention_planned` executes a plan of
the card's kernel (per-block partial softmaxes over page ranges, merged in
split order) for the tests.

:func:`ragged_attention_partial_ref` is the partial form, one rank's share
of a flash-decode across ranks whose pools hold the global pages
``[page_lo, page_lo + page_count)``: the output over the keys of those
pages and each query row's float32 log-sum-exp;
:func:`combine_partials` puts the ranks' shares together,
``o = sum_r exp(lse_r - lse) o_r`` with ``lse`` the log of the summed
weights.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ragged_attention_ref", "ragged_attention_planned",
           "ragged_attention_partial_ref", "combine_partials",
           "flat_write_destinations"]


def flat_write_destinations(block_tables: np.ndarray, row_ids: np.ndarray,
                            q_pos: np.ndarray, page_tokens: int):
    """Host-side mirror of the flat scatter's addressing rule
    (:func:`repro_torch.models.attention.flat_paged_kv_update`): position
    ``i`` writes page ``block_tables[row_ids[i], q_pos[i] // T]`` at offset
    ``q_pos[i] % T``; ``row_ids[i] < 0`` routes to trash page 0.  Returns
    ``(pages, offsets, valid)``, each ``[W]``."""
    bt = np.asarray(block_tables)
    row_ids = np.asarray(row_ids)
    q_pos = np.asarray(q_pos)
    valid = row_ids >= 0
    row = np.maximum(row_ids, 0)
    slot = np.minimum(q_pos // page_tokens, bt.shape[1] - 1)
    pages = np.where(valid, bt[row, slot], 0)
    offsets = np.where(valid, q_pos % page_tokens, 0)
    return pages, offsets, valid


def ragged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, *, block_tables: torch.Tensor,
                         row_ids: torch.Tensor,
                         q_pos: torch.Tensor) -> torch.Tensor:
    """q: [W, Hq, dh]; k_pages/v_pages: [P, T, Hkv, dh] (page 0 = trash);
    block_tables: [B, MP]; row_ids: [W] (-1 = padding, clamped to row 0,
    output garbage the caller discards); q_pos: [W].  Returns [W, Hq, dh]."""
    w, hq, dh = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    bt = block_tables[row_ids.long().clamp(min=0)].long()          # [W, MP]
    k_all = k_pages[bt].reshape(w, -1, hkv, dh)                     # [W, MP*T, ..]
    v_all = v_pages[bt].reshape(w, -1, hkv, dh)
    qg = q.reshape(w, hkv, g, dh)
    scores = torch.einsum("qhgd,qkhd->qhgk", qg.float(), k_all.float()) \
        * dh ** -0.5
    kv_pos = torch.arange(k_all.shape[1], device=q.device)
    m = kv_pos[None, :] <= q_pos.long()[:, None]                    # [W, MP*T]
    # a Python scalar, not a tensor built from one: no host-to-device copy,
    # which would wait for the stream
    scores = scores.masked_fill(~m[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("qhgk,qkhd->qhgd", probs, v_all.float())
    return out.reshape(w, hq, dh).to(q.dtype)


def ragged_attention_partial_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, *,
                                 block_tables: torch.Tensor,
                                 row_ids: torch.Tensor, q_pos: torch.Tensor,
                                 page_lo: int, page_count: int):
    """The partial form: ``k_pages``/``v_pages`` [>= page_count, T, Hkv,
    dh] hold the global pages ``[page_lo, page_lo + page_count)`` as their
    first ``page_count`` pages; a key counts only where its row's block
    table names a page in that range.  Returns (out [W, Hq, dh] in q's
    dtype, lse [W, Hq] float32): the softmax over the counted keys and
    its log-sum-exp ``m + log l``; a row with no counted key gives zeros
    and ``-inf`` (padding rows too)."""
    w, hq, dh = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    bt = block_tables[row_ids.long().clamp(min=0)].long() - page_lo  # [W, MP]
    held = (bt >= 0) & (bt < page_count) & (row_ids.long() >= 0)[:, None]
    bt = torch.where(held, bt, 0)
    t = k_pages.shape[1]
    k_all = k_pages[bt].reshape(w, -1, hkv, dh)
    v_all = v_pages[bt].reshape(w, -1, hkv, dh)
    qg = q.reshape(w, hkv, g, dh)
    scores = torch.einsum("qhgd,qkhd->qhgk", qg.float(), k_all.float()) \
        * dh ** -0.5
    kv_pos = torch.arange(k_all.shape[1], device=q.device)
    m = (kv_pos[None, :] <= q_pos.long()[:, None]) \
        & held.repeat_interleave(t, dim=1)                          # [W, MP*T]
    scores = scores.masked_fill(~m[:, None, None, :], -torch.inf)
    top = scores.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isinf(top), 0.0, top)
    e = torch.exp(scores - top)
    l = e.sum(dim=-1)
    out = torch.einsum("qhgk,qkhd->qhgd", e, v_all.float()) \
        / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, top[..., 0] + torch.log(l), -torch.inf)
    return (out.reshape(w, hq, dh).to(q.dtype),
            lse.reshape(w, hq).to(torch.float32))


def combine_partials(outs, lses):
    """The ranks' partial outputs (each [W, Hq, dh]) and log-sum-exps
    (each [W, Hq]) as the whole attention, in float32, in list order:
    ``sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M)``, ``M`` the rows'
    max; a share with ``lse = -inf`` weighs 0, and a row no share holds
    comes out 0 (no NaN).  ``models/attention.py:combine_ranks`` applies
    it, on every rank alike, to the shares it gathers."""
    lse = torch.stack([x.float() for x in lses])
    top = lse.amax(dim=0)
    top = torch.where(torch.isinf(top), 0.0, top)
    wgt = torch.where(torch.isinf(lse), 0.0, torch.exp(lse - top))
    num = sum(wt[..., None] * o.float() for wt, o in zip(wgt, outs))
    return num / torch.clamp(wgt.sum(dim=0), min=1e-30)[..., None]


def _merge(parts):
    """Merge partial softmaxes ``(m, l, acc)`` in list order, as the kernel
    does: a part whose keys were all masked carries ``m = -inf, l = 0`` and
    weighs 0 (never ``exp(-inf - -inf)``)."""
    m_all = torch.stack([m for m, _, _ in parts])
    top = m_all.max(dim=0).values
    l_sum, acc_sum = 0.0, 0.0
    for m, l, acc in parts:
        wgt = torch.where(torch.isinf(m), torch.zeros_like(m),
                          torch.exp(m - torch.where(torch.isinf(top), 0.0, top)))
        l_sum = l_sum + wgt * l
        acc_sum = acc_sum + wgt[:, None] * acc
    return top, l_sum, acc_sum


def ragged_attention_planned(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, *,
                             block_tables: torch.Tensor, items,
                             splits: int) -> torch.Tensor:
    """Execute a :class:`~repro_torch.kernels.ragged_attn.ops.RaggedPlan`
    (``items`` [tiles * splits, 6] numpy, ``splits``) in float32: for each
    block and KV head, the partial ``(m, l, acc)`` of the tile's query rows
    over the block's page range (online softmax, page by page), then the
    merge of a tile's blocks in split order, ``l`` floored at 1e-30.
    Padding tiles give zeros.  For tests; the kernel's arithmetic on the
    CPU."""
    w, hq, dh = q.shape
    t, hkv = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    out = torch.zeros((w, hq, dh), dtype=torch.float32)
    items = np.asarray(items)
    for first in range(0, items.shape[0], splits):
        start, n, row, q0 = (int(x) for x in items[first, :4])
        if row < 0:
            continue
        qpos = q0 + torch.arange(n).repeat_interleave(g)      # per query row
        for h in range(hkv):
            qr = q[start:start + n, h * g:(h + 1) * g].reshape(n * g, dh).float()
            parts = []
            for p_lo, p_hi in items[first:first + splits, 4:6]:
                m = torch.full((n * g,), -torch.inf)
                l = torch.zeros(n * g)
                acc = torch.zeros(n * g, dh)
                for p in range(int(p_lo), int(p_hi)):
                    page = int(block_tables[row, p])
                    s = qr @ k_pages[page, :, h].float().T * scale    # [rows, T]
                    kv = p * t + torch.arange(t)
                    s = torch.where(kv[None, :] <= qpos[:, None], s, -torch.inf)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    dead = torch.isinf(m_new)
                    alpha = torch.where(dead, 1.0, torch.exp(m - m_new))
                    e = torch.where(dead[:, None], 0.0, torch.exp(s - m_new[:, None]))
                    l = l * alpha + e.sum(dim=1)
                    acc = acc * alpha[:, None] + e @ v_pages[page, :, h].float()
                    m = m_new
                parts.append((m, l, acc))
            _, l, acc = _merge(parts)
            o = acc / torch.clamp(l, min=1e-30)[:, None]
            out[start:start + n, h * g:(h + 1) * g] = o.reshape(n, g, dh)
    return out.to(q.dtype)
