"""Plain PyTorch version of segment-masked ragged paged attention.

Flat token-level batching: queries arrive as one ``[W, Hq, dh]`` stream;
position ``i`` belongs to engine row ``row_ids[i]`` and sits at absolute
position ``q_pos[i]`` of that row.  Each query gathers its own row's pages
and attends causally within its segment (``kv_pos <= q_pos[i]``).  A
transcription of the JAX package's oracle (float32 scores and softmax,
``-1e30`` masking).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ragged_attention_ref", "flat_write_destinations"]


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
