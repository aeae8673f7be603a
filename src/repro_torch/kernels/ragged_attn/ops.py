"""Wrapper of the ragged paged-attention kernel (``csrc/ragged_attn.cu``)
and its planner.

Replaces the Pallas ``ragged_attention_kernel_call``
(src/repro/kernels/ragged_attn/kernel.py:109).  A CPU tensor takes the
plain version (``ref.py``) and ignores the plan; a CUDA tensor launches the
kernel or raises.  q and the pools share one dtype (float32 or bfloat16)
and are contiguous; the index tensors are int32.

The kernel works from a plan that :func:`plan_ragged` builds on the host
from the same numpy ``row_ids``/``q_pos`` the caller uploads, so the
wrapper never reads an index tensor back from the card:

- a *tile* is a run of at most ``TILE`` consecutive flat positions of one
  row with consecutive ``q_pos`` (or of padding).  Its ``TILE x g`` query
  rows share every K/V page load of one KV head;
- a tile's pages ``[0, min(last q_pos // T, MP - 1)]`` are cut into at most
  ``splits`` contiguous, non-empty ranges; one block takes one range of
  one KV head.  A tile's ``splits`` blocks form one thread-block cluster,
  which merges their partial softmaxes in split order (no atomics: repeated
  calls are bit-identical).  A tile with fewer pages than ``splits`` leaves
  its last blocks an empty range.

A served step passes ``slots``: the plan then has a fixed size per width,
so a CUDA graph captured at one width replays every step of it.  Its
item count is :func:`max_tiles` of the width, the tiles it makes
followed by *empty* tiles (length 0, padding row, no pages), whose
blocks write nothing; its split count is :func:`pick_splits` for that
many tiles and the block table's width.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref

__all__ = ["ragged_attention", "RaggedPlan", "plan_ragged", "pick_splits",
           "max_tiles", "TILE", "MAX_CLUSTER", "PAGES_PER_SPLIT"]

TILE = 16          # positions per tile: the page size and the bf16 m_r
MAX_ROWS = 128     # query rows per tile (TILE x g): 8 warps of 16 rows
MAX_CLUSTER = 8    # portable thread-block cluster size: splits per tile
PAGES_PER_SPLIT = 8   # a split's pages: one per warp of its block


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """``items`` [tiles * splits, 6] int32: for each block (tile-major, the
    ``splits`` blocks of a tile consecutive) the tile's first flat position,
    its length, its row (-1: padding, written as zeros), its first
    ``q_pos``, and the block's page range ``[p_lo, p_hi)``."""

    items: np.ndarray | torch.Tensor
    splits: int

    @property
    def tiles(self) -> int:
        return self.items.shape[0] // self.splits

    def to(self, device) -> "RaggedPlan":
        return RaggedPlan(torch.from_numpy(self.items).to(device), self.splits)


def tile_length(group: int) -> int:
    """Positions per tile for ``group`` query heads per KV head."""
    if group > MAX_ROWS:
        raise ValueError(f"ragged_attention: {group} query heads per KV head; "
                         f"the kernel takes at most {MAX_ROWS}")
    return min(TILE, MAX_ROWS // group)


def max_tiles(width: int, rows: int, tile: int) -> int:
    """The most tiles ``width`` positions can make when they hold at most
    ``rows`` row segments (consecutive ``q_pos`` each) and one padding
    run: a run of ``n`` positions makes ``ceil(n / tile)`` tiles, so
    ``rows + 1`` runs make at most ``(width + (rows + 1)(tile - 1)) //
    tile``, and never more than ``width``."""
    return min(width, (width + (rows + 1) * (tile - 1)) // tile)


@functools.lru_cache(maxsize=None)
def pick_splits(tiles: int, max_pages: int, hkv: int, sm_count: int) -> int:
    """Page ranges per tile for a call with ``tiles`` tiles of attention
    work whose longest row reads ``max_pages`` pages.  One range when the
    tiles alone give half a wave of blocks (``tiles * hkv`` >= half the
    SMs: a prefill step), else enough that no block walks more than
    ``PAGES_PER_SPLIT`` pages (one per warp), at most ``MAX_CLUSTER``.  The
    sweep (``python -m repro_torch.kernels.ragged_attn.sweep``) ranks it."""
    if 2 * tiles * hkv >= sm_count:
        return 1
    return max(1, min(MAX_CLUSTER, math.ceil(max_pages / PAGES_PER_SPLIT)))


def plan_ragged(row_ids, q_pos, page_tokens: int, max_pages: int, hkv: int,
                sm_count: int, *, group: int, splits: int | None = None,
                slots: int | None = None) -> RaggedPlan:
    """Tiles and blocks of one call (numpy in, numpy out).  ``group`` is
    ``Hq / Hkv``; ``splits`` overrides :func:`pick_splits` (the sweep).
    ``slots``: the engine's rows; the plan then has the width's fixed size
    (:func:`max_tiles` tiles, the split count picked for them and
    ``max_pages``) and raises if the layout makes more tiles than that.
    Without it the plan fits this call alone."""
    row_ids = np.asarray(row_ids, np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    w = row_ids.shape[0]
    tile = tile_length(group)
    # a run breaks where the row changes or, within a row, q_pos jumps;
    # runs are cut into tiles of at most `tile` positions
    brk = np.ones(w, bool)
    brk[1:] = (row_ids[1:] != row_ids[:-1]) | (
        (row_ids[1:] >= 0) & (q_pos[1:] != q_pos[:-1] + 1))
    run_start = np.maximum.accumulate(np.where(brk, np.arange(w), 0))
    starts = np.flatnonzero(brk | ((np.arange(w) - run_start) % tile == 0))
    counts = np.diff(np.append(starts, w))
    rows = row_ids[starts]
    q0 = np.where(rows >= 0, q_pos[starts], 0)
    pages = np.where(rows >= 0, np.minimum((q0 + counts - 1) // page_tokens,
                                           max_pages - 1) + 1, 0)
    n_tiles = starts.shape[0]
    if slots is not None:
        n_tiles = max_tiles(w, slots, tile)
        if starts.shape[0] > n_tiles:
            raise ValueError(f"ragged_attention: {starts.shape[0]} tiles at "
                             f"width {w}; {slots} rows make at most {n_tiles}")
        if splits is None:
            splits = pick_splits(n_tiles, max_pages, hkv, sm_count)
    if splits is None:
        splits = pick_splits(int((rows >= 0).sum()),
                             int(pages.max(initial=1)), hkv, sm_count)
    if not 1 <= splits <= MAX_CLUSTER:
        raise ValueError(f"ragged_attention: splits={splits}, not in "
                         f"[1, {MAX_CLUSTER}]")
    k = np.arange(splits)
    ns = np.minimum(pages, splits)[:, None]                # ranges per tile
    p_lo = np.where(k < ns, k * pages[:, None] // np.maximum(ns, 1),
                    pages[:, None])
    p_hi = np.where(k < ns, (k + 1) * pages[:, None] // np.maximum(ns, 1),
                    pages[:, None])
    items = np.zeros((n_tiles * splits, 6), np.int32)
    items[:, 2] = -1                    # empty tiles: padding, no positions
    live = starts.shape[0] * splits
    items[:live] = np.stack([np.repeat(starts, splits), np.repeat(counts, splits),
                             np.repeat(rows, splits), np.repeat(q0, splits),
                             p_lo.reshape(-1), p_hi.reshape(-1)], axis=1)
    return RaggedPlan(items, splits)


def ragged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, *, block_tables: torch.Tensor,
                     row_ids: torch.Tensor, q_pos: torch.Tensor,
                     plan: RaggedPlan | None = None) -> torch.Tensor:
    """q: [W, Hq, dh]; k_pages/v_pages: [P, T, Hkv, dh]; block_tables:
    [B, MP]; row_ids: [W] (-1 = pad); q_pos: [W]; ``plan``: from
    :func:`plan_ragged` on the same row_ids/q_pos, its items on the card
    (needed there, ignored on the CPU).  Returns [W, Hq, dh]; on the card
    padding positions are zeros."""
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pages, v_pages,
                                    block_tables=block_tables,
                                    row_ids=row_ids, q_pos=q_pos)
    if plan is None:
        raise ValueError("ragged_attention: a CUDA call needs a plan "
                         "(plan_ragged on the host's row_ids and q_pos)")
    items = plan.items
    if not isinstance(items, torch.Tensor):
        raise TypeError("ragged_attention: the plan's items must be on the "
                        "card (RaggedPlan.to)")
    build.require_cuda("ragged_attention", q, k_pages, v_pages, block_tables,
                       row_ids, q_pos, items)
    code = build.require_dtype("ragged_attention", q.dtype, q, k_pages, v_pages)
    for name, t in (("block_tables", block_tables), ("row_ids", row_ids),
                    ("q_pos", q_pos), ("plan.items", items)):
        if t.dtype != torch.int32:
            raise TypeError(f"ragged_attention: {name} is {t.dtype}, not int32")
    build.require_contiguous("ragged_attention", q=q, k_pages=k_pages,
                             v_pages=v_pages, block_tables=block_tables,
                             row_ids=row_ids, q_pos=q_pos, items=items)
    w, hq, dh = q.shape
    p, t, hkv, dh2 = k_pages.shape
    if dh2 != dh or tuple(v_pages.shape) != tuple(k_pages.shape) \
            or hq % hkv or row_ids.shape != (w,) or q_pos.shape != (w,) \
            or items.ndim != 2 or items.shape[1] != 6 \
            or items.shape[0] % plan.splits:
        raise ValueError(f"ragged_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"row_ids {tuple(row_ids.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, plan {tuple(items.shape)} "
                         f"x {plan.splits} do not agree")
    if t != TILE or dh != 64:
        raise ValueError(f"ragged_attention: pages of {t} tokens, d_head {dh}; "
                         f"the kernel takes pages of {TILE} and d_head 64")
    out = torch.empty_like(q)
    rc = build.load_library().repro_ragged_attn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), items.data_ptr(), out.data_ptr(), code,
        items.shape[0], plan.splits, hq, hkv, block_tables.shape[1],
        build.stream_of(q))
    build.check(rc, "ragged_attention")
    ragged_attention.launches += 1
    return out


ragged_attention.launches = 0
