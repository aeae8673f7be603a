"""Paged KV cache bookkeeping for continuous-batching serving (host side).

The K/V pool is a set of fixed-size pages shared by all live requests; each
request owns an ordered block table of page ids covering positions
``0 .. len-1``.  Admission allocates pages for the first chunk, each step
grows the table as the sequence lengthens, and finishing returns the
pages.  Page 0 is the trash page: padded positions write there, so a
fixed-shape step never corrupts a live request.  The page size is rounded
up to the layout's ``m_r``, so pages are whole microkernel tiles.

A transcription of the JAX package's allocator without page sharing: the
refcounts, copy-on-write and the device page copy arrive with the port of
the prefix cache and speculative rollback.  The device pools themselves
live in the model's cache tree (``transformer.init_paged_caches``); the
monolithic prefill's helpers over that tree (:func:`fresh_slot_states`,
:func:`prefill_view`, :func:`merge_slot`) sit at the end of this module.
The pools are updated in place and never rebound: every captured CUDA
graph holds their addresses.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.layout import ceil_div

__all__ = ["PoolError", "OutOfPages", "PagedKVPool", "SequencePages",
           "fresh_slot_states", "prefill_view", "merge_slot"]


class PoolError(RuntimeError):
    """An allocator contract violation (double free, foreign free) or an
    allocation failure; raised explicitly so it survives ``python -O``."""


class OutOfPages(PoolError):
    """The pool cannot satisfy an allocation (admission must wait)."""


class PagedKVPool:
    """Host-side page allocator.  Page 0 is reserved and never handed out:
    capacity questions use :attr:`usable_pages`, not ``num_pages``."""

    def __init__(self, num_pages: int, page_tokens: int):
        if num_pages < 2:
            raise ValueError("need at least the trash page + one real page")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.reserved_pages = 1
        # LIFO free list: recently freed pages are reused first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._seqs: "weakref.WeakSet[SequencePages]" = weakref.WeakSet()
        self.total_allocs = 0
        self.total_frees = 0
        self.peak_used = 0

    @property
    def usable_pages(self) -> int:
        return self.num_pages - self.reserved_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def num_available(self) -> int:
        return len(self._free)

    def pages_for(self, tokens: int) -> int:
        return ceil_div(max(0, tokens), self.page_tokens)

    def can_fit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.num_available

    def holders(self, page: int) -> List:
        """Owner ids of the live block tables holding ``page``."""
        return sorted({s.owner for s in self._seqs
                       if s.owner is not None and page in s.pages})

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages("KV pool exhausted")
        p = self._free.pop()
        self._ref[p] = 1
        self.total_allocs += 1
        self.peak_used = max(self.peak_used, self.num_used)
        return p

    def free(self, pages: Iterable[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise PoolError(f"page {p} freed outside the usable range "
                                f"1..{self.num_pages - 1} (page 0 is the trash page)")
            if p not in self._ref:
                raise PoolError(f"page {p} freed twice (or never allocated); "
                                f"held by requests {self.holders(p) or 'none'}")
            self._ref[p] -= 1
            self.total_frees += 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    def stats(self) -> dict:
        live = [len(s.pages) for s in self._seqs if s.pages]
        return {"num_pages": self.num_pages, "page_tokens": self.page_tokens,
                "reserved_pages": self.reserved_pages,
                "usable_pages": self.usable_pages,
                "num_used": self.num_used, "num_free": self.num_free,
                "live_requests": len(live),
                "pages_per_request": (sum(live) / len(live)) if live else 0.0,
                "peak_used": self.peak_used, "total_allocs": self.total_allocs,
                "total_frees": self.total_frees}


@dataclasses.dataclass(eq=False)
class SequencePages:
    """One request's block table.  ``owner`` (the request id) serves
    diagnostics only; ``eq=False`` keeps identity hashing for the pool's
    weak registry."""

    pool: PagedKVPool
    pages: List[int] = dataclasses.field(default_factory=list)
    owner: Optional[int] = None

    def __post_init__(self):
        self.pool._seqs.add(self)

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.pool.page_tokens

    def ensure(self, tokens: int) -> None:
        """Grow to cover ``tokens`` positions; all or nothing."""
        start = len(self.pages)
        try:
            while self.capacity < tokens:
                self.pages.append(self.pool.alloc())
        except OutOfPages:
            self.pool.free(self.pages[start:])
            del self.pages[start:]
            raise

    def release(self) -> None:
        self.pool.free(self.pages)
        self.pages = []

    def block_row(self, max_pages: int) -> np.ndarray:
        if len(self.pages) > max_pages:
            raise PoolError(f"{len(self.pages)} pages exceed the block-table "
                            f"width {max_pages}")
        row = np.zeros((max_pages,), np.int32)
        row[:len(self.pages)] = self.pages
        return row


# ---------------------------------------------------------------------------
# cache-tree helpers: page pools are shared, recurrent state is per slot
# ---------------------------------------------------------------------------

def _map_slot_states(caches, fn):
    """Apply ``fn`` to the per-slot state leaves ([G, slots, ...]); pass the
    shared ``*_pages`` pools through as they are."""
    if isinstance(caches, dict):
        return {k: (v if k.endswith("_pages") else _map_slot_states(v, fn))
                for k, v in caches.items()}
    return fn(caches)


def fresh_slot_states(caches):
    """A zeroed single-slot ([G, 1, ...]) state tree matching ``caches``:
    the state a request starts its prefill from."""
    return _map_slot_states(
        caches, lambda x: torch.zeros((x.shape[0], 1, *x.shape[2:]),
                                      dtype=x.dtype, device=x.device))


def prefill_view(caches, fresh):
    """Single-slot view for a prefill: the shared pools of ``caches`` (the
    same tensors) and the per-slot state of ``fresh``."""
    if isinstance(caches, dict):
        return {k: (v if k.endswith("_pages") else prefill_view(v, fresh[k]))
                for k, v in caches.items()}
    return fresh


def merge_slot(caches, updated, slot: int):
    """Merge a prefill's result into ``caches`` in place and return it: the
    pools were written in place, so ``updated`` must hold the very same
    pool tensors; the [G, 1, ...] per-slot state is copied into row
    ``slot``."""
    for k, v in caches.items():
        if k.endswith("_pages"):
            if updated[k] is not v:
                raise ValueError(f"merge_slot: pool {k!r} was rebound; the "
                                 f"pools are updated in place")
        elif isinstance(v, dict):
            merge_slot(v, updated[k], slot)
        else:
            v[:, slot:slot + 1].copy_(updated[k])
    return caches
