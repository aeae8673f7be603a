"""Paged KV cache bookkeeping for continuous-batching serving (host side),
with refcounted page sharing.

The K/V pool is a set of fixed-size pages shared by all live requests; each
request owns an ordered block table of page ids covering positions
``0 .. len-1``.  Admission allocates pages for the first chunk, each step
grows the table as the sequence lengthens, and finishing returns the
pages.  Page 0 is the trash page: padded positions write there, so a
fixed-shape step never corrupts a live request.  The page size is rounded
up to the layout's ``m_r``, so pages are whole microkernel tiles.

A transcription of the JAX package's allocator.  Each live page carries a
refcount: the prefix cache (:mod:`repro_torch.serving.prefix_cache`) and
every request whose block table holds the page each own one reference,
and the page returns to the free list at zero.  Sharing rests on the
reference's three invariants: a full page is never written again; a
shared page is copied (:meth:`PagedKVPool.cow`) before any in-place
write; and the cache's keys are rooted in the layout.

The device pools live in the model's cache tree
(``transformer.init_paged_caches``).  They are updated in place and never
rebound, because every captured CUDA graph holds their addresses: the
copy-on-write's device copy (:func:`copy_pages`) writes into them in
place, and the monolithic prefill's helpers over the tree
(:func:`fresh_slot_states`, :func:`prefill_view`, :func:`merge_slot`)
keep the same pool tensors.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.layout import ceil_div

__all__ = ["PoolError", "OutOfPages", "PagedKVPool", "SequencePages",
           "copy_pages", "fresh_slot_states", "prefill_view", "merge_slot"]


class PoolError(RuntimeError):
    """An allocator contract violation (double free, foreign free, sharing
    a dead page), an allocation failure or a failed page copy; raised
    explicitly so it survives ``python -O``."""


class OutOfPages(PoolError):
    """The pool cannot satisfy an allocation (admission must wait)."""


class PagedKVPool:
    """Host-side refcounting page allocator.  Page 0 is reserved and never
    handed out: capacity questions use :attr:`usable_pages`, not
    ``num_pages``.

    :meth:`alloc` hands out a page at refcount 1, :meth:`share` adds a
    reference and :meth:`free` drops one.  A page with more than one
    reference is read-only until :meth:`cow` splits it.  Two hooks connect
    the prefix cache and the device without the allocator knowing either:

    - ``reclaimer``: an object with ``evictable() -> int`` and
      ``evict(n) -> int``; :meth:`alloc` evicts one page from it before
      giving up, so pages only the cache holds are always reclaimable.  It
      is held weakly: the cache holds the pool, not the other way round;
    - ``page_copier``: ``fn(src, dst)``, the device page copy :meth:`cow`
      needs (the engine owns the device pools)."""

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
        self.total_shares = 0
        self.total_frees = 0
        self.peak_used = 0
        self.cow_copies = 0
        self._reclaimer = None
        self.page_copier = None

    @property
    def reclaimer(self):
        return None if self._reclaimer is None else self._reclaimer()

    @reclaimer.setter
    def reclaimer(self, obj) -> None:
        self._reclaimer = None if obj is None else weakref.ref(obj)

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
        """Free pages plus the pages the reclaimer could evict: what an
        admission or growth decision may count on."""
        rec = self.reclaimer
        return len(self._free) + (rec.evictable() if rec is not None else 0)

    def pages_for(self, tokens: int) -> int:
        return ceil_div(max(0, tokens), self.page_tokens)

    def can_fit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.num_available

    def ref(self, page: int) -> int:
        """Outstanding references to ``page`` (0 = free)."""
        return self._ref.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self._ref.get(page, 0) > 1

    def sequences(self) -> List["SequencePages"]:
        """The live block tables registered with this pool."""
        return list(self._seqs)

    def holders(self, page: int) -> List:
        """Owner ids of the live block tables holding ``page``."""
        return sorted({s.owner for s in self._seqs
                       if s.owner is not None and page in s.pages})

    def ledger(self) -> dict:
        """A copy of the allocator's state: the refcount of every live page
        and the free list."""
        return {"refs": dict(self._ref), "free": list(self._free)}

    def alloc(self) -> int:
        if not self._free and self.reclaimer is not None:
            self.reclaimer.evict(1)
        if not self._free:
            raise OutOfPages("KV pool exhausted")
        p = self._free.pop()
        self._ref[p] = 1
        self.total_allocs += 1
        self.peak_used = max(self.peak_used, self.num_used)
        return p

    def share(self, pages: Iterable[int]) -> None:
        """Add one reference to each page, which must be live."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise PoolError(f"page {p} shared while not allocated; held "
                                f"by requests {self.holders(p) or 'none'}")
            self._ref[p] += 1
            self.total_shares += 1

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

    def cow(self, seq: "SequencePages", idx: int) -> int:
        """Copy-on-write of ``seq.pages[idx]``: when the page is shared,
        allocate a private page, copy the contents on the device through
        ``page_copier``, swap it into the block table and drop the
        sequence's reference on the original.  A no-op on an unshared
        page.  Returns the page the table now holds; raises
        :class:`OutOfPages` like any allocation, and :class:`PoolError`
        (with the fresh page freed) when the copy fails."""
        old = seq.pages[idx]
        if self._ref.get(old, 0) <= 1:
            return old
        new = self.alloc()
        if self.page_copier is not None:
            try:
                self.page_copier(old, new)
            except Exception as e:
                self.free([new])
                raise PoolError(f"page_copier failed copying page {old} -> "
                                f"{new}: {e}") from e
        seq.pages[idx] = new
        self.free([old])
        self.cow_copies += 1
        return new

    def stats(self) -> dict:
        live = [len(s.pages) for s in self._seqs if s.pages]
        return {"num_pages": self.num_pages, "page_tokens": self.page_tokens,
                "reserved_pages": self.reserved_pages,
                "usable_pages": self.usable_pages,
                "num_used": self.num_used, "num_free": self.num_free,
                "free_pages": self.num_free,
                "live_requests": len(live),
                "pages_per_request": (sum(live) / len(live)) if live else 0.0,
                "shared_pages": sum(1 for r in self._ref.values() if r > 1),
                "peak_used": self.peak_used, "total_allocs": self.total_allocs,
                "total_shares": self.total_shares,
                "total_frees": self.total_frees,
                "cow_copies": self.cow_copies}


@dataclasses.dataclass(eq=False)
class SequencePages:
    """One request's block table.  Shared entries (prefix-cache hits) are
    always a prefix of it; :meth:`release` and :meth:`truncate` drop
    references, not necessarily pages.  ``owner`` (the request id) serves
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

    def truncate(self, tokens: int) -> int:
        """Shrink to cover ``tokens`` positions, dropping whole trailing
        pages (the speculative rollback; stale positions in the kept last
        page are masked until overwritten).  When ``tokens`` ends inside a
        kept page that is shared, that page is split first
        (:meth:`PagedKVPool.cow`), so the next write never lands in a page
        another holder reads.  Returns the references dropped."""
        keep = self.pool.pages_for(tokens)
        dropped = self.pages[keep:]
        self.pool.free(dropped)
        del self.pages[keep:]
        if keep and tokens % self.pool.page_tokens:
            self.pool.cow(self, keep - 1)
        return len(dropped)

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


def copy_pages(caches, src: torch.Tensor, dst: torch.Tensor) -> None:
    """The device page copy of a copy-on-write: page ``src`` into page
    ``dst`` of every ``*_pages`` pool ([G, P, T, Hkv, dh], the page on
    axis 1), in place.  ``src`` and ``dst`` are one-element int64 index
    tensors on the pools' device, so nothing is copied from or to the host
    and no pool is reallocated or rebound."""
    for k, v in caches.items():
        if k.endswith("_pages"):
            v.index_copy_(1, dst, v.index_select(1, src))
        elif isinstance(v, dict):
            copy_pages(v, src, dst)


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
