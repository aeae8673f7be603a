"""Layout-keyed, page-granular prefix cache: refcounted page sharing and
cache-backed preemption.

A transcription of the JAX package's prefix cache (pure host logic).  A
full KV page depends only on the weights, the layout and the exact token
block it holds, so two requests whose prompts share a page-aligned prefix
can share the pages instead of prefilling twice.

- **Keys.** Each cached full page is a node of a hash chain: its key is
  ``H(parent_key || token_block)``, rooted in ``H(layout key,
  page_tokens)``.  A lookup walks the prompt's full pages from the root and
  stops at the first miss, so a layout change can never alias stale KV.
- **Refcounts.** The cache holds one pool reference per cached page, and a
  hit hands one more to the requester.  Pages whose only reference is the
  cache's are evictable, least recently used first and childless nodes
  first; the pool evicts through :meth:`PrefixCache.evict` when its free
  list runs dry (``pool.reclaimer``), so cached pages never block a drain.
- **Hit cursor.** A hit is capped at ``prompt_len - 1`` tokens: the last
  prompt position's logits feed the first pick.  A fully cached prompt
  therefore restarts inside its last shared page, which the scheduler
  copies (copy-on-write) before the prefill writes there.
- **Insertion.** Prefill inserts newly completed full pages as the cursor
  advances (chunked) or at completion (monolithic), and preemption and
  reclaim release pages into the cache, so a resume recomputes only the
  uncached suffix.  A row quarantined for non-finite logits inserts
  nothing.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs.telemetry import NULL as _NULL_OBS
from repro_torch.serving.kv_cache import PagedKVPool

__all__ = ["PrefixCache"]


class _Node:
    """One cached full page: its chain key, its parent's key, the page id,
    its child count and an LRU tick."""

    __slots__ = ("key", "parent", "page", "nchildren", "tick")

    def __init__(self, key: bytes, parent: bytes, page: int, tick: int):
        self.key = key
        self.parent = parent
        self.page = page
        self.nchildren = 0
        self.tick = tick


class PrefixCache:
    """Page-granular prefix cache over a :class:`PagedKVPool`; registers
    itself as the pool's ``reclaimer``.  Host bookkeeping only: the engine
    owns the device pools."""

    def __init__(self, pool: PagedKVPool, *, layout_key=()):
        self.pool = pool
        self.page_tokens = pool.page_tokens
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(("repro-prefix-cache", tuple(layout_key),
                       pool.page_tokens)).encode())
        self._root = h.digest()
        self._nodes: Dict[bytes, _Node] = {}
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.insert_dups = 0
        self.evictions = 0
        self.obs = _NULL_OBS    # telemetry; the engine sets its own
        pool.reclaimer = self

    def _child_key(self, parent: bytes, block: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.ascontiguousarray(block, np.int32).tobytes())
        return h.digest()

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def lookup(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """The longest cached page-chain prefix of ``prompt``: ``(pages,
        hit_tokens)``, one pool reference per page handed to the caller,
        the hit capped at ``prompt_len - 1``; ``([], 0)`` on a miss.  The
        caller keeps every matched page even under the cap, and must copy
        the last one before writing into it."""
        self.lookups += 1
        prompt = np.asarray(prompt, np.int32)
        size = int(prompt.shape[0])
        t = self.page_tokens
        pages: List[int] = []
        h = self._root
        for i in range(size // t):
            key = self._child_key(h, prompt[i * t:(i + 1) * t])
            node = self._nodes.get(key)
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            h = key
        if not pages:
            return [], 0
        hit = min(len(pages) * t, size - 1)
        self.pool.share(pages)
        self.hits += 1
        self.hit_tokens += hit
        self.hit_pages += len(pages)
        self.obs.prefix_hit(hit, len(pages))
        return pages, hit

    def insert(self, prompt: np.ndarray, pages: List[int], upto: int) -> int:
        """Cache the full pages covering ``prompt[:upto]`` (``pages``: the
        writer's block table, page ``i`` holding token block ``i``).  An
        existing node is refreshed, never replaced: a duplicate stays
        private to its writer (``insert_dups``).  A new node takes its own
        pool reference.  Returns the pages newly cached."""
        prompt = np.asarray(prompt, np.int32)
        t = self.page_tokens
        n = min(min(upto, int(prompt.shape[0])) // t, len(pages))
        h = self._root
        new = 0
        for i in range(n):
            key = self._child_key(h, prompt[i * t:(i + 1) * t])
            node = self._nodes.get(key)
            if node is None:
                self._tick += 1
                node = _Node(key, h, pages[i], self._tick)
                self._nodes[key] = node
                parent = self._nodes.get(h)
                if parent is not None:
                    parent.nchildren += 1
                self.pool.share([pages[i]])
                self.inserted_pages += 1
                new += 1
            else:
                if node.page != pages[i]:
                    self.insert_dups += 1
                self._touch(node)
            h = key
        return new

    def pages(self) -> List[int]:
        """The page ids the cache holds a reference to, one per node."""
        return [n.page for n in self._nodes.values()]

    def evictable(self) -> int:
        """Cached pages whose only reference is the cache's."""
        return sum(1 for n in self._nodes.values()
                   if self.pool.ref(n.page) == 1)

    def evict(self, want: int) -> int:
        """Free up to ``want`` cache-only pages, childless and least
        recently used first.  Returns the number freed."""
        cands = sorted((n for n in self._nodes.values()
                        if self.pool.ref(n.page) == 1),
                       key=lambda n: (n.nchildren > 0, n.tick))
        freed = 0
        for node in cands:
            if freed >= want:
                break
            del self._nodes[node.key]
            parent = self._nodes.get(node.parent)
            if parent is not None:
                parent.nchildren -= 1
            self.pool.free([node.page])
            self.evictions += 1
            freed += 1
        if freed:
            self.obs.prefix_evict(freed)
        return freed

    def clear(self) -> int:
        """Evict everything evictable."""
        return self.evict(len(self._nodes))

    def stats(self) -> dict:
        return {"entries": len(self._nodes),
                "evictable": self.evictable(),
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hits / max(1, self.lookups),
                "hit_tokens": self.hit_tokens, "hit_pages": self.hit_pages,
                "inserted_pages": self.inserted_pages,
                "insert_dups": self.insert_dups,
                "evictions": self.evictions,
                "shared_pages": sum(
                    1 for n in self._nodes.values()
                    if self.pool.is_shared(n.page)),
                "cow_copies": self.pool.cow_copies}
