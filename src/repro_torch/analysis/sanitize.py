"""Runtime sanitizer of the pool write path (``REPRO_SANITIZE=1``).

Before each model call it checks, on the host, what the call is about to
write:

* every destination page of a valid position is live, in range and
  **private** (``ref == 1``): an in-place write into a shared page (a
  missing copy-on-write) fails at the step that would corrupt another
  request's KV, naming the page, its refcount and its holders;
* no valid position writes trash page 0 (a block table that does not
  cover the write window: tokens silently dropped);
* the step width belongs to the engine's ladder (``_flat_shapes``,
  ``_chunk_shapes``, the prefill buckets of ``_prefill_bucket``), and a
  flat width is ``m_r``-aligned: a width outside the ladder would need a
  program, and on the card a graph, that warmup never made;
* the resilience contract: a retired request id (finished, cancelled,
  timed out, shed, quarantined) is no longer scheduled and holds no page,
  and a quarantined request's private pages are free after
  ``cancel(cache_pages=False)``, so suspect KV never reaches the prefix
  cache.

The flat step's destinations come from
:func:`repro_torch.kernels.ragged_attn.ref.flat_write_destinations`, the
host mirror of the scatter's addressing rule.  The checks wrap the
engine's Python entries, ``_run_paged`` and ``_run_flat``, which take the
host arrays; a captured graph is never touched.  Install with
``REPRO_SANITIZE=1`` (every engine installs it at construction) or::

    from repro_torch.analysis.sanitize import install
    san = install(engine)      # idempotent; returns the StepSanitizer
"""

from __future__ import annotations

import weakref
from typing import Set

import numpy as np

from repro_torch.kernels.ragged_attn.ref import flat_write_destinations

__all__ = ["SanitizerError", "StepSanitizer", "install"]


class SanitizerError(AssertionError):
    """A contract violation on the pool write path, found at run time."""


class StepSanitizer:
    """The host-side checks run before each of an engine's model calls.
    It holds its engine weakly, so a dropped engine is freed at once."""

    def __init__(self, engine):
        self._engine = weakref.ref(engine)
        self.pool = engine.pool
        self.m_r = engine._bucket
        self.checks = 0            # model calls inspected
        self.pages_checked = 0     # (page, call) write destinations audited
        self.cancels_checked = 0   # quarantines audited
        self.paged_widths: Set[int] = self._declared_paged_widths()
        self.flat_widths: Set[int] = (set(engine._flat_shapes())
                                      if engine.flat else set())

    @property
    def engine(self):
        return self._engine()

    def _declared_paged_widths(self) -> Set[int]:
        eng = self.engine
        widths = {1}
        if eng.spec_tokens is not None:
            widths.add(eng.spec_tokens + 1)
        if eng.chunked:
            return widths | set(eng._chunk_shapes())
        l, seen = eng._bucket, set()
        while (b := eng._prefill_bucket(l)) not in seen:
            seen.add(b)
            l = b + 1
        return widths | seen

    def _fail(self, message: str) -> None:
        raise SanitizerError(f"REPRO_SANITIZE: {message}")

    def _check_width(self, s: int, ladder: Set[int], kind: str) -> None:
        if s not in ladder:
            self._fail(f"{kind} step width {s} is not in the declared shape "
                       f"ladder {sorted(ladder)} — warmup made no program "
                       f"(and on the card no graph) for it")

    def _check_pages(self, pages, where: str) -> None:
        pool = self.pool
        for p in np.unique(np.asarray(pages)):
            p = int(p)
            self.pages_checked += 1
            if p == 0:
                self._fail(f"{where}: a valid position writes trash page 0 — "
                           f"the block table does not cover the write "
                           f"window; these tokens would be dropped")
            if not 0 < p < pool.num_pages:
                self._fail(f"{where}: write destination page {p} is outside "
                           f"the pool (num_pages={pool.num_pages})")
            ref = pool.ref(p)
            if ref == 0:
                self._fail(f"{where}: write into unallocated page {p} (ref=0) "
                           f"— the block table references a freed page")
            if ref > 1:
                self._fail(f"{where}: in-place write to page {p} with "
                           f"ref={ref} (holders: requests {pool.holders(p)}) "
                           f"— a shared page must be copied (PagedKVPool.cow) "
                           f"before any write")

    def check_retired(self) -> None:
        """Zero leaks on retirement: a retired rid is gone from the
        schedule and holds no page.  Runs before every model call, so a
        leak shows at the call after the retirement that left it."""
        retired = self.engine._retired_rids
        if not retired:
            return
        sched = self.engine.scheduler
        for r in list(sched.running.values()) + list(sched.waiting):
            if r.rid in retired:
                self._fail(f"retired rid {r.rid} is still scheduled "
                           f"(status={r.status}) — cancel/finish must remove "
                           f"the request from the scheduler")
        for s in self.pool.sequences():
            if s.owner in retired and s.pages:
                self._fail(f"retired rid {s.owner} still holds pages "
                           f"{s.pages} — every retirement must release them")

    def check_paged(self, token, block_tables, lens, new_counts) -> None:
        token = np.asarray(token)
        bt = np.asarray(block_tables)
        lens = np.asarray(lens)
        counts = np.asarray(new_counts)
        self.checks += 1
        b, s = token.shape
        self._check_width(s, self.paged_widths, "paged")
        t = self.pool.page_tokens
        for bi in range(b):
            n = int(counts[bi])
            if n <= 0:
                continue             # an inert row writes the trash page
            pos = int(lens[bi]) + np.arange(n)
            slot = np.minimum(pos // t, bt.shape[1] - 1)
            self._check_pages(bt[bi, slot], f"paged step row {bi} "
                              f"(lens={int(lens[bi])}, new_count={n})")

    def check_flat(self, token, block_tables, row_ids, q_pos) -> None:
        token = np.asarray(token)
        row_ids = np.asarray(row_ids)
        self.checks += 1
        w = token.shape[1]
        self._check_width(w, self.flat_widths, "flat")
        if w % self.m_r != 0:
            self._fail(f"flat step width {w} is not m_r-aligned "
                       f"(m_r={self.m_r}) — tile writes would be partial")
        pages, _, valid = flat_write_destinations(block_tables, row_ids, q_pos,
                                                  self.pool.page_tokens)
        if valid.any():
            rows = sorted(int(r) for r in np.unique(row_ids[valid]))
            self._check_pages(pages[valid], f"flat step (rows {rows}, "
                              f"{int(valid.sum())} valid tokens)")


def _entry(obj, name: str):
    """What ``obj.<name>`` calls now: a wrapper installed before, or the
    class's method bound through a weak reference, so that the wrapper
    installed over it makes no reference cycle through ``obj``."""
    if name in obj.__dict__:
        return obj.__dict__[name]
    method, ref = getattr(type(obj), name), weakref.ref(obj)
    return lambda *a, **k: method(ref(), *a, **k)


def install(engine) -> StepSanitizer:
    """Wrap ``engine._run_paged`` and ``engine._run_flat`` with the checks
    above, and ``engine.scheduler.cancel`` with the quarantine audit.
    Idempotent per engine."""
    if engine.sanitizer is not None:
        return engine.sanitizer
    san = StepSanitizer(engine)
    sched, pool = engine.scheduler, engine.pool

    orig_paged = _entry(engine, "_run_paged")

    def run_paged(token, bt, lens, counts, idx=None, caches=None):
        san.check_retired()
        san.check_paged(token, bt, lens, counts)
        return orig_paged(token, bt, lens, counts, idx, caches)

    engine._run_paged = run_paged
    if engine.flat:
        orig_flat = _entry(engine, "_run_flat")

        def run_flat(token, bt, row_ids, q_pos, idx):
            san.check_retired()
            san.check_flat(token, bt, row_ids, q_pos)
            return orig_flat(token, bt, row_ids, q_pos, idx)

        engine._run_flat = run_flat

    # a cancel(cache_pages=False) says "this KV is suspect": the pages the
    # request held alone must be free when it returns (a reference left
    # means the KV reached the prefix cache or another block table)
    orig_cancel = _entry(sched, "cancel")

    def cancel(rid, reason="cancelled", *, cache_pages=True):
        solo = []
        if not cache_pages:
            live = [r for r in list(sched.waiting) + list(sched.running.values())
                    if r.rid == rid]
            if live and live[0].pages is not None:
                solo = [p for p in live[0].pages.pages if pool.ref(p) == 1]
        out = orig_cancel(rid, reason, cache_pages=cache_pages)
        if solo:
            san.cancels_checked += 1
            for p in solo:
                if pool.ref(p) != 0:
                    san._fail(f"quarantined page {p} of rid {rid} survived "
                              f"cancel(cache_pages=False) with "
                              f"ref={pool.ref(p)} (holders: {pool.holders(p)}) "
                              f"— quarantined KV must never reach the prefix "
                              f"cache")
        return out

    sched.cancel = cancel
    engine.sanitizer = san
    return san
