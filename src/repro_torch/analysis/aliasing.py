"""The allocator audit: the dynamic half of the KV-write aliasing contract.

A write into a shared page is safe only if every holder of the page is
counted: a page's refcount must equal the block tables holding it plus its
prefix-cache node, the free list must hold no live page, and the trash
page must never enter the ledger.  The resilience contract adds zero leaks
on retirement: a finished, cancelled, timed-out, shed or quarantined
request holds no page.  The runtime sanitizer
(:mod:`repro_torch.analysis.sanitize`) checks the other half, ``ref == 1``
at each write, as the step is assembled.
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis.report import Finding

__all__ = ["check_pool_consistency"]

_PASS = "kv-aliasing"


def check_pool_consistency(engine, label: str = "engine") -> List[Finding]:
    """Audit ``engine``'s pool ledger against its holders (live block
    tables and the prefix cache) and its retired request ids; returns the
    findings, empty when the allocator is consistent."""
    f: List[Finding] = []
    pool = engine.pool
    here = f"{label} pool"

    retired = getattr(engine, "_retired_rids", set())
    for seq in pool.sequences():
        if seq.owner in retired and seq.pages:
            f.append(Finding(
                _PASS, "retired-holds-pages", here,
                f"retired rid {seq.owner} still holds pages {seq.pages} — "
                f"every retirement path must release the block table"))
    ledger = pool.ledger()
    refs, free = ledger["refs"], ledger["free"]

    live_and_free = set(refs) & set(free)
    if live_and_free:
        f.append(Finding(_PASS, "ledger-free-live", here,
                         f"pages {sorted(live_and_free)} are on the free list "
                         f"while refcounted live — the next alloc would hand "
                         f"one page to two requests"))
    if 0 in refs or 0 in free:
        f.append(Finding(_PASS, "ledger-trash", here,
                         "trash page 0 appears in the allocator ledger — it "
                         "must never be allocated or freed"))
    for p, r in sorted(refs.items()):
        if r < 1:
            f.append(Finding(_PASS, "ledger-refcount", here,
                             f"page {p} live with ref={r}"))

    held: dict = {}
    for seq in pool.sequences():
        for p in seq.pages:
            held[p] = held.get(p, 0) + 1
    cached = set()
    if engine.prefix_cache is not None:
        cached = set(engine.prefix_cache.pages())
    for p in sorted(set(held) | cached | set(refs)):
        want = held.get(p, 0) + (1 if p in cached else 0)
        have = refs.get(p, 0)
        if want != have:
            f.append(Finding(
                _PASS, "ledger-mismatch", here,
                f"page {p}: ref={have} but held by {held.get(p, 0)} "
                f"block table(s) (requests {pool.holders(p)}) "
                f"{'+ prefix cache ' if p in cached else ''}— a stale "
                f"refcount makes copy-before-write undecidable"))
    return f
