"""The KV-write aliasing pass and the allocator audit.

The static half (:func:`lint_engine_aliasing`, the JAX package's pass 2)
proves from the traced step alone that every write into the paged KV pool
is *guarded*: its destination index is computed from the block-table
gather (so a row can only write its own pages) **and** carries the
trash-page route (``torch.where(valid, page, 0)``: invalid positions land
on page 0, never on live KV).  It runs on the unit updates
(:func:`repro_torch.models.attention.paged_kv_update` /
:func:`flat_paged_kv_update`) and on the widest step of each family, traced
with fake tensors (:mod:`repro_torch.analysis.graph_tools`).  The port's
Python loop over layers unrolls, so a step has one K and one V write per
attention layer where the reference's scan body has two in all.

The dynamic half (:func:`check_pool_consistency`): a write into a shared
page is safe only if every holder of the page is
counted: a page's refcount must equal the block tables holding it plus its
prefix-cache node, the free list must hold no live page, and the trash
page must never enter the ledger.  The resilience contract adds zero leaks
on retirement: a finished, cancelled, timed-out, shed or quarantined
request holds no page.  The runtime sanitizer
(:mod:`repro_torch.analysis.sanitize`) checks the other half, ``ref == 1``
at each write, as the step is assembled.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.analysis.graph_tools import (TRASH_LABEL, TaintWalker,
                                              leaf_labels, trace_step)
from repro_torch.analysis.report import Finding

__all__ = ["taint_step", "lint_kv_writes", "lint_engine_aliasing",
           "check_pool_consistency", "step_args", "widest_family"]

_PASS = "kv-aliasing"

# labels a guarded pool write's *indices* must carry: provenance through
# the block-table gather, and the validity-predicated zero route
REQUIRED_INDEX_LABELS = frozenset({"block_tables", TRASH_LABEL})


def _pages(path: str) -> Optional[str]:
    return "pages" if "_pages" in path else None


def taint_step(fn, args: Sequence, role_of_arg: dict, *,
               device=None) -> TaintWalker:
    """Trace ``fn`` at ``args`` with fake tensors
    (:func:`~repro_torch.analysis.graph_tools.trace_step`) and taint-walk
    the graph with the given argument roles (position -> role, or a
    callable of a leaf's path for a tree such as the cache dict)."""
    gm = trace_step(fn, tuple(args), device=device)
    return TaintWalker().run(gm, leaf_labels(tuple(args), role_of_arg))


def lint_kv_writes(walker: TaintWalker, family: str,
                   *, expect_writes: int = 1) -> List[Finding]:
    """Judge the walker's recorded write sites against the pool contract."""
    f: List[Finding] = []
    pool_writes = [w for w in walker.write_sites if w.writes("pages")]
    if len(pool_writes) < expect_writes:
        f.append(Finding(
            _PASS, "missing-write", family,
            f"found {len(pool_writes)} pool write(s), expected >= "
            f"{expect_writes} — either the analyzer lost the pages label "
            f"or a write was restructured past the walker; the pass is "
            f"only meaningful when it sees the writes it judges"))
    for w in pool_writes:
        missing = REQUIRED_INDEX_LABELS - w.index_labels
        if missing:
            f.append(Finding(
                _PASS, "unguarded-write", f"{w.prim} @ {w.where}",
                f"{family}: pool write indices lack {sorted(missing)} "
                f"(have {sorted(w.index_labels)}; graph path {w.path}) — "
                f"every KV write must be addressed through the block-table "
                f"gather and route invalid rows to trash page 0",
                detail={"labels": sorted(w.index_labels)}))
    return f


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _plan_arg(engine, w: int):
    """The fixed-size ragged plan of a flat step of width ``w`` (any
    layout gives the same shape and split count; all padding here), on
    the engine's device, or None on the CPU, whose plain attention takes
    none."""
    if engine.device.type != "cuda":
        return None
    import numpy as np
    plan = engine._ragged_plan(np.full(w, -1, np.int32), np.zeros(w, np.int32))
    return _meta(plan.items.shape, torch.int32), plan.splits


def step_args(engine, label: str):
    """``(fn, args, roles)`` of one step family of ``engine`` labelled as
    :func:`~repro_torch.analysis.shapes.step_families` labels it: the
    step method of the engine's model over its parameters and caches (or
    the batch-1 prefill view) and meta stand-ins for the step's inputs,
    and the roles of the pool, the block tables and the validity inputs.
    ``fn(*args)`` is the step; a flat step takes its plan's items as its
    last argument."""
    from repro_torch.analysis.shapes import step_families
    from repro_torch.kernels.ragged_attn.ops import RaggedPlan
    from repro_torch.serving.kv_cache import prefill_view

    g = dict(step_families(engine))[label]
    model = engine.model
    i32 = torch.int32
    mp = engine.max_pages
    roles = {1: _pages, 3: "block_tables", 4: "validity", 5: "validity"}
    if g.kind == "flat":
        w, k1 = g.seq, g.logits
        base = (engine.params, engine.caches, _meta((1, w), i32),
                _meta((engine.slots, mp), i32), _meta((w,), i32),
                _meta((w,), i32), _meta((engine.slots * k1,), i32))
        plan = _plan_arg(engine, w)
        if plan is None:
            return model.flat_decode_step, base, roles
        items, splits = plan

        def flat(*a):
            return model.flat_decode_step(*a[:-1], plan=RaggedPlan(a[-1], splits))
        return flat, base + (items,), roles
    caches = (prefill_view(engine.caches, engine._prefill_states)
              if label.startswith("prefill") else engine.caches)
    b, s = g.batch, g.seq
    idx = (None if not label.endswith("verify") and not label.startswith("verify")
           else _meta((b, g.logits), i32))
    return model.paged_decode_step, (
        engine.params, caches, _meta((b, s), i32), _meta((b, mp), i32),
        _meta((b,), i32), _meta((b,), i32), idx), roles


def _unit_walkers(engine):
    """Taint-walk the unit KV updates at this engine's shapes."""
    from repro_torch.models import attention
    cfg, dt = engine.model.cfg, engine.model.compute_dtype
    pool, i32 = engine.pool, torch.int32
    shp = (pool.num_pages, pool.page_tokens, cfg.n_kv_heads, cfg.d_head)
    cache = {"k_pages": _meta(shp, dt), "v_pages": _meta(shp, dt)}
    b, mp = engine.slots, engine.max_pages
    roles = {0: _pages, 3: "block_tables", 4: "validity", 5: "validity"}
    s = engine.chunk_tokens or engine._bucket
    kv = _meta((b, s, cfg.n_kv_heads, cfg.d_head), dt)
    out = [("paged_kv_update", taint_step(
        lambda c, k, v, bt, ln, nc: attention.paged_kv_update(
            c, k, v, block_tables=bt, lens=ln, new_counts=nc),
        (cache, kv, kv, _meta((b, mp), i32), _meta((b,), i32), _meta((b,), i32)),
        roles, device=engine.device))]
    if engine.flat:
        w = engine._flat_shapes()[0]
        kvf = _meta((1, w, cfg.n_kv_heads, cfg.d_head), dt)
        out.append(("flat_paged_kv_update", taint_step(
            lambda c, k, v, bt, r, q: attention.flat_paged_kv_update(
                c, k, v, block_tables=bt, row_ids=r, q_pos=q),
            (cache, kvf, kvf, _meta((b, mp), i32), _meta((w,), i32),
             _meta((w,), i32)), roles, device=engine.device)))
    return out


def widest_family(engine) -> str:
    """The step family the traced passes take for ``engine``: the widest
    rung of a chunked or flat ladder, else the monolithic decode step
    (the JAX package's representative shapes)."""
    from repro_torch.analysis.shapes import step_families
    fams = [lab for lab, _ in step_families(engine)]
    return fams[0] if engine.chunked else next(
        lab for lab in fams if lab.startswith("decode"))


def lint_engine_aliasing(engine, label: str = "engine", *,
                         traced=None) -> List[Finding]:
    """The KV-aliasing pass on one engine: the unit updates (two writes
    each), then the widest step of its active family
    (:func:`widest_family`; one K and one V write per attention layer:
    the scatters are the same at every ladder width, so one representative
    keeps the pass fast).  A model without attention layers has no pool
    writes to judge and only its step is traced.  ``traced``: that step's
    ``(graph, args, roles)`` when the caller has traced it already."""
    f: List[Finding] = []
    model = engine.model
    here = f"{label} ({model.cfg.name})"
    n_attn = model.cfg.layer_types.count("attn")
    if n_attn:
        for name, walker in _unit_walkers(engine):
            f.extend(lint_kv_writes(walker, f"{here} {name}", expect_writes=2))
    fam = widest_family(engine)
    if traced is None:
        fn, args, roles = step_args(engine, fam)
        traced = (trace_step(fn, args, device=engine.device), args, roles)
    gm, args, roles = traced
    walker = TaintWalker().run(gm, leaf_labels(args, roles))
    f.extend(lint_kv_writes(walker, f"{here} {fam}", expect_writes=2 * n_attn))
    return f


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
