"""The shape-ladder linter.

The paper's codegen argument needs a *finite, m_r-aligned, geometric* set
of step shapes: prepacking pays off only if tile geometry never changes,
and the no-new-program contract (one CUDA graph per step shape, made at
warmup) holds only if every runtime shape is a member of the warmed
ladder.  This module carries the JAX package's pass 1:

* :func:`step_families` — the warmup enumeration (``Engine.warmup``'s
  loops) as ``(label, StepGeometry)`` pairs, the labels being those the
  engine tags each measured step with.  The cost model
  (:func:`repro_torch.obs.attrib.build_cost_model`) prices each one.
* :func:`lint_engine_shapes` with ``trace=False`` — the ladder algebra:
  re-derive each declared ladder from the scheduler contract (chunk ladder
  = ``chunk_tokens`` halved to ``m_r``; flat ladder = the ``m_r``-aligned
  budget cap plus the powers of two of ``m_r`` below it; monolithic
  prefill buckets = geometric ``m_r``-multiples) and diff it against what
  the engine computes (``_chunk_shapes``/``_flat_shapes``/
  ``_prefill_bucket``).

* :func:`lint_engine_shapes` with ``trace=True`` adds the graph audit
  (:func:`check_static_dims`, the JAX package's jaxpr audit): every step
  family x ladder shape is traced with fake tensors
  (:mod:`repro_torch.analysis.graph_tools`), and every node's value must
  have a concrete int shape.  A data-dependent op or a host sync
  (``.item()``, ``.tolist()``, ``nonzero``) makes the trace raise; it is
  reported as a ``static-dims`` finding naming the op and its call site.
  This is the CUDA-graph contract read off the program: a step captured
  once per shape can neither read a value back to the host nor change a
  shape with the data.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.analysis.graph_tools import (TraceError, iter_nodes,
                                              node_where, op_name, trace_step)
from repro_torch.analysis.report import Finding
from repro_torch.core.layout import round_up

__all__ = ["StepGeometry", "step_families", "lint_engine_shapes",
           "check_static_dims", "trace_findings"]

_PASS = "shape-ladder"


@dataclasses.dataclass(frozen=True)
class StepGeometry:
    """The shape of one step family: ``kind`` ``"flat"`` (the ``[1, W]``
    token stream) or ``"paged"`` (``[batch, seq]``); ``logits`` positions
    read per row (per slot in the flat step); ``rows`` the block-table
    rows the step gathers KV for (every slot in the flat step, ``batch``
    otherwise)."""

    kind: str
    batch: int
    seq: int
    logits: int
    rows: int

    @property
    def width(self) -> int:
        """Padded token positions per step (the grid)."""
        return self.batch * self.seq


def step_families(engine) -> List[Tuple[str, StepGeometry]]:
    """Every step family × ladder shape this engine can hit, in
    ``Engine.warmup``'s order, as ``(label, geometry)``.  Labels:
    ``flat[1,W]/kK`` | ``chunk[B,S]`` | ``chunk[B,S]/verify`` |
    ``prefill[1,b]`` | ``decode[B,1]`` | ``verify[B,K]``.  Where prompts
    prefill at exact lengths (a recurrent model, whose scan padding would
    reach, or m_r = 1) the prefill families ``prefill[1,n]`` are one per
    prompt length, made as prompts arrive: none is enumerable here, as in
    the JAX package, whose warmup makes only ``decode[B,1]`` then."""
    b = engine.slots
    k1s = [1] + ([engine.spec_tokens + 1]
                 if engine.spec_tokens is not None else [])
    fams = []
    if engine.flat:
        for w in engine._flat_shapes():
            for k1 in k1s:
                fams.append((f"flat[1,{w}]/k{k1}",
                             StepGeometry("flat", 1, w, k1, b)))
        return fams
    if engine.chunked:
        for s in engine._chunk_shapes() + [1]:
            fams.append((f"chunk[{b},{s}]", StepGeometry("paged", b, s, 1, b)))
        if engine.spec_tokens is not None:
            for s in engine._chunk_shapes():
                fams.append((f"chunk[{b},{s}]/verify",
                             StepGeometry("paged", b, s, k1s[-1], b)))
        return fams
    # exact-length prefills (recurrent, or m_r = 1): no bucket ladder
    l, seen = engine._bucket, set() if engine._bucket > 1 else {1}
    while (bucket := engine._prefill_bucket(l)) not in seen:
        seen.add(bucket)
        fams.append((f"prefill[1,{bucket}]",
                     StepGeometry("paged", 1, bucket, 1, 1)))
        l = bucket + 1
    fams.append((f"decode[{b},1]", StepGeometry("paged", b, 1, 1, b)))
    if engine.spec_tokens is not None:
        k1 = k1s[-1]
        fams.append((f"verify[{b},{k1}]", StepGeometry("paged", b, k1, k1, b)))
    return fams


def _declared_flat_ladder(engine) -> set:
    cap = round_up(max(engine.token_budget,
                       engine.slots * ((engine.spec_tokens or 0) + 1)),
                   engine._bucket)
    ladder = {cap}
    v = engine._bucket
    while v < cap:
        ladder.add(v)
        v *= 2
    return ladder


def _declared_chunk_ladder(engine) -> set:
    m_r = engine._bucket
    ladder, c = {engine.chunk_tokens}, engine.chunk_tokens
    while c % 2 == 0 and c // 2 >= m_r and (c // 2) % m_r == 0:
        c //= 2
        ladder.add(c)
    return ladder


def check_static_dims(gm, family: str) -> List[Finding]:
    """Every node's value in the traced graph (nested graphs included) has
    a shape of concrete ints: no data-dependent or symbolic dim in a step
    family."""
    findings = []
    for path, node in iter_nodes(gm):
        vals = node.meta.get("val")
        for v in (vals if isinstance(vals, (list, tuple)) else [vals]):
            shape = getattr(v, "shape", ())
            if all(isinstance(d, int) for d in shape):
                continue
            findings.append(Finding(
                _PASS, "static-dims",
                f"{op_name(node.target)} @ {node_where(node)}",
                f"{family}: non-static dim in shape {tuple(shape)} (graph "
                f"path {path}, node {node.name}) — every captured step shape "
                f"must be a concrete int or the one-graph-per-shape contract "
                f"is void"))
    return findings


def trace_findings(fn, args, family: str, *, device=None, stacks: bool = True):
    """``(graph or None, findings)``: trace ``fn(*args)`` with fake tensors
    and audit its dims; a trace stopped by a data-dependent op or a host
    sync is one ``static-dims`` finding naming it."""
    try:
        gm = trace_step(fn, args, device=device, stacks=stacks)
    except TraceError as e:
        return None, [Finding(_PASS, "static-dims", f"{e.op} @ {e.where}",
                              f"{family}: {e.message} — a captured step "
                              f"cannot read a tensor back to the host or "
                              f"size a tensor by its data")]
    return gm, check_static_dims(gm, family)


def lint_engine_shapes(engine, label: str = "engine", *,
                       trace: bool = False) -> List[Finding]:
    """Pass 1 on one engine configuration: the ladder algebra, and with
    ``trace=True`` the graph audit of every step family x ladder shape
    (:func:`check_static_dims`)."""
    f: List[Finding] = []
    m_r = engine._bucket
    here = f"{label} ({engine.model.cfg.name})"

    if engine.pool.page_tokens % max(m_r, 1) != 0:
        f.append(Finding(_PASS, "page-align", here,
                         f"page_tokens={engine.pool.page_tokens} is not a "
                         f"multiple of m_r={m_r} — pages must be whole "
                         f"microkernel tiles"))
    if engine.chunked:
        if engine.chunk_tokens % m_r != 0:
            f.append(Finding(_PASS, "chunk-align", here,
                             f"chunk_tokens={engine.chunk_tokens} is not "
                             f"m_r-aligned (m_r={m_r}) — chunk writes "
                             f"would straddle tiles",
                             detail={"chunk_tokens": engine.chunk_tokens,
                                     "m_r": m_r}))
        if engine.token_budget < m_r:
            f.append(Finding(_PASS, "budget-liveness", here,
                             f"token_budget={engine.token_budget} < m_r="
                             f"{m_r}: plan_chunks rounds grants down to "
                             f"the tile, so prefill could never advance"))
        declared = _declared_chunk_ladder(engine)
        actual = set(engine._chunk_shapes())
        for c in sorted(actual):
            if c % m_r != 0:
                f.append(Finding(_PASS, "chunk-align", here,
                                 f"ladder shape {c} is not m_r-aligned "
                                 f"(m_r={m_r})",
                                 detail={"shape": c, "m_r": m_r}))
        if actual != declared and engine.chunk_tokens % m_r == 0:
            f.append(Finding(_PASS, "chunk-ladder", here,
                             f"chunk ladder {sorted(actual)} != declared "
                             f"geometric ladder {sorted(declared)}"))
        if (engine.spec_tokens is not None
                and engine.chunk_tokens < engine.spec_tokens + 1):
            f.append(Finding(_PASS, "verify-width", here,
                             f"chunk_tokens={engine.chunk_tokens} cannot "
                             f"hold the [{engine.spec_tokens + 1}]-wide "
                             f"verify row"))
    if engine.flat:
        declared = _declared_flat_ladder(engine)
        actual = set(engine._flat_shapes())
        for w in sorted(actual):
            if w % m_r != 0:
                f.append(Finding(_PASS, "flat-align", here,
                                 f"flat width {w} is not m_r-aligned "
                                 f"(m_r={m_r}) — tile writes would be "
                                 f"partial",
                                 detail={"width": w, "m_r": m_r}))
        if actual != declared:
            f.append(Finding(_PASS, "flat-ladder", here,
                             f"flat ladder {sorted(actual)} != declared "
                             f"{sorted(declared)}"))
        for n in {1, m_r, m_r + 1, max(declared), engine.token_budget}:
            if n < 1 or n > max(declared):
                continue
            w = engine._flat_shape(n)
            fits = sorted(x for x in declared if x >= n)
            if w not in declared or w < n or (fits and w != fits[0]):
                f.append(Finding(_PASS, "flat-pick", here,
                                 f"_flat_shape({n}) = {w}, expected the "
                                 f"smallest ladder member >= {n} "
                                 f"({fits[0] if fits else '??'})"))
    if not engine.chunked and m_r > 1:
        cap = round_up(engine.scheduler.max_len, m_r)
        l, seen = m_r, set()
        while True:
            b = engine._prefill_bucket(l)
            if b in seen:
                break
            seen.add(b)
            ok_geo = b == cap or (b % m_r == 0
                                  and (b // m_r & (b // m_r - 1)) == 0)
            if b < l or b > cap or not ok_geo:
                f.append(Finding(_PASS, "prefill-bucket", here,
                                 f"_prefill_bucket({l}) = {b}: must be a "
                                 f"geometric m_r-multiple in [{l}, {cap}]"))
            l = b + 1
    if trace:
        from repro_torch.analysis.aliasing import step_args
        for fam, _ in step_families(engine):
            fn, args, _ = step_args(engine, fam)
            f.extend(trace_findings(fn, args, f"{here} {fam}",
                                    device=engine.device)[1])
    return f
