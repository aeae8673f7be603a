"""Model facade: init, the two paged serving steps, and their compiled
forms.

The port's ``ReproModel`` serves continuous batching through
``paged_decode_step`` (the dense chunked and monolithic engine steps) and
``flat_decode_step`` (the flat token-level step).  ``compiled_step(kind)``
stands where the JAX package's ``jit_step`` stands: one program per step
signature, counted in ``trace_counts`` and logged in ``trace_log``.  On
the card that program is a CUDA graph, captured at the signature's first
call and replayed on every later one.  Training and the other families
arrive in later slices of the port.
"""

from __future__ import annotations

import gc
import weakref
from typing import Optional

import torch

from repro_torch import kernels

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.core.hardware import HardwareSpec, query, require_device
from repro_torch.core.layout import LayoutPolicy
from repro_torch.core.linear import MatmulContext
from repro_torch.kernels.ragged_attn.ops import RaggedPlan
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed_apply

__all__ = ["ReproModel", "CompiledStep", "build_model"]


class ReproModel:
    """One model configuration on one device.  ``device`` defaults to
    ``cuda`` and raises without a card; ``device="cpu"`` runs the kernels'
    plain versions."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                 hw: Optional[HardwareSpec] = None, device="cuda"):
        self.device = require_device(device)
        self.cfg = cfg
        self.run = run
        self.shape = shape
        self.ctx = MatmulContext(policy=LayoutPolicy(run.layout_policy),
                                 hw=hw or query(self.device),
                                 propagate=run.propagate)
        self.compute_dtype = getattr(torch, run.compute_dtype)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters with the JAX package's tree, shapes and
        scales, drawn from ``generator`` (a CPU generator: the same seed
        gives the same weights on every device), then moved to the device."""
        params = tfm.lm_init(generator, self.cfg, self.run)
        return tfm.tree_map(lambda t: t.to(self.device), params)

    def init_paged_cache(self, num_pages: int, page_tokens: int,
                         slots: int) -> dict:
        """The shared K/V page pools ``[G, P, T, Hkv, dh]`` (page 0 = trash).
        ``slots`` is accepted for parity with the JAX package, whose
        recurrent families keep per-slot state; attention needs none."""
        del slots
        return tfm.init_paged_caches(self.cfg, num_pages, page_tokens,
                                     self.compute_dtype, self.device)

    def paged_decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                          block_tables: torch.Tensor, lens: torch.Tensor,
                          new_counts: torch.Tensor,
                          logits_idx: Optional[torch.Tensor] = None):
        """The continuous-batching ``[B, s]`` step: row ``b`` carries
        ``new_counts[b]`` new tokens at positions ``lens[b]..`` (1 for a
        decode row, a prompt chunk for a prefill row, 0 for an inert row
        whose writes go to the trash page).  ``block_tables`` [B, MP];
        ``logits_idx`` [B, K] within-row positions to read logits at, or
        None for each row's last valid token.  Returns (logits [B, K, V],
        caches), K = 1 when ``logits_idx`` is None.  The pools in
        ``caches`` are updated in place; the returned ``caches`` is the
        same object."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        positions = lens[:, None] + torch.arange(token.shape[1], dtype=lens.dtype,
                                                 device=token.device)
        paged = {"block_tables": block_tables, "lens": lens,
                 "new_counts": new_counts}
        logits_at = (torch.clamp(new_counts - 1, min=0) if logits_idx is None
                     else logits_idx)
        logits = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                              positions=positions, caches=caches, paged=paged,
                              logits_at=logits_at)
        return logits, caches

    def flat_decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                         block_tables: torch.Tensor, row_ids: torch.Tensor,
                         q_pos: torch.Tensor, logits_idx: torch.Tensor,
                         plan: Optional[RaggedPlan] = None):
        """One flat ``[1, W]`` step: position ``i`` is token ``q_pos[i]`` of
        engine row ``row_ids[i]`` (-1 = padding); ``block_tables`` [B, MP];
        ``logits_idx`` [K] flat positions to read logits at; ``plan``: the
        ragged-attention plan of row_ids/q_pos on this device (needed on
        the card, ignored on the CPU).  Returns (logits [1, K, V], caches).

        The page pools in ``caches`` are updated in place (the JAX package
        donates them to its jitted step instead); the returned ``caches``
        is the same object."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        paged = {"block_tables": block_tables, "row_ids": row_ids,
                 "q_pos": q_pos, "plan": plan}
        logits = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                              positions=q_pos[None, :], caches=caches,
                              paged=paged, logits_at=logits_idx[None, :])
        return logits, caches

    @property
    def trace_counts(self) -> dict:
        """Programs made per step kind: on the CPU the first call of each
        new signature (the JAX package's trace), on the card each CUDA
        graph captured.  No growth after ``Engine.warmup`` is the
        no-compile contract."""
        if not hasattr(self, "_trace_counts"):
            self._trace_counts = {"decode": 0, "paged": 0, "flat": 0}
        return self._trace_counts

    @property
    def trace_log(self) -> list:
        """One entry per program made: ``{"kind", "args"}``, ``args``
        mapping each step input to its (shape, dtype), or None."""
        if not hasattr(self, "_trace_log"):
            self._trace_log = []
        return self._trace_log

    def compiled_step(self, kind: str) -> "CompiledStep":
        """The cached compiled form of the ``"paged"`` or ``"flat"`` step,
        shared by every engine over this model (the JAX package's
        ``jit_step``)."""
        if not hasattr(self, "_steps"):
            self._steps = {}
        if kind not in self._steps:
            self._steps[kind] = CompiledStep(self, kind)
        return self._steps[kind]


_ARG_NAMES = {"paged": ("token", "block_tables", "lens", "new_counts",
                        "logits_idx"),
              "flat": ("token", "block_tables", "row_ids", "q_pos",
                       "logits_idx")}


class _Graph:
    """One captured step: the graph, its static inputs (the step copies
    each call's inputs into them), its output, and the counts its kernel
    launches add to the wrappers' (:mod:`repro_torch.kernels`) per replay."""

    def __init__(self, graph, inputs, plan, out, counts):
        self.graph, self.inputs, self.plan = graph, inputs, plan
        self.out, self.counts = out, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class CompiledStep:
    """A step kind run as one program per signature: the kind, each
    input's shape and dtype (None stays None) and the ragged plan's shape
    and split count (the kernel's grid and cluster).

    On the CPU the first call of a signature counts as its trace and every
    call runs eagerly.  On the card the first call of a signature runs
    eagerly (which also sets each kernel's launch attributes before any
    capture), then captures the step into a CUDA graph over copies of its
    inputs, on a side stream into one memory pool that all of the model's
    graphs share (steps never overlap).  Each later call copies its inputs
    into the graph's buffers, replays it and returns the graph's own
    output tensor, which the next replay overwrites: read it first.  A
    graph holds the addresses of the parameters and pools it was captured
    with, so on the card the signature also holds their data pointers.  A
    capture that fails raises; nothing falls back to the eager step."""

    def __init__(self, model: ReproModel, kind: str):
        # a weak reference: the model holds its compiled steps, and without
        # a cycle a dropped model (and its graphs) is freed at once
        self._model = weakref.ref(model)
        self.kind = kind
        self.graphs = {}
        self._seen = set()
        self._pool = None
        self._stream = None

    @property
    def model(self) -> ReproModel:
        return self._model()

    @property
    def fn(self):
        """The eager step method this step compiles."""
        return {"paged": self.model.paged_decode_step,
                "flat": self.model.flat_decode_step}[self.kind]

    def signature(self, args, plan) -> tuple:
        return (self.kind,
                tuple(None if a is None else (tuple(a.shape), a.dtype)
                      for a in args),
                None if plan is None else (tuple(plan.items.shape), plan.splits))

    def __call__(self, params: dict, caches: dict, *args,
                 plan: Optional[RaggedPlan] = None):
        """``args``: the step method's inputs after ``caches``; returns
        (logits, caches) as the step method does."""
        sig = self.signature(args, plan)
        if self.model.device.type == "cpu":
            if sig not in self._seen:
                self._seen.add(sig)
                self._count(args)
            extra = {} if plan is None else {"plan": plan}
            return self.fn(params, caches, *args, **extra)
        key = (sig, tuple(t.data_ptr() for t in _leaves(params)),
               tuple(t.data_ptr() for t in _leaves(caches)))
        g = self.graphs.get(key)
        if g is None:
            self._count(args)
            out, self.graphs[key] = self._capture(params, caches, args, plan)
            return out, caches
        for buf, a in zip(g.inputs, args):
            if buf is not None:
                buf.copy_(a)
        if g.plan is not None:
            g.plan.items.copy_(torch.as_tensor(plan.items))
        g.graph.replay()
        kernels.add_counts(g.counts)
        return g.out, caches

    def _count(self, args) -> None:
        self.model.trace_counts[self.kind] += 1
        self.model.trace_log.append({"kind": self.kind, "args": {
            name: None if a is None else (tuple(a.shape), str(a.dtype))
            for name, a in zip(_ARG_NAMES[self.kind], args)}})

    def _capture(self, params, caches, args, plan):
        dev = self.model.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        inputs = [None if a is None else a.to(dev, copy=True) for a in args]
        splan = None if plan is None else RaggedPlan(
            torch.as_tensor(plan.items).to(dev, copy=True), plan.splits)
        extra = {} if splan is None else {"plan": splan}
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            out, _ = self.fn(params, caches, *inputs, **extra)
            before = kernels.counters()
            graph = torch.cuda.CUDAGraph()
            # no cyclic garbage collection inside the capture: it could
            # destroy a dropped model's graphs, and releasing their pool
            # frees device memory, which a capture forbids
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=s):
                    static_out, _ = self.fn(params, caches, *inputs, **extra)
            finally:
                if collecting:
                    gc.enable()
            after = kernels.counters()
        torch.cuda.current_stream(dev).wait_stream(s)
        counts = {k: after[k] - before[k] for k in after}
        kernels.add_counts(counts, -1)        # the capture ran nothing
        return out, _Graph(graph, inputs, splan, static_out, counts)


def build_model(cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                hw: Optional[HardwareSpec] = None, device="cuda") -> ReproModel:
    return ReproModel(cfg, run, shape, hw, device=device)
