"""Serving engine: continuous batching over a paged KV cache, through one
of the JAX package's three step families.

Each step admits waiting requests, grows every decoding row by one KV
position (displacing the youngest admission when the pool runs dry) and
runs one or more model calls; logits come back to the host, where each
pick is made from a float32 copy.  The families:

- **flat** (the default whenever ``chunk_tokens`` is set): the scheduled
  rows are laid out as contiguous *segments* of one ``[1, W]`` token
  stream, with per-position ``row_ids`` (-1 = padding) and absolute
  ``q_pos``; ``W`` comes from a geometric ladder of ``m_r``-aligned widths
  over the token budget, so a decode row costs exactly its one position;
- **dense chunked** (``flat=False``): one ``[slots, s]`` step in which a
  decoding row carries 1 token and a prefilling row its next chunk, ``s``
  from the chunk ladder (``chunk_tokens`` halved down to ``m_r``) or 1;
- **monolithic** (no ``chunk_tokens``): each admission is prefilled alone
  at a geometric bucket ``[1, b]``, then every running row decodes in one
  ``[slots, 1]`` step.

All three schedule alike and give the same tokens.  Every model call goes
through the model's compiled step (``ReproModel.compiled_step``), which
counts one program per step signature and model (``stats()["compiles"]``);
on the card each engine replays its own CUDA graph per step shape, held in
its :class:`~repro_torch.models.model.GraphTable` (``stats()["captures"]``).
:meth:`Engine.warmup` makes every shape the engine can hit, so a drain
after it makes and captures nothing.

- **Sampled picks** (``greedy=False``): the JAX engine's draw keyed by
  ``(seed, rid, position)``, transcribed in
  :mod:`repro_torch.serving.sampling`; per-request ``temperature`` (0 picks
  greedily) and ``seed`` come from :meth:`Engine.add_request`.
- **Prefix cache** (``prefix_cache=True``): admission starts at the longest
  cached page-chain prefix of the prompt (:mod:`~repro_torch.serving.
  prefix_cache`), prefill inserts its full pages, preemption releases into
  the cache; a shared page is copied on the device (in place in the pools)
  before anything writes into it.
- **Speculative decode** (``spec_tokens=k``): a drafter
  (:mod:`~repro_torch.serving.speculative`) proposes up to ``k`` tokens per
  decoding row, the row feeds ``1 + k`` positions through the family's
  step, the logits after each are read in that one call, and the
  acceptance rule keeps the tokens those of the engine without drafts;
  rejected KV is rolled back by truncating the block table.

Resilience (:mod:`~repro_torch.serving.faults` injects the faults it
handles): with ``queue_limit`` or ``queue_pages`` an arrival beyond the
bounded queue finishes at once as ``"rejected"``; :meth:`Engine.cancel`
retires a request from any state; a request past its ``deadline_s`` or
``max_queue_s`` on the clock of ``step(now=...)`` finishes as
``"timeout"``; with ``nan_guard`` a row whose logits are not finite is
retired alone as ``"error"``, its pages kept out of the prefix cache; a
drafter that raises costs that step's drafts, and three failures in a row
turn speculation off for the rest of the drain; and ``watchdog_steps``
steps in which arrived work waits without any progress raise
:class:`StallError`.  Each of these changes host bookkeeping only, so
survivors keep their tokens and a warmed engine captures nothing more.
Shed and cancelled requests are delivered by the next :meth:`Engine.step`.
``REPRO_SANITIZE=1`` installs the runtime sanitizer
(:mod:`repro_torch.analysis.sanitize`) on every engine.

Recurrent models (RWKV-6; mamba beside attention) keep per-slot state
beside the page pools and are served by the monolithic family only, as in
the JAX package: a scan carries state through every position it is fed,
so padding is not inert to it.  Their prompts prefill at exact lengths
(one program, and on the card one graph, per distinct length) from a
single-slot state tree the engine owns and zeroes in place before each
prefill, whose result is copied into the request's slot; a preempted
request re-prefills from zero state.  Chunked prefill (and so the flat
step), the prefix cache and speculative decode are refused for them.

The static batch loop (:meth:`Engine.generate_static`, the JAX package's
pre-continuous path) serves a batch of one shared prompt length in lock
step through the model's dense-cache ``decode_step``: the prefill
``[B, plen]`` and the decode ``[B, 1]`` are two signatures of the one
compiled ``"decode"`` step, and on the card two graphs over one dense
cache per batch shape that the engine's graph table keeps.  The
encoder-decoder family (whisper) and the vlm family (a patch prefix) are
served only so (:meth:`generate` takes that path for them), whisper with
its weights left unpacked, as in the JAX package; an engine over either
refuses the continuous path's options.

Across ranks (``mesh=`` a ``DeviceMesh`` of ``("data", "model") = (1,
R)``, one process a rank, each with a model built on the same mesh):
every rank serves the same requests through the same scheduler, holding
its shard of the weights (:func:`~repro_torch.distributed.sharding.
shard_params` under ``param_specs``: whole tiles) and of the page pools
(``cache_specs``: the page dim over ``model``, the global pages ``[r P /
R, (r + 1) P / R)`` on rank r, beside a trash slot of its own).  A step's
products are tensor-parallel and its attention a flash-decode across the
ranks (``models/attention.py``); its logits come back whole on every
rank, so every rank takes the same host decisions and the same sampled
picks (the key is the request's), with the tokens of the engine on one
rank.  The dense family serves so, and the static loop of the dense,
vlm and encdec families (:meth:`Engine.generate_static`: each rank holds
its window of the dense caches, the sequence over ``model``, and its
greedy and sampled picks are every other rank's); the rest is refused
with its ROADMAP item (``models/model.py:ACROSS_RANKS``): a data axis,
``seq_shard_kv=False``, the moe and recurrent families, the prefix cache,
speculative decode.  The steps run uncaptured across ranks, on the
card too: a gloo collective cannot be captured in a CUDA graph, and a
capture with NCCL is queued (``stats()["captures"]`` stays 0).  A
caller's clock (``step(now=)``) must read the same on every rank.

Telemetry (``telemetry=True``, :mod:`repro_torch.obs`) observes without
taking part: request lifecycle marks, a ``device`` span around each model
call (closed after the host copy of its logits, the step's one
synchronizing point) tagged with its step family, a ``draft`` span, the
cache, rollback and fault instants, and :meth:`Engine.telemetry`'s view;
with it off every hook is one no-op call.
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.hardware import require_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.core.layout import ceil_div, round_up
from repro_torch.core.linear import prepack_params
from repro_torch.kernels.ragged_attn.ops import plan_ragged
from repro_torch.models import transformer as tfm
from repro_torch.models.model import ACROSS_RANKS, GraphTable, ReproModel
from repro_torch.models.transformer import tree_map
from repro_torch.obs.telemetry import NULL as OBS_NULL
from repro_torch.obs.telemetry import NullTelemetry, Telemetry
from repro_torch.serving import sampling
from repro_torch.serving.kv_cache import (PagedKVPool, PoolError, copy_pages,
                                          fresh_slot_states, merge_slot,
                                          prefill_view, zero_slot_states)
from repro_torch.serving.faults import StallError
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import (AdmissionError, Request, Scheduler,
                                           finish_reason_for)
from repro_torch.serving.speculative import Drafter, NgramDrafter, accept_tokens

__all__ = ["Engine", "StallError"]

WATCHDOG_STEPS = 64          # the default of Engine(watchdog_steps=)
# the families served only by the static batch loop (generate_static)
_STATIC_FAMILIES = ("encdec", "vlm")


def _page_copier(caches, device):
    """The engine's device page copy for the pool's copy-on-write: the
    index tensors are made on the device (a fill, no copy from the host),
    and the copy writes into the pools in place."""
    def copy(src: int, dst: int) -> None:
        copy_pages(caches,
                   torch.full((1,), src, dtype=torch.int64, device=device),
                   torch.full((1,), dst, dtype=torch.int64, device=device))
    return copy


def _check_across_ranks(model: ReproModel, mesh, *, prepack: bool,
                        prefix_cache: bool, spec: bool):
    """The model axis an engine over ``mesh`` (more than one rank) serves
    on, or the refusal of what the port does not serve across ranks, each
    naming its ROADMAP item (``models/model.py:ACROSS_RANKS``)."""
    sizes = axis_sizes(mesh)
    ranks = math.prod(sizes.values())
    where = f"Engine(mesh=): a mesh of {ranks} ranks {sizes}"
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    if dp > 1:
        raise NotImplementedError(f"{where}: a data axis of {dp}; the port "
                                  f"serves on ('data', 'model') = (1, R); "
                                  f"ROADMAP {ACROSS_RANKS['data']}")
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"{where} given as an AbstractMesh: serving across "
                         f"ranks needs their process group (a DeviceMesh)")
    if model.ctx.tp is None or model.ctx.tp.size != sizes.get("model", 1):
        raise ValueError(f"{where}: the model was not built on this mesh "
                         f"(build_model(..., mesh=mesh))")
    if not model.run.seq_shard_kv:
        raise NotImplementedError(f"{where}: seq_shard_kv=False; ROADMAP "
                                  f"{ACROSS_RANKS['heads']}")
    if prefix_cache or spec:
        raise NotImplementedError(f"{where}: the prefix cache or speculative "
                                  f"decode; ROADMAP {ACROSS_RANKS['prefix']}")
    if not (prepack and model.ctx.packed):
        raise NotImplementedError(f"{where}: prepack=False or the unpacked "
                                  f"policy; ROADMAP {ACROSS_RANKS['unpacked']}")
    return model.ctx.tp


class Engine:
    def __init__(self, model: ReproModel, params, *, device="cuda", mesh=None,
                 prepack: bool = True, max_slots: Optional[int] = None,
                 page_tokens: int = 16, num_pages: Optional[int] = None,
                 eager: bool = False, watermark_pages: int = 1,
                 chunk_tokens: Optional[int] = None,
                 flat: Optional[bool] = None,
                 token_budget: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 drafter: Optional[Drafter] = None,
                 prefix_cache: bool = False,
                 queue_limit: Optional[int] = None,
                 queue_pages: Optional[int] = None,
                 watchdog_steps: int = WATCHDOG_STEPS,
                 nan_guard: bool = True,
                 telemetry=False):
        self.device = require_device(device, meta=True)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        # mesh= (the JAX package's): the caches are placed on the mesh by
        # sharding.cache_specs.  One rank holds every shard, so a mesh of
        # one rank serves as no mesh does, bit for bit; across the ranks of
        # a 'model' axis each rank holds its shards (module docstring)
        self.mesh = mesh
        self.tp = None
        if mesh is not None and math.prod(axis_sizes(mesh).values()) > 1:
            self.tp = _check_across_ranks(model, mesh, prepack=prepack,
                                          prefix_cache=prefix_cache,
                                          spec=spec_tokens is not None
                                          or drafter is not None)
        self.model = model
        # observability (repro_torch.obs): ``telemetry=True`` builds a live
        # Telemetry, an instance is used as is, and the default keeps the
        # no-op NULL recorder (one no-op call per event, no clock read)
        self.obs = (telemetry if isinstance(telemetry, NullTelemetry)
                    else Telemetry() if telemetry else OBS_NULL)
        # the per-family step cost model, built by warmup() when telemetry
        # is live, and only there (repro_torch.obs.attrib)
        self.cost_model = None
        if self.tp is not None:
            # the rank's whole tiles of each weight, packed as they come
            # (the caller's whole tree is read, never copied whole); a tree
            # that is already a rank's shard (weights.from_jax_params with
            # mesh=) is served as it is
            if not any(k.endswith("/w_split")
                       for k in sharding.tree_paths(params)):
                params = sharding.shard_params(
                    params, sharding.param_specs(params, model.run, mesh), mesh,
                    sharding.mesh_coord(mesh), model.ctx.layout)
            self.params = prepack_params(tree_map(
                lambda t: t.to(self.device), params), model.ctx, consume=True)
        else:
            params = tree_map(lambda t: t.to(self.device), params)
            # prepack=False packs every weight inside every step instead; the
            # encdec family is never prepacked, as in the JAX package
            self.params = (prepack_params(params, model.ctx)
                           if prepack and model.cfg.family != "encdec" else params)
        # the static batch loop: prefill [B, plen] and decode [B, 1] are two
        # signatures of the model's one compiled "decode" step
        self._graphs = GraphTable()
        self._decode_step = model.compiled_step("decode")
        self._static_bufs = {}       # (B[, frames]) -> its dense cache tree
        self._next_rid = 0
        self.continuous = model.cfg.family not in _STATIC_FAMILIES
        if not self.continuous:
            fam = model.cfg.family
            for bad, what in ((flat, "the flat token-level step"),
                              (chunk_tokens is not None, "chunked prefill"),
                              (spec_tokens is not None or drafter is not None,
                               "speculative decode"),
                              (prefix_cache, "the prefix cache")):
                if bad:
                    raise ValueError(f"{fam} serves through generate_static; "
                                     f"{what} needs the continuous paged path")
            return

        layout = model.ctx.layout(model.compute_dtype)
        cfg = model.cfg
        all_attn = all(t == "attn" for t in cfg.layer_types)
        # only pure attention pads prefills to a bucket: a recurrent scan
        # carries state through padded positions, so it prefills exactly
        self._bucket = layout.m_r if all_attn else 1
        self.slots = max_slots or model.shape.global_batch
        max_len = model.shape.seq_len
        page_tokens = round_up(page_tokens, layout.m_r)
        if chunk_tokens is not None:
            if chunk_tokens < 1:
                raise ValueError(f"chunk_tokens={chunk_tokens}: a chunk must "
                                 f"carry at least one token")
            if not all_attn:
                raise ValueError(f"chunked prefill: {cfg.name} mixes recurrent "
                                 f"layers ({cfg.layer_types}): an ssm/rwkv scan "
                                 f"carries state through padded chunk rows, so "
                                 f"only pure-attention models fuse prefill "
                                 f"chunks into the decode step")
            # chunk writes land on whole microkernel tiles, like pages
            chunk_tokens = min(round_up(chunk_tokens, layout.m_r),
                               round_up(max_len, layout.m_r))
        self.chunk_tokens = chunk_tokens
        self.chunked = chunk_tokens is not None
        # flat=False keeps the dense [slots, chunk] step as the A/B baseline
        self.flat = self.chunked if flat is None else bool(flat)
        if self.flat and not self.chunked:
            raise ValueError("flat=True needs chunk_tokens: the flat step "
                             "rides the chunked scheduler")
        self.token_budget = (token_budget if token_budget is not None
                             else max(1, self.slots * (chunk_tokens or 1)))
        if self.chunked and self.token_budget < layout.m_r:
            raise ValueError(f"token_budget={self.token_budget} is below one "
                             f"microkernel tile (m_r={layout.m_r}); chunked "
                             f"prefill could never advance")
        if num_pages is None:
            num_pages = 1 + self.slots * ceil_div(max_len, page_tokens)
        self.pool = PagedKVPool(num_pages, page_tokens)
        self.pool.obs = self.obs
        self.max_pages = ceil_div(max_len, self.pool.page_tokens)
        # the caches' specs on the mesh; on its one rank each leaf's shard
        # is the leaf itself, so the engine keeps its tensors as they are
        self.cache_specs = (None if mesh is None else sharding.cache_specs(
            tfm.init_paged_caches(cfg, num_pages, self.pool.page_tokens,
                                  self.slots, model.compute_dtype, "meta"),
            mesh, model.run, self.slots))
        # across ranks: the global pages [lo, lo + count) this rank holds
        # where the specs split the page dim (None: every rank holds all)
        self.kv_shard = None
        local_pages = num_pages
        if self.tp is not None:
            entry = sharding.tree_paths(self.cache_specs)[
                "p0/kv/k_pages"][-4]
            if entry is not None:
                lo, hi = sharding.unit_range(num_pages, entry, mesh,
                                             sharding.mesh_coord(mesh))
                self.kv_shard = (lo, hi - lo)
                local_pages = hi - lo + 1      # and the rank's trash slot
        self.caches = model.init_paged_cache(local_pages, self.pool.page_tokens,
                                             self.slots)
        # what every model call passes on across ranks (nothing on one rank,
        # so a wrapper of the compiled steps sees the one-rank signature)
        self._shard_kw = ({} if self.kv_shard is None
                          else {"kv_shard": self.kv_shard})
        # the single-slot state a prefill starts from: made once, zeroed in
        # place before each prefill, so its graphs bind live tensors.  With
        # one slot it is the slot's own (no other request can be running),
        # so no two cache trees of one shape meet in the graph table
        self._prefill_states = (self.caches if self.slots == 1
                                else fresh_slot_states(self.caches))
        # the prefix cache's chain is rooted in the layout geometry, so a
        # layout change can never alias stale KV
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            if not all_attn:
                raise ValueError(f"prefix cache: {cfg.name} mixes recurrent "
                                 f"layers ({cfg.layer_types}): cached KV pages "
                                 f"restore attention state by block-table "
                                 f"lookup, but an ssm/rwkv scan state cannot be "
                                 f"rebuilt from shared pages")
            if eager:
                raise ValueError("the prefix cache needs lazy allocation: "
                                 "eager=True reserves whole lifetimes, which "
                                 "shared pages would count twice")
            self.prefix_cache = PrefixCache(self.pool, layout_key=(layout.m_r,))
            self.prefix_cache.obs = self.obs
            # the copier holds the pools, not the engine: no reference
            # cycle keeps a dropped engine's device memory alive
            self.pool.page_copier = _page_copier(self.caches, self.device)
        self.scheduler = Scheduler(self.slots, self.pool, max_len, eager=eager,
                                   watermark_pages=watermark_pages,
                                   chunk_tokens=self.chunk_tokens,
                                   chunk_align=layout.m_r,
                                   prefix_cache=self.prefix_cache,
                                   queue_limit=queue_limit,
                                   queue_pages=queue_pages,
                                   telemetry=self.obs)
        # the resilience ladder: shed and cancelled requests leave through
        # the out-of-band list, the watchdog ends a stuck drain, non-finite
        # logits quarantine their row, a failing drafter is turned off for
        # the rest of the drain
        self.watchdog_steps = watchdog_steps
        self.nan_guard = nan_guard
        self._finished_oob: List[Request] = []
        self._retired_rids: set = set()    # no retired rid may hold pages
        self._watchdog_trips = 0
        self._drafter_errors = 0
        self._drafter_fail_streak = 0
        self._drafter_fail_limit = 3
        self._spec_disabled = False
        self._spec_auto_disables = 0
        # speculative decode: every decoding row may carry 1 + k positions
        self.spec_tokens = spec_tokens
        self.drafter: Optional[Drafter] = None
        if spec_tokens is not None:
            if spec_tokens < 1:
                raise ValueError(f"spec_tokens={spec_tokens}: speculation "
                                 f"needs at least one draft position (use "
                                 f"spec_tokens=None to turn it off)")
            if not all_attn:
                raise ValueError(f"speculative decode: {cfg.name} mixes "
                                 f"recurrent layers ({cfg.layer_types}): a "
                                 f"rejected draft's KV rolls back by page "
                                 f"truncation, but an ssm/rwkv scan state "
                                 f"cannot un-absorb rejected positions")
            if self.chunked and self.chunk_tokens < spec_tokens + 1:
                raise ValueError(f"spec_tokens={spec_tokens} needs verify rows "
                                 f"of {spec_tokens + 1} positions, wider than "
                                 f"chunk_tokens={self.chunk_tokens}: the "
                                 f"step's shape ladder must cover the verify "
                                 f"width")
            self.drafter = drafter if drafter is not None else NgramDrafter()
            self.drafter.attach(self)
            self.drafter.obs = self.obs
        elif drafter is not None:
            raise ValueError("a drafter needs spec_tokens set")
        self._no_progress_steps = 0
        self._steps = 0
        self._step_time = 0.0
        self._active_rows = 0        # rows carrying tokens, summed over steps
        self._mixed_steps = 0        # steps carrying at least one prefill chunk
        self._finished_count = 0
        self._finished_served = 0    # finished after an admission
        self._chunk_steps_total = 0  # prefill calls or chunks of the finished
        self._prefill_tokens = 0     # prompt tokens computed (hits skip theirs)
        self._flat_steps = 0
        self._flat_tokens = 0
        self._flat_width = 0
        self._draft_time = 0.0       # host seconds inside the drafter
        self._drafted = 0            # draft tokens verified
        self._accepted = 0           # draft tokens accepted
        self._decode_tokens = 0      # tokens appended by decode rows
        self._decode_rows = 0        # decode row-steps
        self._spec_trims = 0         # draft lists trimmed to the held pages
        self._rollback_pages = 0     # page references dropped by rollbacks
        self._paged_step = model.compiled_step("paged")
        self._flat_step = model.compiled_step("flat") if self.flat else None
        # the runtime sanitizer checks every step's writes on the host
        # before the device call (repro_torch.analysis.sanitize)
        self.sanitizer = None
        if os.environ.get("REPRO_SANITIZE", "0") not in ("", "0"):
            from repro_torch.analysis.sanitize import install
            install(self)

    # ------------------------------------------------------------------
    # continuous-batching API
    # ------------------------------------------------------------------
    def add_request(self, tokens, max_new: int, *, eos_id: Optional[int] = None,
                    arrival: float = 0.0, temperature: float = 1.0,
                    seed: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    max_queue_s: Optional[float] = None) -> int:
        """Queue one request; returns its id.  ``temperature`` and ``seed``
        are its sampling parameters in a sampled drain (``temperature=0``
        picks greedily; ``seed=None`` takes the step's seed).
        ``deadline_s`` and ``max_queue_s`` bound its lifetime and its first
        wait from ``arrival``, on the clock of ``step(now=...)``.  An add
        the bounded queue sheds finishes as ``"rejected"``, delivered by
        the next step; a request that could never fit raises
        :class:`~repro_torch.serving.scheduler.AdmissionError`.  A static
        family's engine refuses: it serves through :meth:`generate_static`."""
        self._need_continuous("add_request")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(tokens, np.int32).reshape(-1),
                      max_new=max_new, eos_id=eos_id, arrival=arrival,
                      temperature=temperature, seed=seed,
                      deadline_s=deadline_s, max_queue_s=max_queue_s)
        try:
            self.scheduler.add(req)
        except AdmissionError as e:
            if e.kind == "impossible":
                raise
            req.status = "finished"
            req.finish_reason = "rejected"
            self.obs.request_shed(req, e.kind)
            self._finished_oob.append(req)
        return rid

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel a live request from any state (queued, prefilling,
        paused, decoding); its pages are released (into the prefix cache
        when there is one) and the next step delivers it with
        ``finish_reason=reason``.  Returns False when ``rid`` is not live."""
        req = self.scheduler.cancel(rid, reason)
        if req is None:
            return False
        self._finished_oob.append(req)
        return True

    def _need_continuous(self, what: str) -> None:
        if not self.continuous:
            raise ValueError(f"{what}: {self.model.cfg.family} serves through "
                             f"generate_static")

    @property
    def num_preemptions(self) -> int:
        return self.scheduler.num_preemptions

    @property
    def num_pauses(self) -> int:
        return self.scheduler.num_pauses

    def stats(self) -> dict:
        """Cumulative counters under the JAX package's keys.  ``compiles``
        is the model's program count per step kind (no growth after
        :meth:`warmup` is the no-compile contract); ``captures`` the CUDA
        graphs this engine captured per kind (zero on the CPU)."""
        self._need_continuous("stats")
        steps = max(1, self._steps)
        out = {
            "steps": self._steps,
            "mean_step_ms": 1e3 * self._step_time / steps,
            "mean_slot_occupancy": self._active_rows / (steps * self.slots),
            "mixed_steps": self._mixed_steps,
            "prefill_stall_steps": self.scheduler.prefill_stall_steps,
            "chunks_per_prompt": (self._chunk_steps_total
                                  / max(1, self._finished_served)),
            "finished": self._finished_count,
            "finished_served": self._finished_served,
            "num_preemptions": self.scheduler.num_preemptions,
            "num_pauses": self.scheduler.num_pauses,
            "prefill_tokens": self._prefill_tokens,
            "compiles": dict(self.model.trace_counts),
            "captures": dict(self._graphs.captures),
            "scheduler": self.scheduler.stats(),
            "pool": self.pool.stats(),
        }
        out["resilience"] = {
            "queue_depth": len(self.scheduler.waiting),
            "queue_limit": self.scheduler.queue_limit,
            "queue_pages": self.scheduler.queue_pages,
            "sheds": self.scheduler.num_rejected,
            "timeouts": self.scheduler.num_timeouts,
            "cancels": self.scheduler.num_cancels,
            "quarantines": self.scheduler.num_quarantines,
            "drafter_errors": self._drafter_errors,
            "spec_auto_disables": self._spec_auto_disables,
            "spec_disabled": self._spec_disabled,
            "watchdog_trips": self._watchdog_trips,
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.obs.enabled:
            # goodput (tokens emitted inside deadline_s) and the headline
            # p99s, drain-scoped like the registry metrics they read
            good = self.obs.c_goodput_tokens.value
            toks = self.obs.c_tokens_out.value
            lat = self.obs.latency_summary()
            out["slo"] = {
                "goodput_tokens": good,
                "tokens_out": toks,
                "goodput_ratio": good / max(1, toks),
                "ttft_p99_s": lat["ttft_s"]["p99"],
                "itl_p99_s": lat["itl_s"]["p99"],
                "e2e_p99_s": lat["e2e_s"]["p99"],
            }
        if self.flat:
            fs = max(1, self._flat_steps)
            out["flat"] = {
                "token_budget": self.token_budget,
                "steps": self._flat_steps,
                "mean_tokens": self._flat_tokens / fs,
                "mean_width": self._flat_width / fs,
                "fill": self._flat_tokens / max(1, self._flat_width),
            }
        if self.spec_tokens is not None:
            out["speculative"] = {
                "spec_tokens": self.spec_tokens,
                "drafted": self._drafted,
                "accepted": self._accepted,
                "acceptance_rate": self._accepted / max(1, self._drafted),
                "accepted_per_step": self._accepted / steps,
                "decode_tokens_per_row_step": (self._decode_tokens
                                               / max(1, self._decode_rows)),
                "draft_time_ms": 1e3 * self._draft_time,
                "draft_overhead": (self._draft_time / self._step_time
                                   if self._step_time > 0 else 0.0),
                "spec_trims": self._spec_trims,
                "spec_grow_fallbacks": self.scheduler.spec_grow_fallbacks,
                "rollback_pages": self._rollback_pages,
                "drafter": self.drafter.stats(),
            }
        return out

    def telemetry(self, *, reset: bool = False, report=None) -> dict:
        """The unified observability view:

        - ``components``: :meth:`stats`, lifetime-cumulative, never reset;
        - ``metrics``: the streaming registry snapshot (counters, gauges,
          histograms with p50/p95/p99; its ``_scope`` map labels each
          metric ``drain`` or ``lifetime``);
        - ``latency``: TTFT, ITL, queue wait and e2e percentiles, empty
          when telemetry is off;
        - ``attribution``: the drain's roll-up
          (:mod:`repro_torch.obs.attrib`): wall-time components,
          per-family predicted against measured, MFU/MBU, padding waste,
          goodput;
        - ``alerts``: the monitors' findings as dicts, newest last.

        ``report="/path/base"`` also writes ``base.html`` and ``base.prom``
        (:func:`repro_torch.obs.export.write_report`) and returns their
        paths under ``"report"``.  ``reset=True`` then zeroes the
        drain-scoped metrics and attribution aggregates only; nothing
        resets implicitly."""
        obs = self.obs
        out = {
            "enabled": obs.enabled,
            "components": self.stats() if self.continuous else {},
            "metrics": (obs.registry.snapshot()
                        if obs.registry is not None else {}),
            "latency": obs.latency_summary() if obs.enabled else {},
            "attribution": obs.attribution_summary(),
            "alerts": [a.to_dict() for a in obs.alerts],
        }
        if report is not None:
            if not obs.enabled:
                raise ValueError("telemetry(report=...) needs an engine built "
                                 "with telemetry=True")
            from repro_torch.obs.export import write_report
            out["report"] = write_report(obs, report)
        if reset:
            obs.reset_drain()
        return out

    def step(self, *, now: Optional[float] = None, greedy: bool = True,
             seed: int = 0) -> List[Request]:
        """One engine step of this engine's family.  Returns the requests
        finished during it: those shed or cancelled since the last step
        first, then (with a clock ``now``) those past their deadline, then
        the step's own.  ``now`` also gates arrivals; ``seed`` keys the
        sampled picks of requests without their own."""
        t0 = time.perf_counter()
        self.obs.step_begin()
        finished = list(self._finished_oob)
        self._finished_oob.clear()
        if now is not None:
            finished.extend(self.scheduler.expire(now))
        if self.flat:
            finished.extend(self._step_flat(now, greedy, seed))
        elif self.chunked:
            finished.extend(self._step_chunked(now, greedy, seed))
        else:
            finished.extend(self._step_monolithic(now, greedy, seed))
        if self.scheduler.running or finished:
            self._steps += 1
            self._step_time += time.perf_counter() - t0
            self._no_progress_steps = 0
        else:
            self._watchdog(now)
        for req in finished:
            self._finished_count += 1
            if req.admit_seq >= 0:
                self._finished_served += 1
            self._chunk_steps_total += req.chunk_steps
            self._retired_rids.add(req.rid)
            if self.drafter is not None:
                self.drafter.forget(req.rid)
        self.obs.step_end(self.scheduler, self.pool, finished, now=now)
        return finished

    def _watchdog(self, now) -> None:
        """``watchdog_steps`` consecutive steps that admit, advance and
        finish nothing while arrived work waits mean the drain is stuck."""
        stuck = [r for r in self.scheduler.waiting
                 if now is None or r.arrival <= now]
        if not stuck:
            self._no_progress_steps = 0
            return
        self._no_progress_steps += 1
        if self._no_progress_steps >= self.watchdog_steps:
            self._watchdog_trips += 1
            self._no_progress_steps = 0
            raise StallError(
                f"no request advanced for {self.watchdog_steps} consecutive "
                f"steps; waiting: " +
                ", ".join(f"rid {r.rid} ({r.status}, cursor "
                          f"{r.prefill_cursor}/{r.prompt_len})" for r in stuck) +
                f"; pool: {self.pool.num_available} of "
                f"{self.pool.usable_pages} pages available")

    # ------------------------------------------------------------------
    # what every family does with a row's logits
    # ------------------------------------------------------------------
    def _prefill_chunk(self, req: Request, n: int, row: np.ndarray,
                       greedy: bool, seed: int,
                       finished: List[Request]) -> None:
        """Advance a prefilling row by its ``n``-token chunk (the nan guard
        first, so a poisoned chunk never reaches the prefix cache); at the
        last one its logits give the first token."""
        if self.nan_guard and not np.isfinite(row).all():
            self._quarantine(req, finished)
            return
        req.prefill_cursor += n
        req.len = req.prefill_cursor
        req.chunk_steps += 1
        self._prefill_tokens += n
        self.obs.request_prefill_chunk(req, n)
        if self.prefix_cache is not None:
            # newly completed full pages are shared from now on
            self.prefix_cache.insert(req.prompt, req.pages.pages,
                                     req.prefill_cursor)
        if req.prefill_cursor < req.prompt_len:
            return                        # more chunks to come
        req.status = "running"
        self.obs.request_prefill_done(req)
        req.out_tokens.append(self._pick(row, req, greedy, seed))
        if req.done():
            self.scheduler.finish(req)
            finished.append(req)

    def _quarantine(self, req: Request, finished: List[Request]) -> None:
        """Retire a poisoned row alone (non-finite logits, a failed
        rollback): its pages go back to the free list, none into the
        prefix cache.  Survivors are untouched: rows are independent."""
        self.scheduler.cancel(req.rid, "error", cache_pages=False)
        finished.append(req)

    def _stall(self, kind: str, running) -> StallError:
        self._watchdog_trips += 1
        return StallError(
            f"{kind} step scheduled zero tokens with live slots: " +
            ", ".join(f"rid {r.rid} ({r.status}, cursor {r.prefill_cursor}/"
                      f"{r.prompt_len}, len {r.len})" for r in running.values()))

    # ------------------------------------------------------------------
    # speculative decode (without spec_tokens every row proposes nothing
    # and the verify degenerates to the one-pick decode)
    # ------------------------------------------------------------------
    def _propose_drafts(self) -> dict:
        """``{slot: drafts}`` for the decoding rows, each at most
        ``max_new - generated - 1`` long (the last token is never fed
        back).  A drafter that raises costs this step's drafts only (the
        rows decode one token, with the same picks); after
        ``_drafter_fail_limit`` failures in a row speculation is off until
        the drain ends."""
        if self.drafter is None or self._spec_disabled:
            return {}
        t0 = time.perf_counter()
        jobs, slot_of = [], {}
        for slot, req in self.scheduler.running.items():
            if req.status != "running":
                continue
            k = min(self.spec_tokens, req.max_new - len(req.out_tokens) - 1)
            if k <= 0:
                continue
            jobs.append((req, k))
            slot_of[req.rid] = slot
        drafts = {}
        if jobs:
            try:
                proposals = self.drafter.propose_all(jobs)
            except Exception:
                self._drafter_errors += 1
                self._drafter_fail_streak += 1
                self.obs.drafter_error()
                if self._drafter_fail_streak >= self._drafter_fail_limit:
                    self._spec_disabled = True
                    self._spec_auto_disables += 1
                proposals = {}
            else:
                self._drafter_fail_streak = 0
            for req, k in jobs:
                d = [int(t) for t in proposals.get(req.rid, [])][:k]
                if d:
                    drafts[slot_of[req.rid]] = d
        self._draft_time += time.perf_counter() - t0
        self.obs.draft_span(t0)
        return drafts

    def _draft_and_grow(self) -> dict:
        """Propose drafts, then grow every decoding row with its ``1 +
        len(drafts)`` ask (shed rather than displace anyone)."""
        drafts = self._propose_drafts()
        self.scheduler.grow(want={s: 1 + len(d) for s, d in drafts.items()}
                            if drafts else None)
        return drafts

    def _grant_drafts(self, running, drafts) -> dict:
        """Each decoding row's verify width: the fed-back token plus the
        drafts its pages cover after growth (trims ``drafts`` in place).
        Returns ``{slot: n}``, 0 for a prefilling row."""
        neff = {}
        for slot, req in running.items():
            if req.status != "running":
                neff[slot] = 0
                continue
            n = 1
            d = drafts.get(slot)
            if d:
                n = max(1, min(1 + len(d), req.pages.capacity - req.len))
                if len(d) > n - 1:
                    self._spec_trims += 1
                    if n == 1:
                        del drafts[slot]
                    else:
                        drafts[slot] = d[:n - 1]
            neff[slot] = n
        return neff

    def _fill_decode_row(self, slot: int, req: Request, n: int, drafts: dict,
                         token, lens, counts, bt, idx) -> None:
        """One decode row of a paged step: the fed-back token and its
        granted drafts at positions ``req.len ..``; ``idx`` (a step with a
        drafted row) reads the logits after each fed position."""
        token[slot, 0] = req.out_tokens[-1]
        if n > 1:
            token[slot, 1:n] = drafts[slot]
        lens[slot] = req.len
        counts[slot] = n
        bt[slot] = req.pages.block_row(bt.shape[1])
        if idx is not None:
            idx[slot] = np.minimum(np.arange(idx.shape[1]), n - 1)

    def _verify_decode_row(self, req: Request, drafts: List[int],
                           rows: np.ndarray, n: int, greedy: bool, seed: int,
                           finished: List[Request]) -> None:
        """A decoding row's picks after its verify (the nan guard first):
        accept the draft prefix the engine's own picks reproduce, advance
        the cache length by the committed tokens, truncate the block table
        past them (a rollback whose copy-on-write fails quarantines the
        row), and retire the request when it is done."""
        if self.nan_guard and not np.isfinite(rows).all():
            self._quarantine(req, finished)
            return
        appended, accepted = accept_tokens(
            req, drafts, rows, n,
            lambda row, rq: self._pick(row, rq, greedy, seed))
        req.len += appended
        self._decode_rows += 1
        self._decode_tokens += appended
        if n > 1:
            self._drafted += n - 1
            self._accepted += accepted
            try:
                freed = req.pages.truncate(req.len)
            except PoolError:
                self._quarantine(req, finished)
                return
            self._rollback_pages += freed
            if freed:
                self.obs.spec_rollback(req, freed)
            if len(req.pages.pages) != self.pool.pages_for(req.len):
                raise PoolError(f"rollback left {len(req.pages.pages)} pages "
                                f"for len={req.len} of rid {req.rid}")
        if req.done():
            self.scheduler.finish(req)
            finished.append(req)

    # ------------------------------------------------------------------
    # the monolithic step
    # ------------------------------------------------------------------
    def _step_monolithic(self, now, greedy: bool, seed: int) -> List[Request]:
        """Admit one request at a time and prefill it alone (each prefill
        lands in the prefix cache before the next lookup), then decode
        every running row in one ``[slots, 1]`` step, or ``[slots, k+1]``
        when a row carries drafts; a preempted row drops out of
        ``running`` and its slot is inert (zero block table, no new
        tokens: its writes go to the trash page)."""
        finished: List[Request] = []
        while True:
            admitted = self.scheduler.admit(now, limit=1)
            if not admitted:
                break
            req = admitted[0]
            if not self._prefill_request(req, greedy, seed):
                finished.append(req)             # quarantined at prefill
                continue
            if req.done():
                self.scheduler.finish(req)
                finished.append(req)
        drafts = self._draft_and_grow()
        running = self.scheduler.running
        if running:
            neff = self._grant_drafts(running, drafts)
            b, mp = self.slots, self.max_pages
            spec = max(neff.values()) > 1
            s = self.spec_tokens + 1 if spec else 1
            token = np.zeros((b, s), np.int32)
            lens = np.zeros((b,), np.int32)
            counts = np.zeros((b,), np.int32)
            bt = np.zeros((b, mp), np.int32)
            idx = np.zeros((b, s), np.int32) if spec else None
            for slot, req in running.items():
                self._fill_decode_row(slot, req, neff[slot], drafts,
                                      token, lens, counts, bt, idx)
            self._active_rows += len(running)
            td = self.obs.clock()
            rows = self._run_paged(token, bt, lens, counts, idx)
            self.obs.device_span(td)
            self.obs.step_family(
                f"verify[{b},{s}]" if spec else f"decode[{b},1]",
                int(counts.sum()), b * s)
            for slot, req in list(running.items()):
                self._verify_decode_row(req, drafts.get(slot, []), rows[slot],
                                        neff[slot], greedy, seed, finished)
        return finished

    def _prefill_view(self) -> dict:
        """The cache tree of a prefill: the shared pools and the engine's
        single-slot state, zeroed in place."""
        zero_slot_states(self._prefill_states)
        return prefill_view(self.caches, self._prefill_states)

    def _prefill_request(self, req: Request, greedy: bool, seed: int) -> bool:
        """Prefill one admitted request from its cursor (past a prefix-cache
        hit) at its geometric bucket (padding positions write the trash
        page), or at its exact length for a recurrent model, from zero
        state.  Returns False when the row was quarantined for non-finite
        logits, before its pages could reach the cache or its state its
        slot."""
        l = req.prompt_len
        start = req.prefill_cursor
        n = l - start
        bucket = self._prefill_bucket(n)
        token = np.zeros((1, bucket), np.int32)
        token[0, :n] = req.prompt[start:]
        bt = req.pages.block_row(self.max_pages)[None]
        view = self._prefill_view()
        td = self.obs.clock()
        rows = self._run_paged(token, bt, np.full((1,), start, np.int32),
                               np.full((1,), n, np.int32), caches=view)
        self.obs.device_span(td)
        self.obs.step_family(f"prefill[1,{bucket}]", n, bucket)
        row = rows[0, 0]
        if self.nan_guard and not np.isfinite(row).all():
            self.scheduler.cancel(req.rid, "error", cache_pages=False)
            return False
        self.caches = merge_slot(self.caches, view, req.slot)
        req.len = l
        req.prefill_cursor = l
        req.chunk_steps += 1        # a monolithic prefill is one big chunk
        self._prefill_tokens += n
        self.obs.request_prefill_chunk(req, n)
        self.obs.request_prefill_done(req)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, req.pages.pages, l)
        req.out_tokens.append(self._pick(row, req, greedy, seed))
        return True

    def _prefill_bucket(self, l: int) -> int:
        """The geometric prefill bucket of an ``l``-token prompt: ``m_r``
        doubled until it holds ``l``, at most ``max_len`` rounded up to
        ``m_r``.  Preemption folds generated tokens into prompts, so
        lengths are arbitrary; the buckets keep the step shapes (and the
        graphs) at ``log2(max_len / m_r) + 1``.  At ``m_r = 1`` (the
        unpacked policy) a prompt prefills at its exact length, as in the
        JAX package, which buckets only where ``m_r > 1``."""
        if self._bucket == 1:
            return l
        b = self._bucket
        while b < l:
            b *= 2
        return min(b, round_up(self.scheduler.max_len, self._bucket))

    # ------------------------------------------------------------------
    # the dense chunked step
    # ------------------------------------------------------------------
    def _step_chunked(self, now, greedy: bool, seed: int) -> List[Request]:
        """The dense ``[slots, s]`` step: decoding rows carry their fed-back
        token (and drafts) from position ``len``, prefilling rows the next
        chunk of their prompt from ``prefill_cursor``; stalled and free
        rows are inert.  A step with a drafted row reads ``k + 1`` logits
        per row."""
        sched = self.scheduler
        finished: List[Request] = []
        sched.admit(now)
        drafts = self._draft_and_grow()
        running = sched.running
        if not running:
            return finished
        neff = self._grant_drafts(running, drafts)
        ndecode = sum(neff.values())
        plan = sched.plan_chunks(self.token_budget - ndecode)
        use_chunk = any(n > 0 for n in plan.values())
        b, mp = self.slots, self.max_pages
        widest = max(max(plan.values(), default=0),
                     max(neff.values(), default=0))
        s = self._chunk_shape(widest) if (use_chunk or widest > 1) else 1
        spec = any(n > 1 for n in neff.values())
        k1 = self.spec_tokens + 1 if spec else 1
        token = np.zeros((b, s), np.int32)
        lens = np.zeros((b,), np.int32)
        counts = np.zeros((b,), np.int32)
        bt = np.zeros((b, mp), np.int32)
        idx = np.zeros((b, k1), np.int32) if spec else None
        for slot, req in running.items():
            if req.status == "running":
                self._fill_decode_row(slot, req, neff[slot], drafts,
                                      token, lens, counts, bt, idx)
            else:
                n = plan.get(slot, 0)
                if n == 0:
                    continue              # stalled this step: inert row
                cur = req.prefill_cursor
                token[slot, :n] = req.prompt[cur:cur + n]
                lens[slot] = cur
                counts[slot] = n
                bt[slot] = req.pages.block_row(mp)
                if spec:
                    idx[slot] = n - 1     # its last chunk token, read at j=0
        if int(counts.sum()) == 0:
            raise self._stall("fused", running)
        self._active_rows += int((counts > 0).sum())
        self._mixed_steps += int(use_chunk)
        td = self.obs.clock()
        rows = self._run_paged(token, bt, lens, counts, idx)
        self.obs.device_span(td)
        self.obs.step_family(f"chunk[{b},{s}]" + ("/verify" if spec else ""),
                             int(counts.sum()), b * s)
        for slot, req in list(running.items()):
            if req.status == "running":
                self._verify_decode_row(req, drafts.get(slot, []), rows[slot],
                                        neff[slot], greedy, seed, finished)
            elif plan.get(slot, 0) > 0:
                self._prefill_chunk(req, plan[slot], rows[slot, 0], greedy,
                                    seed, finished)
        return finished

    def _chunk_shapes(self) -> List[int]:
        """The dense step's ladder, descending: ``chunk_tokens`` halved
        down to ``m_r`` (the ``[slots, 1]`` decode shape comes beside it)."""
        shapes = [self.chunk_tokens]
        while (shapes[-1] % 2 == 0 and shapes[-1] // 2 >= self._bucket
               and (shapes[-1] // 2) % self._bucket == 0):
            shapes.append(shapes[-1] // 2)
        return shapes

    def _chunk_shape(self, n: int) -> int:
        """Smallest ladder shape holding an ``n``-token chunk."""
        s = self.chunk_tokens
        for cand in self._chunk_shapes():
            if cand >= n:
                s = cand
        return s

    def _run_paged(self, token, bt, lens, counts, idx=None,
                   caches=None) -> np.ndarray:
        """One paged step over ``self.caches`` (or a prefill view of it);
        returns float32 logits [B, K, V] on the host (K = 1 without
        ``idx``)."""
        logits, _ = self._paged_step(
            self.params, self.caches if caches is None else caches,
            torch.from_numpy(token), torch.from_numpy(bt),
            torch.from_numpy(lens), torch.from_numpy(counts),
            None if idx is None else torch.from_numpy(idx),
            graphs=self._graphs, **self._shard_kw)
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------------
    # the flat step
    # ------------------------------------------------------------------
    def _step_flat(self, now, greedy: bool, seed: int) -> List[Request]:
        """The flat token-level step: scheduling is the chunked policy's
        (admission, growth, chunk planning, stalls, displacement); only
        the layout of the fed tokens is flat.  A decoding row costs its
        ``1 + drafts`` positions, and reads the logits after each."""
        sched = self.scheduler
        finished: List[Request] = []
        sched.admit(now)
        drafts = self._draft_and_grow()
        running = sched.running
        if not running:
            return finished
        neff = self._grant_drafts(running, drafts)
        decode_counts = {s: n for s, n in neff.items() if n > 0}
        segs = sched.plan_segments(decode_counts, self.token_budget)
        total = sum(n for _, _, n in segs)
        if total == 0:
            raise self._stall("flat", running)
        w = self._flat_shape(total)
        spec = any(n > 1 for n in decode_counts.values())
        k1 = self.spec_tokens + 1 if spec else 1
        token = np.zeros((1, w), np.int32)
        row_ids = np.full((w,), -1, np.int32)
        q_pos = np.zeros((w,), np.int32)
        bt = np.zeros((self.slots, self.max_pages), np.int32)
        idx = np.zeros((self.slots * k1,), np.int32)
        pos = 0
        segrefs = []
        for slot, kind, n in segs:
            req = running[slot]
            if kind == "decode":
                token[0, pos] = req.out_tokens[-1]
                if n > 1:
                    token[0, pos + 1:pos + n] = drafts[slot]
                q_pos[pos:pos + n] = req.len + np.arange(n)
                # the logits after every fed position, clamped to the row
                idx[slot * k1:(slot + 1) * k1] = \
                    pos + np.minimum(np.arange(k1), n - 1)
            else:
                cur = req.prefill_cursor
                token[0, pos:pos + n] = req.prompt[cur:cur + n]
                q_pos[pos:pos + n] = cur + np.arange(n)
                idx[slot * k1:(slot + 1) * k1] = pos + n - 1
            row_ids[pos:pos + n] = slot
            bt[slot] = req.pages.block_row(self.max_pages)
            segrefs.append((slot, kind, n, req))
            pos += n
        self._active_rows += len(segrefs)
        self._mixed_steps += int(any(kind == "prefill" for _, kind, _ in segs))
        self._flat_steps += 1
        self._flat_tokens += total
        self._flat_width += w
        # the ragged plan is host work: built before the device span opens
        plan = self._ragged_plan(row_ids, q_pos)
        td = self.obs.clock()
        rows = self._run_flat(token, bt, row_ids, q_pos, idx, plan)
        self.obs.device_span(td)
        self.obs.step_family(f"flat[1,{w}]/k{k1}", total, w)
        rows = rows.reshape(self.slots, k1, -1)
        for slot, kind, n, req in segrefs:
            if kind == "decode":
                self._verify_decode_row(req, drafts.get(slot, []), rows[slot],
                                        n, greedy, seed, finished)
            else:
                self._prefill_chunk(req, n, rows[slot, 0], greedy, seed,
                                    finished)
        return finished

    def _ragged_plan(self, row_ids, q_pos):
        """The ragged-attention plan of a flat step, from the host's
        row_ids and q_pos at the width's fixed size (the graph of each
        width replays every step of it), so no layer reads an index back
        from the card."""
        cfg = self.model.cfg
        return plan_ragged(row_ids, q_pos, self.pool.page_tokens, self.max_pages,
                           cfg.n_kv_heads, self.model.ctx.hw.sm_count,
                           group=cfg.n_heads // cfg.n_kv_heads, slots=self.slots)

    def _run_flat(self, token, bt, row_ids, q_pos, idx, plan=None) -> np.ndarray:
        """One flat step on the device; returns float32 logits [K, V] at
        the flat positions ``idx`` on the host (numpy has no bfloat16).
        ``plan`` is the step's ragged-attention plan (:meth:`_ragged_plan`,
        built here when the caller has none)."""
        if plan is None:
            plan = self._ragged_plan(row_ids, q_pos)
        logits, _ = self._flat_step(
            self.params, self.caches, torch.from_numpy(token),
            torch.from_numpy(bt), torch.from_numpy(row_ids),
            torch.from_numpy(q_pos), torch.from_numpy(idx), plan=plan,
            graphs=self._graphs, **self._shard_kw)
        return logits[0].float().cpu().numpy()

    def _flat_shapes(self) -> List[int]:
        """The flat width ladder, descending: the budget's m_r-aligned cap
        (at least ``slots * (spec_tokens + 1)``: decode tokens are never
        budget-capped) plus every power-of-two multiple of m_r below it."""
        cap = round_up(max(self.token_budget,
                           self.slots * ((self.spec_tokens or 0) + 1)),
                       self._bucket)
        shapes = {cap}
        v = self._bucket
        while v < cap:
            shapes.add(v)
            v *= 2
        return sorted(shapes, reverse=True)

    def _flat_shape(self, n: int) -> int:
        """Smallest ladder width holding ``n`` flat tokens."""
        shapes = self._flat_shapes()
        s = shapes[0]
        for cand in shapes:
            if cand >= n:
                s = cand
        return s

    def _pick(self, logits_row: np.ndarray, req: Request, greedy: bool,
              seed: int) -> int:
        """The next token from a float32 logits row: ``argmax``, or in a
        sampled drain the draw keyed by the request's (or the step's)
        seed, its id and its position."""
        if greedy or req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        s = seed if req.seed is None else req.seed
        return sampling.sample(logits_row, req.temperature,
                               sampling.pick_key(s, req.rid,
                                                 len(req.out_tokens)))

    def drain(self, *, greedy: bool = True, seed: int = 0,
              now: Optional[float] = None) -> List[Request]:
        """Run steps until every queued request has finished, the shed and
        cancelled ones included.  The drafter's auto-disable lasts one
        drain: the next drain has the drafter again."""
        finished = []
        while self.scheduler.has_work or self._finished_oob:
            finished.extend(self.step(now=now, greedy=greedy, seed=seed))
        self._spec_disabled = False
        self._drafter_fail_streak = 0
        return finished

    def warmup(self) -> None:
        """Make the program of every step shape this engine can hit (on
        the card, capture its CUDA graph): flat, every ladder width with a
        logits gather of ``slots`` rows, and of ``slots * (k + 1)`` with
        speculation; dense chunked, every chunk shape and ``[slots, 1]``,
        and with speculation every chunk shape reading ``[slots, k + 1]``
        logits; monolithic, every prefill bucket at ``[1, b]``, ``[slots,
        1]`` and with speculation the ``[slots, k + 1]`` verify.  Where
        prompts prefill at exact lengths (a recurrent model, or m_r = 1)
        there is no bucket to make: each length makes its program at its
        first prefill.  Then the
        drafter's own programs, and with a prefix cache the device page
        copy (the trash page onto itself).  Every call carries no valid
        token, so all writes go to the trash page and live state is
        untouched.  With telemetry on it then builds the step cost model
        (:func:`repro_torch.obs.attrib.build_cost_model`) — here and only
        here, in closed form, calling no step."""
        self._need_continuous("warmup")
        if self.scheduler.has_work or self._finished_oob:
            raise RuntimeError("warmup() needs an idle engine")
        if self.prefix_cache is not None:
            self.pool.page_copier(0, 0)
        b, mp = self.slots, self.max_pages
        zb = np.zeros((b,), np.int32)
        btb = np.zeros((b, mp), np.int32)
        k1s = [1] + ([self.spec_tokens + 1] if self.spec_tokens is not None
                     else [])
        if self.flat:
            for w in self._flat_shapes():
                for k1 in k1s:
                    self._run_flat(np.zeros((1, w), np.int32), btb,
                                   np.full((w,), -1, np.int32),
                                   np.zeros((w,), np.int32),
                                   np.zeros((b * k1,), np.int32))
        elif self.chunked:
            for s in self._chunk_shapes() + [1]:
                self._run_paged(np.zeros((b, s), np.int32), btb, zb, zb)
            if self.spec_tokens is not None:
                # a drafted step rides the chunk ladder, never [slots, 1]
                for s in self._chunk_shapes():
                    self._run_paged(np.zeros((b, s), np.int32), btb, zb, zb,
                                    np.zeros((b, k1s[-1]), np.int32))
        else:
            z1 = np.zeros((1,), np.int32)
            # at m_r = 1 prefills run at exact lengths: nothing to make here
            bucket, seen = self._bucket, set() if self._bucket > 1 else {1}
            while (bucket := self._prefill_bucket(bucket)) not in seen:
                seen.add(bucket)
                view = self._prefill_view()
                self._run_paged(np.zeros((1, bucket), np.int32),
                                np.zeros((1, mp), np.int32), z1, z1,
                                caches=view)
                self.caches = merge_slot(self.caches, view, 0)
                bucket += 1
            self._run_paged(np.zeros((b, 1), np.int32), btb, zb, zb)
            if self.spec_tokens is not None:
                k1 = k1s[-1]
                self._run_paged(np.zeros((b, k1), np.int32), btb, zb, zb,
                                np.zeros((b, k1), np.int32))
        if self.drafter is not None:
            self.drafter.warmup()
        if self.obs.enabled:
            # the warmup-only cost model: closed-form counts of the shapes
            # just made, no model call (repro_torch.obs.attrib)
            from repro_torch.obs.attrib import build_cost_model
            self.cost_model = build_cost_model(self)
            self.obs.attach_cost_model(self.cost_model)

    def generate(self, batch: dict, max_new: int, *, greedy: bool = True,
                 seed: int = 0, eos_id: Optional[int] = None,
                 return_reasons: bool = False,
                 deadline_s: Optional[float] = None):
        """batch: {"tokens": [B, L]} (encdec: and "frames" [B, S_enc, d];
        vlm: and "patches" [B, vision_tokens, d]).
        Returns [B, max_new] generated tokens, and the finish reasons
        ("eos", "length", "timeout", "rejected", "error") with
        ``return_reasons=True``.  Rows that finish early, by eos, timeout,
        shed or quarantine, are padded with ``eos_id`` (or 0).
        ``deadline_s`` bounds each row's lifetime on a real clock.  A
        static family runs :meth:`generate_static` and truncates each row
        at its eos afterwards, by the continuous path's rule
        (:func:`~repro_torch.serving.scheduler.finish_reason_for`)."""
        if deadline_s is not None and self.tp is not None:
            raise ValueError("generate(deadline_s=) across ranks: each rank "
                             "would read its own clock and take its own "
                             "timeouts; drive step(now=) with one clock")
        if not self.continuous:
            if deadline_s is not None:
                raise ValueError("deadline_s needs the continuous engine (the "
                                 "static path decodes in lock step, with no "
                                 "per-request lifecycle)")
            out = self.generate_static(batch, max_new, greedy=greedy, seed=seed)
            reasons = ["length"] * out.shape[0]
            if eos_id is not None:
                for i in range(out.shape[0]):
                    kept, reasons[i] = finish_reason_for(out[i], max_new, eos_id)
                    if reasons[i] == "eos":
                        out[i, kept - 1:] = eos_id
            return (out, reasons) if return_reasons else out
        if self.scheduler.has_work or self._finished_oob:
            raise RuntimeError("generate() needs an idle engine")
        prompts = np.asarray(batch["tokens"])
        rids = [self.add_request(prompts[i], max_new, eos_id=eos_id,
                                 deadline_s=deadline_s)
                for i in range(prompts.shape[0])]
        if deadline_s is None:
            done = self.drain(greedy=greedy, seed=seed)
        else:
            done, t0 = [], time.perf_counter()
            while self.scheduler.has_work or self._finished_oob:
                done.extend(self.step(now=time.perf_counter() - t0,
                                      greedy=greedy, seed=seed))
            self._spec_disabled = False
            self._drafter_fail_streak = 0
        by_rid = {r.rid: r for r in done}
        pad = 0 if eos_id is None else eos_id
        rows, reasons = [], []
        for rid in rids:
            toks = by_rid[rid].out_tokens[:max_new]
            rows.append(toks + [pad] * (max_new - len(toks)))
            reasons.append(by_rid[rid].finish_reason)
        out = np.asarray(rows, np.int32)
        return (out, reasons) if return_reasons else out

    # ------------------------------------------------------------------
    # the static batch loop
    # ------------------------------------------------------------------
    def _static_caches(self, batch: dict) -> dict:
        """The dense caches of a static batch, zeroed and (encdec) holding
        the cross K/V of this batch's frames: one cache tree per batch
        shape, kept in ``_static_bufs`` (the graphs bind its addresses)."""
        m = self.model
        key = (np.shape(batch["tokens"])[0],)
        if m.cfg.family == "encdec":
            key += (np.shape(batch["frames"])[1],)
        caches = self._static_bufs.get(key)
        if caches is None:
            caches = self._static_bufs[key] = m.prefill_cache(self.params,
                                                              batch)
            return caches
        return m.prefill_cache(self.params, batch, into=caches)

    def generate_static(self, batch: dict, max_new: int, *,
                        greedy: bool = True, seed: int = 0) -> np.ndarray:
        """The static batch loop: every row shares one prompt length; the
        prompts ``batch["tokens"]`` [B, plen] are prefilled in one call of
        the ``"decode"`` step at position 0 (vlm: ``vision_tokens + plen``
        positions, whose embeddings, the ``vision_proj`` of
        ``batch["patches"]`` before the prompt's, stand in for zero
        tokens), then every row decodes in lock step to ``max_new`` tokens
        (no eos stop).  The first token is the
        argmax even when ``greedy=False``, as in the JAX package; sampled
        picks split one key per step (:func:`sampling.split`) and draw the
        whole batch from it (:func:`sampling.categorical`).  A greedy loop
        keeps its tokens on the device, so no step waits for the host.
        Across ranks each rank holds its window of the dense caches
        (``ReproModel.init_cache``) and runs every step eagerly; its logits
        are every rank's, so its picks are too (one key on every rank).
        Returns [B, max_new] int32."""
        prompts = torch.as_tensor(np.asarray(batch["tokens"], np.int32))
        plen = prompts.shape[1]
        caches = self._static_caches(batch)

        def step(tok, pos, embeds=None):
            # the position is filled on the device: no copy from the host
            pos = torch.full((), pos, dtype=torch.int32, device=self.device)
            logits, _ = self._decode_step(self.params, caches, tok, pos, embeds,
                                          graphs=self._graphs)
            return logits[:, -1]

        def argmax(row):
            return torch.argmax(row, dim=-1).to(torch.int32)[:, None]

        if self.model.cfg.family == "vlm":
            embeds = self.model._embeds(self.params, batch)
            plen = embeds.shape[1]
            tok = argmax(step(torch.zeros(embeds.shape[:2], dtype=torch.int32),
                              0, embeds))
        else:
            tok = argmax(step(prompts, 0))
        out = [tok]
        key = sampling.prng_key(seed)
        for i in range(max_new - 1):
            row = step(tok, plen + i)
            if greedy:
                tok = argmax(row)
            else:
                key, sub = sampling.split(key)
                tok = torch.from_numpy(sampling.categorical(
                    sub, row.float().cpu().numpy()).astype(np.int32)[:, None])
            out.append(tok)
        return torch.cat([t.to(self.device) for t in out], dim=1).cpu().numpy()
