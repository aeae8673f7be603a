"""Serving engine: continuous batching over a paged KV cache, through one
of the JAX package's three step families.

Each step admits waiting requests, grows every decoding row by one KV
position (displacing the youngest admission when the pool runs dry) and
runs one or more model calls; logits come back to the host, where the
greedy pick is ``np.argmax`` of a float32 copy.  The families:

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

All three schedule alike and give the same greedy tokens.  Every model
call goes through the model's compiled step (``ReproModel.compiled_step``):
on the card one CUDA graph per step shape, which :meth:`Engine.warmup`
captures for every shape the engine can hit, so a drain after it captures
nothing (``stats()["compiles"]`` stays put).

Weights are always prepacked.  A row whose logits are not finite is
retired alone as ``"error"`` (the nan guard), and a drain in which arrived
work waits for :data:`WATCHDOG_STEPS` steps without any progress raises
:class:`StallError` (the watchdog).  ``spec_tokens`` (speculative decode),
``prefix_cache=True``, sampled picks (``greedy=False``) and models that
are not pure attention raise instead of running something else.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.hardware import require_device
from repro_torch.core.layout import ceil_div, round_up
from repro_torch.core.linear import prepack_params
from repro_torch.kernels.ragged_attn.ops import plan_ragged
from repro_torch.models.model import ReproModel
from repro_torch.models.transformer import tree_map
from repro_torch.obs.telemetry import NULL as OBS_NULL
from repro_torch.serving.kv_cache import (PagedKVPool, fresh_slot_states,
                                          merge_slot, prefill_view)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "StallError", "WATCHDOG_STEPS"]

WATCHDOG_STEPS = 64


class StallError(RuntimeError):
    """The drain stopped making progress (the watchdog tripped, or a step
    scheduled zero tokens with live rows)."""


class Engine:
    def __init__(self, model: ReproModel, params, *, device="cuda",
                 max_slots: Optional[int] = None,
                 page_tokens: int = 16, num_pages: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 flat: Optional[bool] = None, eager: bool = False,
                 spec_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        self.device = require_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if spec_tokens is not None:
            raise NotImplementedError("speculative decode is not ported yet")
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        if any(t != "attn" for t in model.cfg.layer_types):
            raise NotImplementedError("the port serves pure-attention models "
                                      "only (hybrids prefill at exact length)")
        self.model = model
        self.obs = OBS_NULL
        params = tree_map(lambda t: t.to(self.device), params)
        self.params = prepack_params(params, model.ctx)

        layout = model.ctx.layout(model.compute_dtype)
        self._bucket = layout.m_r
        self.slots = max_slots or model.shape.global_batch
        max_len = model.shape.seq_len
        page_tokens = round_up(page_tokens, layout.m_r)
        if chunk_tokens is not None:
            if chunk_tokens < 1:
                raise ValueError(f"chunk_tokens={chunk_tokens}: a chunk must "
                                 f"carry at least one token")
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
        self.max_pages = ceil_div(max_len, self.pool.page_tokens)
        self.scheduler = Scheduler(self.slots, self.pool, max_len, eager=eager,
                                   chunk_tokens=self.chunk_tokens,
                                   chunk_align=layout.m_r, telemetry=self.obs)
        self._next_rid = 0
        self._no_progress_steps = 0
        self._steps = 0
        self._step_time = 0.0
        self._active_rows = 0        # rows carrying tokens, summed over steps
        self._mixed_steps = 0        # steps carrying at least one prefill chunk
        self._finished_count = 0
        self._finished_served = 0    # finished after an admission
        self._chunk_steps_total = 0  # prefill calls or chunks of the finished
        self._prefill_tokens = 0     # prompt tokens computed
        self._flat_steps = 0
        self._flat_tokens = 0
        self._flat_width = 0
        self.caches = model.init_paged_cache(num_pages, self.pool.page_tokens,
                                             self.slots)
        self._paged_step = model.compiled_step("paged")
        self._flat_step = model.compiled_step("flat") if self.flat else None

    # ------------------------------------------------------------------
    # continuous-batching API
    # ------------------------------------------------------------------
    def add_request(self, tokens, max_new: int, *, eos_id: Optional[int] = None,
                    arrival: float = 0.0) -> int:
        """Queue one request; returns its id.  Raises
        :class:`~repro_torch.serving.scheduler.AdmissionError` for a
        request that could never fit."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(tokens, np.int32).reshape(-1),
                      max_new=max_new, eos_id=eos_id, arrival=arrival)
        self.scheduler.add(req)
        return rid

    @property
    def num_preemptions(self) -> int:
        return self.scheduler.num_preemptions

    @property
    def num_pauses(self) -> int:
        return self.scheduler.num_pauses

    def stats(self) -> dict:
        """Cumulative counters under the JAX package's keys; ``compiles``
        is the model's program count per step kind (no growth after
        :meth:`warmup` is the no-compile contract)."""
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
            "pool": self.pool.stats(),
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
        return out

    def step(self, *, now: Optional[float] = None,
             greedy: bool = True) -> List[Request]:
        """One engine step of this engine's family.  Returns the requests
        finished during it (``now`` carries a clock for arrival gating)."""
        t0 = time.perf_counter()
        self.obs.step_begin()
        if self.flat:
            finished = self._step_flat(now, greedy)
        elif self.chunked:
            finished = self._step_chunked(now, greedy)
        else:
            finished = self._step_monolithic(now, greedy)
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
        self.obs.step_end(self.scheduler, self.pool, finished, now=now)
        return finished

    def _watchdog(self, now) -> None:
        """``WATCHDOG_STEPS`` consecutive steps that admit, advance and
        finish nothing while arrived work waits mean the drain is stuck."""
        stuck = [r for r in self.scheduler.waiting
                 if now is None or r.arrival <= now]
        if not stuck:
            self._no_progress_steps = 0
            return
        self._no_progress_steps += 1
        if self._no_progress_steps >= WATCHDOG_STEPS:
            self._no_progress_steps = 0
            raise StallError(
                f"no request advanced for {WATCHDOG_STEPS} consecutive "
                f"steps; waiting: " +
                ", ".join(f"rid {r.rid} ({r.status}, cursor "
                          f"{r.prefill_cursor}/{r.prompt_len})" for r in stuck) +
                f"; pool: {self.pool.num_available} of "
                f"{self.pool.usable_pages} pages available")

    # ------------------------------------------------------------------
    # what every family does with a row's logits
    # ------------------------------------------------------------------
    def _decode_row(self, req: Request, row: np.ndarray, greedy: bool,
                    finished: List[Request]) -> None:
        """A decoding row's pick (after the nan guard), then retire it if
        it is done."""
        if not np.isfinite(row).all():
            self.scheduler.quarantine(req)
            finished.append(req)
            return
        req.out_tokens.append(self._pick(row, greedy))
        req.len += 1
        if req.done():
            self.scheduler.finish(req)
            finished.append(req)

    def _prefill_chunk(self, req: Request, n: int, row: np.ndarray,
                       greedy: bool, finished: List[Request]) -> None:
        """Advance a prefilling row by its ``n``-token chunk; at the last
        one its logits give the first token."""
        if not np.isfinite(row).all():
            self.scheduler.quarantine(req)
            finished.append(req)
            return
        req.prefill_cursor += n
        req.len = req.prefill_cursor
        req.chunk_steps += 1
        self._prefill_tokens += n
        self.obs.request_prefill_chunk(req, n)
        if req.prefill_cursor < req.prompt_len:
            return                        # more chunks to come
        req.status = "running"
        self.obs.request_prefill_done(req)
        req.out_tokens.append(self._pick(row, greedy))
        if req.done():
            self.scheduler.finish(req)
            finished.append(req)

    def _stall(self, kind: str, running) -> StallError:
        return StallError(
            f"{kind} step scheduled zero tokens with live slots: " +
            ", ".join(f"rid {r.rid} ({r.status}, cursor {r.prefill_cursor}/"
                      f"{r.prompt_len}, len {r.len})" for r in running.values()))

    # ------------------------------------------------------------------
    # the monolithic step
    # ------------------------------------------------------------------
    def _step_monolithic(self, now, greedy: bool) -> List[Request]:
        """Admit one request at a time and prefill it alone, then decode
        every running row in one ``[slots, 1]`` step; a preempted row drops
        out of ``running`` and its slot is inert (zero block table, no new
        tokens: its writes go to the trash page)."""
        finished: List[Request] = []
        while True:
            admitted = self.scheduler.admit(now, limit=1)
            if not admitted:
                break
            req = admitted[0]
            if not self._prefill_request(req, greedy):
                finished.append(req)             # quarantined at prefill
                continue
            if req.done():
                self.scheduler.finish(req)
                finished.append(req)
        self.scheduler.grow()
        running = self.scheduler.running
        if running:
            b, mp = self.slots, self.max_pages
            token = np.zeros((b, 1), np.int32)
            lens = np.zeros((b,), np.int32)
            counts = np.zeros((b,), np.int32)
            bt = np.zeros((b, mp), np.int32)
            for slot, req in running.items():
                token[slot, 0] = req.out_tokens[-1]
                lens[slot] = req.len
                counts[slot] = 1
                bt[slot] = req.pages.block_row(mp)
            self._active_rows += len(running)
            rows = self._run_paged(token, bt, lens, counts)
            for slot, req in list(running.items()):
                self._decode_row(req, rows[slot, 0], greedy, finished)
        return finished

    def _prefill_request(self, req: Request, greedy: bool) -> bool:
        """Prefill one admitted request at its geometric bucket (padding
        positions write the trash page).  Returns False when the row was
        quarantined for non-finite logits."""
        l = req.prompt_len
        start = req.prefill_cursor
        n = l - start
        bucket = self._prefill_bucket(n)
        token = np.zeros((1, bucket), np.int32)
        token[0, :n] = req.prompt[start:]
        bt = req.pages.block_row(self.max_pages)[None]
        view = prefill_view(self.caches, fresh_slot_states(self.caches))
        rows = self._run_paged(token, bt, np.full((1,), start, np.int32),
                               np.full((1,), n, np.int32), caches=view)
        row = rows[0, 0]
        if not np.isfinite(row).all():
            self.scheduler.quarantine(req)
            return False
        self.caches = merge_slot(self.caches, view, req.slot)
        req.len = l
        req.prefill_cursor = l
        req.chunk_steps += 1        # a monolithic prefill is one big chunk
        self._prefill_tokens += n
        self.obs.request_prefill_chunk(req, n)
        self.obs.request_prefill_done(req)
        req.out_tokens.append(self._pick(row, greedy))
        return True

    def _prefill_bucket(self, l: int) -> int:
        """The geometric prefill bucket of an ``l``-token prompt: ``m_r``
        doubled until it holds ``l``, at most ``max_len`` rounded up to
        ``m_r``.  Preemption folds generated tokens into prompts, so
        lengths are arbitrary; the buckets keep the step shapes (and the
        graphs) at ``log2(max_len / m_r) + 1``."""
        b = self._bucket
        while b < l:
            b *= 2
        return min(b, round_up(self.scheduler.max_len, self._bucket))

    # ------------------------------------------------------------------
    # the dense chunked step
    # ------------------------------------------------------------------
    def _step_chunked(self, now, greedy: bool) -> List[Request]:
        """The dense ``[slots, s]`` step: decoding rows carry their fed-back
        token at position ``len``, prefilling rows the next chunk of their
        prompt from ``prefill_cursor``; stalled and free rows are inert."""
        sched = self.scheduler
        finished: List[Request] = []
        sched.admit(now)
        sched.grow()
        running = sched.running
        if not running:
            return finished
        ndecode = sum(1 for r in running.values() if r.status == "running")
        plan = sched.plan_chunks(self.token_budget - ndecode)
        use_chunk = any(n > 0 for n in plan.values())
        b, mp = self.slots, self.max_pages
        widest = max(max(plan.values(), default=0), min(1, ndecode))
        s = self._chunk_shape(widest) if (use_chunk or widest > 1) else 1
        token = np.zeros((b, s), np.int32)
        lens = np.zeros((b,), np.int32)
        counts = np.zeros((b,), np.int32)
        bt = np.zeros((b, mp), np.int32)
        for slot, req in running.items():
            if req.status == "running":
                token[slot, 0] = req.out_tokens[-1]
                lens[slot] = req.len
                counts[slot] = 1
            else:
                n = plan.get(slot, 0)
                if n == 0:
                    continue              # stalled this step: inert row
                cur = req.prefill_cursor
                token[slot, :n] = req.prompt[cur:cur + n]
                lens[slot] = cur
                counts[slot] = n
            bt[slot] = req.pages.block_row(mp)
        if int(counts.sum()) == 0:
            raise self._stall("fused", running)
        self._active_rows += int((counts > 0).sum())
        self._mixed_steps += int(use_chunk)
        rows = self._run_paged(token, bt, lens, counts)
        for slot, req in list(running.items()):
            if req.status == "running":
                self._decode_row(req, rows[slot, 0], greedy, finished)
            elif plan.get(slot, 0) > 0:
                self._prefill_chunk(req, plan[slot], rows[slot, 0], greedy,
                                    finished)
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

    def _run_paged(self, token, bt, lens, counts, caches=None) -> np.ndarray:
        """One paged step over ``self.caches`` (or a prefill view of it);
        returns float32 logits [B, 1, V] on the host."""
        logits, _ = self._paged_step(
            self.params, self.caches if caches is None else caches,
            torch.from_numpy(token), torch.from_numpy(bt),
            torch.from_numpy(lens), torch.from_numpy(counts), None)
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------------
    # the flat step
    # ------------------------------------------------------------------
    def _step_flat(self, now, greedy: bool) -> List[Request]:
        """The flat token-level step: scheduling is the chunked policy's
        (admission, growth, chunk planning, stalls, displacement); only
        the layout of the fed tokens is flat."""
        sched = self.scheduler
        finished: List[Request] = []
        sched.admit(now)
        sched.grow()
        running = sched.running
        if not running:
            return finished
        decode_counts = {s: 1 for s, r in running.items() if r.status == "running"}
        segs = sched.plan_segments(decode_counts, self.token_budget)
        total = sum(n for _, _, n in segs)
        if total == 0:
            raise self._stall("flat", running)
        w = self._flat_shape(total)
        token = np.zeros((1, w), np.int32)
        row_ids = np.full((w,), -1, np.int32)
        q_pos = np.zeros((w,), np.int32)
        bt = np.zeros((self.slots, self.max_pages), np.int32)
        idx = np.zeros((self.slots,), np.int32)
        pos = 0
        segrefs = []
        for slot, kind, n in segs:
            req = running[slot]
            if kind == "decode":
                token[0, pos] = req.out_tokens[-1]
                q_pos[pos] = req.len
            else:
                cur = req.prefill_cursor
                token[0, pos:pos + n] = req.prompt[cur:cur + n]
                q_pos[pos:pos + n] = cur + np.arange(n)
            row_ids[pos:pos + n] = slot
            bt[slot] = req.pages.block_row(self.max_pages)
            idx[slot] = pos + n - 1        # each row's logits at its last token
            segrefs.append((slot, kind, n, req))
            pos += n
        self._active_rows += len(segrefs)
        self._mixed_steps += int(any(kind == "prefill" for _, kind, _ in segs))
        self._flat_steps += 1
        self._flat_tokens += total
        self._flat_width += w
        rows = self._run_flat(token, bt, row_ids, q_pos, idx)
        for slot, kind, n, req in segrefs:
            if kind == "decode":
                self._decode_row(req, rows[slot], greedy, finished)
            else:
                self._prefill_chunk(req, n, rows[slot], greedy, finished)
        return finished

    def _run_flat(self, token, bt, row_ids, q_pos, idx) -> np.ndarray:
        """One flat step on the device; returns float32 logits [slots, V]
        on the host (numpy has no bfloat16).  The ragged-attention plan is
        built here from the host's row_ids and q_pos, at the width's fixed
        size (the graph of each width replays every step of it), so no
        layer reads an index back from the card."""
        cfg = self.model.cfg
        plan = plan_ragged(row_ids, q_pos, self.pool.page_tokens, self.max_pages,
                           cfg.n_kv_heads, self.model.ctx.hw.sm_count,
                           group=cfg.n_heads // cfg.n_kv_heads, slots=self.slots)
        logits, _ = self._flat_step(
            self.params, self.caches, torch.from_numpy(token),
            torch.from_numpy(bt), torch.from_numpy(row_ids),
            torch.from_numpy(q_pos), torch.from_numpy(idx), plan=plan)
        return logits[0].float().cpu().numpy()

    def _flat_shapes(self) -> List[int]:
        """The flat width ladder, descending: the budget's m_r-aligned cap
        plus every power-of-two multiple of m_r below it."""
        cap = round_up(max(self.token_budget, self.slots), self._bucket)
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

    def _pick(self, logits_row: np.ndarray, greedy: bool) -> int:
        if not greedy:
            raise NotImplementedError("sampled picks are not ported yet; "
                                      "the port decodes greedily")
        return int(np.argmax(logits_row))

    def drain(self, *, greedy: bool = True,
              now: Optional[float] = None) -> List[Request]:
        """Run steps until every queued request has finished."""
        finished = []
        while self.scheduler.has_work:
            finished.extend(self.step(now=now, greedy=greedy))
        return finished

    def warmup(self) -> None:
        """Make the program of every step shape this engine can hit (on
        the card, capture its CUDA graph): flat, every ladder width;
        dense chunked, every chunk shape and ``[slots, 1]``; monolithic,
        every prefill bucket at ``[1, b]`` and ``[slots, 1]``.  Every call
        carries no valid token, so all writes go to the trash page and
        live state is untouched."""
        if self.scheduler.has_work:
            raise RuntimeError("warmup() needs an idle engine")
        b, mp = self.slots, self.max_pages
        zb = np.zeros((b,), np.int32)
        btb = np.zeros((b, mp), np.int32)
        if self.flat:
            for w in self._flat_shapes():
                self._run_flat(np.zeros((1, w), np.int32), btb,
                               np.full((w,), -1, np.int32),
                               np.zeros((w,), np.int32), zb)
            return
        if self.chunked:
            for s in self._chunk_shapes() + [1]:
                self._run_paged(np.zeros((b, s), np.int32), btb, zb, zb)
            return
        z1 = np.zeros((1,), np.int32)
        bucket, seen = self._bucket, set()
        while (bucket := self._prefill_bucket(bucket)) not in seen:
            seen.add(bucket)
            view = prefill_view(self.caches, fresh_slot_states(self.caches))
            self._run_paged(np.zeros((1, bucket), np.int32),
                            np.zeros((1, mp), np.int32), z1, z1, caches=view)
            self.caches = merge_slot(self.caches, view, 0)
            bucket += 1
        self._run_paged(np.zeros((b, 1), np.int32), btb, zb, zb)

    def generate(self, batch: dict, max_new: int, *, greedy: bool = True,
                 eos_id: Optional[int] = None, return_reasons: bool = False):
        """batch: {"tokens": [B, L]}.  Returns [B, max_new] generated tokens
        (early-finished rows padded with ``eos_id``, or 0), and the finish
        reasons with ``return_reasons=True``."""
        if self.scheduler.has_work:
            raise RuntimeError("generate() needs an idle engine")
        prompts = np.asarray(batch["tokens"])
        rids = [self.add_request(prompts[i], max_new, eos_id=eos_id)
                for i in range(prompts.shape[0])]
        by_rid = {r.rid: r for r in self.drain(greedy=greedy)}
        pad = 0 if eos_id is None else eos_id
        rows, reasons = [], []
        for rid in rids:
            toks = by_rid[rid].out_tokens[:max_new]
            rows.append(toks + [pad] * (max_new - len(toks)))
            reasons.append(by_rid[rid].finish_reason)
        out = np.asarray(rows, np.int32)
        return (out, reasons) if return_reasons else out
