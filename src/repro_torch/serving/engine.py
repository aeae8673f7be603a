"""Serving engine: continuous batching over a paged KV cache, through the
flat token-level step.

Each step admits waiting requests, grows every decoding row by one KV
position (displacing the youngest admission when the pool runs dry), and
lays the scheduled rows out as contiguous *segments* of one ``[1, W]``
token stream: per-position ``row_ids`` (-1 = padding) and absolute
``q_pos``.  ``W`` comes from a geometric ladder of ``m_r``-aligned widths
over the token budget, so a decode row costs exactly its one real position
and the budget is token-exact.  One ``ReproModel.flat_decode_step`` runs
the whole stream; logits come back to the host, where the greedy pick is
``np.argmax`` of a float32 copy.

Weights are always prepacked.  A row whose logits are not finite is
retired alone as ``"error"`` (the nan guard), and a drain in which arrived
work waits for :data:`WATCHDOG_STEPS` steps without any progress raises
:class:`StallError` (the watchdog).

A transcription of the JAX package's engine for the flat path.  Each of
these raises instead of running something else: no ``chunk_tokens`` (the
monolithic and dense chunked steps), ``spec_tokens`` (speculative decode),
``prefix_cache=True``, and sampled picks (``greedy=False``).
"""

from __future__ import annotations

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
from repro_torch.serving.kv_cache import PagedKVPool
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
                 spec_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        self.device = require_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if chunk_tokens is None:
            raise NotImplementedError(
                "the port serves through the flat step only: set chunk_tokens "
                "(the monolithic and dense chunked steps come later)")
        if spec_tokens is not None:
            raise NotImplementedError("speculative decode is not ported yet")
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens={chunk_tokens}: a chunk must carry "
                             f"at least one token")
        if any(t != "attn" for t in model.cfg.layer_types):
            raise NotImplementedError("flat serving needs a pure-attention model")
        self.model = model
        self.obs = OBS_NULL
        params = tree_map(lambda t: t.to(self.device), params)
        self.params = prepack_params(params, model.ctx)

        layout = model.ctx.layout(model.compute_dtype)
        self._bucket = layout.m_r
        self.slots = max_slots or model.shape.global_batch
        max_len = model.shape.seq_len
        page_tokens = round_up(page_tokens, layout.m_r)
        # chunk writes land on whole microkernel tiles, like pages
        self.chunk_tokens = min(round_up(chunk_tokens, layout.m_r),
                                round_up(max_len, layout.m_r))
        self.token_budget = (token_budget if token_budget is not None
                             else max(1, self.slots * self.chunk_tokens))
        if self.token_budget < layout.m_r:
            raise ValueError(f"token_budget={self.token_budget} is below one "
                             f"microkernel tile (m_r={layout.m_r}); chunked "
                             f"prefill could never advance")
        if num_pages is None:
            num_pages = 1 + self.slots * ceil_div(max_len, page_tokens)
        self.pool = PagedKVPool(num_pages, page_tokens)
        self.max_pages = ceil_div(max_len, self.pool.page_tokens)
        self.scheduler = Scheduler(self.slots, self.pool, max_len,
                                   chunk_tokens=self.chunk_tokens,
                                   chunk_align=layout.m_r, telemetry=self.obs)
        self._next_rid = 0
        self._no_progress_steps = 0
        self._steps = 0
        self._flat_steps = 0
        self._flat_tokens = 0
        self._flat_width = 0
        self.caches = model.init_paged_cache(num_pages, self.pool.page_tokens,
                                             self.slots)

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
        fs = max(1, self._flat_steps)
        return {
            "steps": self._steps,
            "num_preemptions": self.scheduler.num_preemptions,
            "num_pauses": self.scheduler.num_pauses,
            "pool": self.pool.stats(),
            "flat": {
                "token_budget": self.token_budget,
                "steps": self._flat_steps,
                "mean_tokens": self._flat_tokens / fs,
                "mean_width": self._flat_width / fs,
                "fill": self._flat_tokens / max(1, self._flat_width),
            },
        }

    def step(self, *, now: Optional[float] = None,
             greedy: bool = True) -> List[Request]:
        """One engine step: admit, grow, one flat model call.  Returns the
        requests finished during it (``now`` carries a clock for arrival
        gating)."""
        self.obs.step_begin()
        finished = self._step_flat(now, greedy)
        if self.scheduler.running or finished:
            self._steps += 1
            self._no_progress_steps = 0
        else:
            self._watchdog(now)
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
            raise StallError(
                "flat step scheduled zero tokens with live slots: " +
                ", ".join(f"rid {r.rid} ({r.status}, cursor "
                          f"{r.prefill_cursor}/{r.prompt_len}, len {r.len})"
                          for r in running.values()))
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
        self._flat_steps += 1
        self._flat_tokens += total
        self._flat_width += w
        rows = self._run_flat(token, bt, row_ids, q_pos, idx)
        for slot, kind, n, req in segrefs:
            if not np.isfinite(rows[slot]).all():
                sched.quarantine(req)
                finished.append(req)
                continue
            if kind == "decode":
                req.out_tokens.append(self._pick(rows[slot], greedy))
                req.len += 1
            else:
                req.prefill_cursor += n
                req.len = req.prefill_cursor
                self.obs.request_prefill_chunk(req, n)
                if req.prefill_cursor < req.prompt_len:
                    continue              # more chunks to come
                req.status = "running"
                self.obs.request_prefill_done(req)
                req.out_tokens.append(self._pick(rows[slot], greedy))
            if req.done():
                sched.finish(req)
                finished.append(req)
        return finished

    def _run_flat(self, token, bt, row_ids, q_pos, idx) -> np.ndarray:
        """One flat step on the device; returns float32 logits [slots, V]
        on the host (numpy has no bfloat16).  The ragged-attention plan is
        built here from the host's row_ids and q_pos and uploaded with
        them, so no layer reads an index back from the card."""
        dev = self.device
        cfg = self.model.cfg
        plan = plan_ragged(row_ids, q_pos, self.pool.page_tokens, self.max_pages,
                           cfg.n_kv_heads, self.model.ctx.hw.sm_count,
                           group=cfg.n_heads // cfg.n_kv_heads)
        logits, self.caches = self.model.flat_decode_step(
            self.params, self.caches, torch.from_numpy(token).to(dev),
            torch.from_numpy(bt).to(dev), torch.from_numpy(row_ids).to(dev),
            torch.from_numpy(q_pos).to(dev), torch.from_numpy(idx).to(dev),
            plan=plan.to(dev))
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
        """Run one all-padding flat step at every ladder width (builds the
        kernels and touches every width).  All writes go to the trash page,
        so live state is untouched."""
        if self.scheduler.has_work:
            raise RuntimeError("warmup() needs an idle engine")
        bt = np.zeros((self.slots, self.max_pages), np.int32)
        idx = np.zeros((self.slots,), np.int32)
        for w in self._flat_shapes():
            self._run_flat(np.zeros((1, w), np.int32), bt,
                           np.full((w,), -1, np.int32), np.zeros((w,), np.int32),
                           idx)

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
