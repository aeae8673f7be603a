"""Continuous-batching scheduler: FCFS admission into fixed slots, lazy
page allocation, chunked prefill under a token budget, and displacement on
pool exhaustion.

A transcription of the JAX package's scheduler (pure host logic) for the
policies the port's engine serves:

  - requests queue in arrival order; preempted or paused requests wait at
    the front;
  - admission needs a free slot and pages plus a watermark of spare pages
    (waived when nothing runs): for the request's *next chunk* under the
    chunked policy (``chunk_tokens`` set, the flat and dense chunked
    steps), for its whole prompt under the monolithic one (``chunk_tokens
    =None``: the admitted request is prefilled at once and runs), and for
    its whole KV lifetime with ``eager=True`` (growth then never fails);
  - every step each prefilling row gets its next chunk
    (:meth:`Scheduler.plan_chunks`) and every decoding row one position
    (:meth:`Scheduler.grow`), or under speculative decode its ``1 + k``
    verify positions when the pool can spare them without displacing
    anyone; :meth:`Scheduler.plan_segments` lays decode rows first, then
    prefill chunks under the remaining budget;
  - on pool exhaustion the youngest-admitted request is displaced: a
    mid-prefill victim is *paused* (keeps pages and cursor), a decoding
    victim is *preempted* (pages released, generated tokens folded into the
    prompt, recomputed on re-admission); as a last resort a paused
    request's pages are *reclaimed*;
  - with a prefix cache, admission starts a request's prefill at the
    longest cached prefix of its prompt (the shared pages read-only, the
    one page the cursor lands in copied first), and preemption and
    reclaim release the written full pages into the cache.

Termination: the victim is always the youngest admission, and ``add``
refuses any request whose whole KV lifetime cannot fit the pool alone, so
the oldest request always progresses and drains end at any pool size.

Resilience: with ``queue_limit`` or ``queue_pages`` set, ``add`` sheds an
arrival that would overfill the wait queue (a typed
:class:`AdmissionError`, taken before any state is); :meth:`Scheduler.
cancel` retires a request from any live state, its pages released (into
the prefix cache, unless the KV is suspect), and :meth:`Scheduler.expire`
cancels as ``"timeout"`` every request past its ``deadline_s`` or, still
unadmitted, its ``max_queue_s``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs.telemetry import NULL as _NULL_OBS
from repro_torch.serving.kv_cache import (OutOfPages, PagedKVPool, PoolError,
                                          SequencePages)

__all__ = ["AdmissionError", "Request", "Scheduler", "finish_reason_for"]


class AdmissionError(RuntimeError):
    """``Scheduler.add`` refused a request.  ``kind``: ``"queue-depth"`` or
    ``"page-demand"``, an overload shed (the bounded queue is full, or its
    predicted page demand passes ``queue_pages``; the engine finishes the
    request as ``"rejected"``); ``"impossible"``, its KV budget can never
    fit ``max_len`` or the pool even running alone."""

    def __init__(self, rid: int, kind: str, message: str):
        super().__init__(message)
        self.rid = rid
        self.kind = kind


def finish_reason_for(tokens, max_new: int, eos_id: Optional[int]):
    """The finish-reason rule: the first eos strictly before the final
    permitted position finishes as ``"eos"`` (keeping it); otherwise the
    stream runs to ``max_new`` and finishes as ``"length"``.  Returns
    ``(n_kept, reason)``."""
    if eos_id is not None:
        for i, t in enumerate(tokens[:max_new]):
            if t == eos_id and i < max_new - 1:
                return i + 1, "eos"
    return min(len(tokens), max_new), "length"


@dataclasses.dataclass
class Request:
    """One generation request and its runtime state."""

    rid: int
    prompt: np.ndarray            # [L] int32 prompt tokens
    max_new: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    temperature: float = 1.0      # 0 picks greedily in a sampled drain
    seed: Optional[int] = None    # None takes the step's seed
    # bounds from ``arrival`` on the clock the engine is stepped with:
    # ``deadline_s`` the whole lifetime, ``max_queue_s`` the wait before
    # the first admission; expiry finishes the request as "timeout"
    deadline_s: Optional[float] = None
    max_queue_s: Optional[float] = None

    status: str = "waiting"       # waiting | prefilling | running | finished
    slot: int = -1
    pages: Optional[SequencePages] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    len: int = 0                  # tokens whose KV is in the cache
    finish_reason: Optional[str] = None
    admit_seq: int = -1           # admission order; displacement takes max
    preempted: bool = False       # waiting at the front for re-admission
    num_preemptions: int = 0
    folded: int = 0               # leading out_tokens already in the prompt
    prefill_cursor: int = 0       # prompt tokens whose KV is written
    num_pauses: int = 0
    chunk_steps: int = 0          # prefill steps run (monolithic: per call)
    # prefix-cache accounting: out_tokens at the last admission, whether a
    # reclaim reset the cursor, and the tokens whose pages entered the
    # cache at the last preemption
    out_at_admit: int = 0
    reclaimed: bool = False
    cached_upto: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def kv_budget(self) -> int:
        """KV slots this request can still occupy: the (possibly folded)
        prompt plus every remaining generated token that is fed back."""
        return self.prompt_len + (self.max_new - len(self.out_tokens)) - 1

    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new or (
                self.eos_id is not None and self.out_tokens
                and self.out_tokens[-1] == self.eos_id):
            self.finish_reason = self.finish_reason or finish_reason_for(
                self.out_tokens, self.max_new, self.eos_id)[1]
            return True
        return False


class Scheduler:
    def __init__(self, max_slots: int, pool: PagedKVPool, max_len: int, *,
                 eager: bool = False, watermark_pages: int = 1,
                 chunk_tokens: Optional[int] = None, chunk_align: int = 1,
                 prefix_cache=None, queue_limit: Optional[int] = None,
                 queue_pages: Optional[int] = None, telemetry=None):
        self.max_slots = max_slots
        self.pool = pool
        self.max_len = max_len
        self.eager = eager
        self.watermark_pages = watermark_pages   # spare pages while others run
        self.chunk_tokens = chunk_tokens       # None: monolithic prefill
        self.chunk_align = max(1, chunk_align)   # layout m_r: chunks stay tiles
        if prefix_cache is not None and eager:
            raise ValueError("the prefix cache needs lazy allocation: eager "
                             "reservation books whole lifetimes, which shared "
                             "pages would count twice")
        self.prefix_cache = prefix_cache       # None: no sharing
        # bounds on the queued requests and on their predicted page demand
        # (None: unbounded)
        self.queue_limit = queue_limit
        self.queue_pages = queue_pages
        self.obs = telemetry if telemetry is not None else _NULL_OBS
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}          # slot -> request
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._admit_counter = 0
        self.num_preemptions = 0
        self.num_pauses = 0
        self.prefill_stall_steps = 0           # steps where a chunk got < ask
        self.spec_grow_fallbacks = 0           # speculative page asks shed
        self.peak_running = 0
        self.peak_waiting = 0
        # resumes after a preemption under the prefix cache: their count,
        # the prompt tokens they recomputed, and the last 256 of them
        self.resumes = 0
        self.resume_recompute_tokens = 0
        self.resume_events: Deque[dict] = deque(maxlen=256)
        # requests shed at add(), expired, cancelled by the caller, or
        # quarantined (retired with their pages kept out of the cache)
        self.num_rejected = 0
        self.num_timeouts = 0
        self.num_cancels = 0
        self.num_quarantines = 0

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def add(self, req: Request) -> None:
        """Queue one request in arrival order (never ahead of preempted or
        paused ones), or raise :class:`AdmissionError`: ``"impossible"``
        if it could never run, ``"queue-depth"`` or ``"page-demand"`` if
        the bounded queue sheds it.  Sheds are decided before any state
        is taken, so a rejection strands no slot and no page."""
        if req.kv_budget > self.max_len:
            raise AdmissionError(
                req.rid, "impossible",
                f"request {req.rid}: KV budget {req.kv_budget} (prompt "
                f"{req.prompt_len} + max_new {req.max_new} - 1) exceeds "
                f"engine max_len {self.max_len}")
        if self.pool.pages_for(req.kv_budget) > self.pool.usable_pages:
            raise AdmissionError(
                req.rid, "impossible",
                f"request {req.rid}: KV budget {req.kv_budget} can never fit "
                f"the pool ({self.pool.usable_pages} usable pages of "
                f"{self.pool.page_tokens} tokens)")
        # preempted and paused requests come back by appendleft, never
        # through add(), so admitted work is never shed here
        if self.queue_limit is not None \
                and len(self.waiting) >= self.queue_limit:
            self.num_rejected += 1
            raise AdmissionError(
                req.rid, "queue-depth",
                f"request {req.rid} shed: wait queue at its bound "
                f"({len(self.waiting)}/{self.queue_limit})")
        if self.queue_pages is not None:
            # the prompt pages of every queued request holding none yet,
            # plus the arrival's (a paused waiter's pages are booked)
            demand = self.pool.pages_for(req.prompt_len) + sum(
                self.pool.pages_for(r.prompt_len) for r in self.waiting
                if r.pages is None)
            if demand > self.queue_pages:
                self.num_rejected += 1
                raise AdmissionError(
                    req.rid, "page-demand",
                    f"request {req.rid} shed: queued prompt-page demand "
                    f"{demand} exceeds queue_pages={self.queue_pages}")
        req.status = "waiting"
        i, n = 0, len(self.waiting)
        while i < n and self.waiting[i].preempted:
            i += 1
        while i < n and self.waiting[i].arrival <= req.arrival:
            i += 1
        self.waiting.insert(i, req)
        self.peak_waiting = max(self.peak_waiting, len(self.waiting))
        self.obs.request_queued(req)

    def admit(self, now: Optional[float] = None,
              limit: Optional[int] = None) -> List[Request]:
        """Admit waiting requests (FCFS) while a slot is free and the pool
        has pages for the head (its next chunk, its prompt, or with
        ``eager`` its lifetime) plus the watermark.  Chunked: the admitted
        request is ``"prefilling"``; monolithic: ``"running"``, its prompt's
        pages held, for the engine to prefill.  ``now`` gates admission by
        arrival time; ``limit`` caps this call's admissions (the
        monolithic engine admits one at a time)."""
        admitted = []
        while (self.waiting and self._free_slots
               and (limit is None or len(admitted) < limit)
               and (now is None or self.waiting[0].arrival <= now)):
            if not self._pages_available(self.waiting[0]):
                # with nothing running nobody frees pages on their own:
                # reclaim paused waiters (never the head itself)
                if not self.running and \
                        self._reclaim_one_paused(exclude=self.waiting[0]):
                    continue
                break
            req = self.waiting.popleft()
            req.slot = self._free_slots.pop()
            was_preempted, was_reclaimed = req.preempted, req.reclaimed
            fresh_pages = req.pages is None
            req.preempted = False
            req.reclaimed = False
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            try:
                self._take_pages(req, was_preempted, was_reclaimed)
            except OutOfPages:
                # the check said yes but an allocation failed: undo the
                # whole admission; the head retries next step
                if fresh_pages and req.pages is not None:
                    req.pages.release()
                    req.pages = None
                    req.prefill_cursor = 0
                    req.len = 0
                self._free_slots.append(req.slot)
                req.slot = -1
                req.status = "waiting"
                req.preempted = was_preempted
                req.reclaimed = was_reclaimed
                self.waiting.appendleft(req)
                break
            self.running[req.slot] = req
            self.obs.request_admitted(req)
            admitted.append(req)
        self.peak_running = max(self.peak_running, len(self.running))
        return admitted

    def _take_pages(self, req: Request, was_preempted: bool,
                    was_reclaimed: bool) -> None:
        """The part of an admission that can raise :class:`OutOfPages`:
        the block table (from the prefix cache's longest hit, when there is
        one), then the pages of the first chunk, the prompt or, with
        ``eager``, the lifetime."""
        if req.pages is None:            # a paused request keeps its pages
            req.pages = SequencePages(self.pool, owner=req.rid)
            if self.prefix_cache is not None:
                self._acquire_prefix(req)
                if was_preempted:
                    recompute = req.prompt_len - req.prefill_cursor
                    self.resumes += 1
                    self.resume_recompute_tokens += recompute
                    self.resume_events.append({
                        "rid": req.rid, "recompute": recompute,
                        "generated_since": (len(req.out_tokens)
                                            - req.out_at_admit),
                        "reclaimed": was_reclaimed,
                        "evicted": req.prefill_cursor < min(
                            req.cached_upto, req.prompt_len - 1)})
        req.out_at_admit = len(req.out_tokens)
        if self.chunk_tokens is not None:
            req.status = "prefilling"
            req.len = req.prefill_cursor
            if self.eager:               # the lifetime up front
                req.pages.ensure(req.kv_budget)
        else:
            req.status = "running"
            req.pages.ensure(req.kv_budget if self.eager else req.prompt_len)

    def _acquire_prefix(self, req: Request) -> None:
        """Start ``req`` at its longest cached prefix: the matched pages
        enter its empty block table and the cursor jumps to the hit.  When
        the capped hit ends inside the last shared page (a fully cached
        prompt), that page is copied now, before the prefill writes the
        last position into it; if the copy fails, the page is handed back
        and its block prefilled again."""
        pages, hit = self.prefix_cache.lookup(req.prompt)
        if not pages:
            return
        req.pages.pages = pages
        if hit % self.pool.page_tokens:
            try:
                self.pool.cow(req.pages, len(pages) - 1)
            except PoolError:
                self.pool.free([req.pages.pages.pop()])
                hit = len(req.pages.pages) * self.pool.page_tokens
        req.prefill_cursor = hit
        req.len = hit

    def _pages_available(self, req: Request) -> bool:
        if self.eager:
            return self.pool.can_fit(req.kv_budget)
        reserve = self.watermark_pages if self.running else 0
        if self.chunk_tokens is None:
            return self.pool.pages_for(req.prompt_len) + reserve \
                <= self.pool.num_available
        held = 0 if req.pages is None else len(req.pages.pages)
        first = min(req.prefill_cursor + self.chunk_tokens, req.prompt_len)
        need = max(0, self.pool.pages_for(first) - held)
        return need + reserve <= self.pool.num_available

    def plan_chunks(self, budget: int) -> Dict[int, int]:
        """This step's prompt chunk for every prefilling slot, oldest
        admission first: ``min(chunk_tokens, remaining prompt, remaining
        budget)`` tokens and the pages to hold them.  On ``OutOfPages`` the
        slot stalls (contributes 0 this step) — except the oldest prefill
        when nothing decodes, which reclaims paused waiters' pages (and
        pauses younger prefills) so the head of the line progresses.
        Returns ``{slot: n}``."""
        plan: Dict[int, int] = {}
        prefilling = sorted(
            (r for r in self.running.values() if r.status == "prefilling"),
            key=lambda r: r.admit_seq)
        decoding = any(r.status == "running" for r in self.running.values())
        stalled = False
        for idx, req in enumerate(prefilling):
            if req.slot < 0 or req.status != "prefilling":
                continue                 # paused by an earlier reclaim pass
            want = min(self.chunk_tokens, req.prompt_len - req.prefill_cursor)
            n = min(want, max(0, budget))
            if n < want:
                # budget-clamped: keep the cursor on a tile boundary
                n -= n % self.chunk_align
            if n > 0:
                try:
                    req.pages.ensure(req.prefill_cursor + n)
                except OutOfPages:
                    if idx == 0 and not decoding:
                        self._reclaim_for(req, n)
                    n = min(n, req.pages.capacity - req.prefill_cursor)
            if n < want:
                stalled = True
            plan[req.slot] = n
            budget -= n
        if stalled:
            self.prefill_stall_steps += 1
        return plan

    def plan_segments(self, decode_counts: Dict[int, int],
                      budget: int) -> List[tuple]:
        """Flat-segment plan for one ``[1, W]`` step: decode rows (each
        ``decode_counts[slot]`` real positions, never budget-stalled), then
        prefill chunks under the remaining budget.  Returns an ordered
        ``[(slot, kind, n)]`` list, ``kind in {"decode", "prefill"}``."""
        plan = self.plan_chunks(budget - sum(decode_counts.values()))
        segs: List[tuple] = []
        for slot in sorted(self.running):
            req = self.running[slot]
            if req.status == "running" and slot in decode_counts:
                segs.append((slot, "decode", decode_counts[slot]))
            elif req.status == "prefilling" and plan.get(slot, 0) > 0:
                segs.append((slot, "prefill", plan[slot]))
        return segs

    def _reclaim_for(self, req: Request, n: int) -> None:
        """Last-resort page recovery for the oldest prefill when nothing
        else runs: release paused waiters' pages, pausing younger running
        prefills so the next reclaim can take theirs."""
        while True:
            try:
                req.pages.ensure(req.prefill_cursor + n)
                return
            except OutOfPages:
                if self._reclaim_one_paused():
                    continue
                younger = [r for r in self.running.values()
                           if r.status == "prefilling" and r is not req]
                if not younger:
                    return               # caller falls back to capacity
                self._pause(max(younger, key=lambda r: r.admit_seq))

    def grow(self, want: Optional[Dict[int, int]] = None) -> List[Request]:
        """Give every decoding request a KV slot for the position its next
        token writes, oldest admission first.  On pool exhaustion displace
        the youngest admission and retry (pause a prefill, preempt a
        decode; reclaim paused waiters before a request preempts itself).

        ``want``: ``{slot: n}``, a speculative ask of ``n`` positions (the
        fed-back token and its drafts).  Only the first is mandatory: the
        ask is shed (``spec_grow_fallbacks``) whenever granting it would
        take pages the other rows' one-token growth needs this step, so a
        speculative ask never forces a displacement.  Returns the
        displaced requests."""
        displaced: List[Request] = []
        for req in sorted(self.running.values(), key=lambda r: r.admit_seq):
            if req.status != "running":
                continue
            n = 1 if want is None else max(1, want.get(req.slot, 1))
            if n > 1:
                need = max(0, self.pool.pages_for(req.len + n)
                           - len(req.pages.pages))
                if need == 0:
                    continue     # the held pages' slack covers the ask
                if need <= self.pool.num_available \
                        - self._mandatory_growth_pages(req):
                    try:
                        req.pages.ensure(req.len + n)
                        continue
                    except OutOfPages:
                        pass
                self.spec_grow_fallbacks += 1
            while req.status == "running":
                try:
                    req.pages.ensure(req.len + 1)
                    break
                except OutOfPages:
                    victim = max(self.running.values(),
                                 key=lambda r: r.admit_seq)
                    if victim.status == "prefilling":
                        self._pause(victim)
                    elif victim is req and self._reclaim_one_paused():
                        continue
                    else:
                        self._preempt(victim)
                    displaced.append(victim)
        return displaced

    def _mandatory_growth_pages(self, exclude: Request) -> int:
        """Pages the other decoding rows' one-token growth still needs this
        step (0 or 1 each)."""
        return sum(1 for r in self.running.values()
                   if r is not exclude and r.status == "running"
                   and self.pool.pages_for(r.len + 1) > len(r.pages.pages))

    def _pause(self, req: Request) -> None:
        """Displace a mid-prefill request keeping its pages and cursor; it
        resumes from the cursor on re-admission."""
        if req.status != "prefilling" or self.running.get(req.slot) is not req:
            raise RuntimeError(f"pause of rid {req.rid} in state {req.status}")
        self.obs.request_paused(req)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        req.status = "waiting"
        req.preempted = True
        req.num_pauses += 1
        self.num_pauses += 1
        self.waiting.appendleft(req)

    def _reclaim_one_paused(self, exclude: Optional[Request] = None) -> bool:
        """Release the pages of the youngest paused waiter (cursor reset).
        Returns False when no other waiter holds pages."""
        holders = [r for r in self.waiting
                   if r is not exclude and r.pages is not None and r.pages.pages]
        if not holders:
            return False
        victim = max(holders, key=lambda r: r.admit_seq)
        if self.prefix_cache is not None:
            # released into the cache: the written chunks stay findable
            self.prefix_cache.insert(victim.prompt, victim.pages.pages,
                                     min(victim.prefill_cursor,
                                         victim.prompt_len))
            victim.pages.release()
            victim.pages = None      # re-admission looks the prefix up again
        else:
            victim.pages.release()
        victim.prefill_cursor = 0
        victim.len = 0
        victim.reclaimed = True
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self.obs.request_reclaimed(victim)
        return True

    def _preempt(self, req: Request) -> None:
        """Release everything and requeue at the front: the tokens generated
        since the last admission fold into the prompt, so re-admission
        recomputes the released KV and continues the same sequence."""
        if self.running.get(req.slot) is not req:
            raise RuntimeError(f"preempt of rid {req.rid} not running")
        self.obs.request_preempted(req)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        fresh = req.out_tokens[req.folded:]
        if fresh:
            req.prompt = np.concatenate([req.prompt, np.asarray(fresh, np.int32)])
            req.folded = len(req.out_tokens)
        if self.prefix_cache is not None:
            # positions 0..len-1 hold committed KV (a rollback truncated
            # any rejected draft): cache the full pages under the folded
            # prompt, before this request's references drop
            upto = min(req.len, req.prompt_len)
            self.prefix_cache.insert(req.prompt, req.pages.pages, upto)
            req.cached_upto = (upto // self.pool.page_tokens
                               * self.pool.page_tokens)
        req.pages.release()
        req.pages = None
        req.len = 0
        req.prefill_cursor = 0
        req.status = "waiting"
        req.preempted = True
        req.num_preemptions += 1
        self.num_preemptions += 1
        # victims go youngest first, so the oldest ends up at the head
        self.waiting.appendleft(req)

    def finish(self, req: Request) -> None:
        """Evict: return the slot and the pages."""
        if self.running.get(req.slot) is not req:
            raise RuntimeError(f"finish of rid {req.rid} not running")
        self.obs.request_finished(req)
        del self.running[req.slot]
        req.pages.release()
        self._free_slots.append(req.slot)
        req.slot = -1
        req.status = "finished"

    def cancel(self, rid: int, reason: str = "cancelled", *,
               cache_pages: bool = True) -> Optional[Request]:
        """Retire request ``rid`` from any live state: queued (fresh,
        paused or preempted), prefilling or decoding (``out_tokens`` and
        ``len`` cover accepted tokens only, so a speculative rollback
        leaves nothing partial).  The slot returns, and the pages go into
        the prefix cache when there is one and ``cache_pages``, else
        straight back to the free list (``cache_pages=False``: the
        engine's quarantine of suspect KV).  The request finishes as
        ``reason`` ("cancelled", "timeout" or "error").  Returns it, or
        None when ``rid`` is not live."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                self.obs.request_cancelled(r, reason)
                return self._retire_cancelled(r, reason, cache_pages)
        for slot, r in list(self.running.items()):
            if r.rid == rid:
                del self.running[slot]
                self._free_slots.append(slot)
                self.obs.request_cancelled(r, reason)
                r.slot = -1
                return self._retire_cancelled(r, reason, cache_pages)
        return None

    def _retire_cancelled(self, req: Request, reason: str,
                          cache_pages: bool) -> Request:
        if req.pages is not None:
            if cache_pages and self.prefix_cache is not None \
                    and req.pages.pages:
                # as at preemption: positions 0..len-1 (the cursor of a
                # mid-prefill row) hold committed KV, capped at the prompt
                upto = min(max(req.len, req.prefill_cursor), req.prompt_len)
                self.prefix_cache.insert(req.prompt, req.pages.pages, upto)
            req.pages.release()
            req.pages = None
        req.prefill_cursor = 0
        req.len = 0
        req.status = "finished"
        req.finish_reason = reason
        if reason == "timeout":
            self.num_timeouts += 1
        elif reason == "error":
            self.num_quarantines += 1
        else:
            self.num_cancels += 1
        return req

    def expire(self, now: Optional[float]) -> List[Request]:
        """Cancel as ``"timeout"`` every live request past its
        ``deadline_s`` (any state) or, never admitted, its ``max_queue_s``
        at time ``now``; ``now=None`` checks nothing.  The engine runs it
        before admission, so a doomed head never takes a slot."""
        if now is None:
            return []
        stale = [r for r in list(self.waiting) + list(self.running.values())
                 if (r.deadline_s is not None
                     and now - r.arrival >= r.deadline_s)
                 or (r.max_queue_s is not None and r.admit_seq < 0
                     and r.status == "waiting"
                     and now - r.arrival >= r.max_queue_s)]
        return [self.cancel(r.rid, "timeout") for r in stale]

    def stats(self) -> dict:
        """Cumulative counters (the pool's live on the pool)."""
        running = list(self.running.values())
        return {
            "waiting": len(self.waiting),
            "running": len(running),
            "prefilling": sum(r.status == "prefilling" for r in running),
            "decoding": sum(r.status == "running" for r in running),
            "free_slots": len(self._free_slots),
            "peak_running": self.peak_running,
            "peak_waiting": self.peak_waiting,
            "num_preemptions": self.num_preemptions,
            "num_pauses": self.num_pauses,
            "prefill_stall_steps": self.prefill_stall_steps,
            "spec_grow_fallbacks": self.spec_grow_fallbacks,
            "chunk_tokens": self.chunk_tokens,
            "resumes": self.resumes,
            "resume_recompute_tokens": self.resume_recompute_tokens,
            "queue_limit": self.queue_limit,
            "queue_pages": self.queue_pages,
            "num_rejected": self.num_rejected,
            "num_timeouts": self.num_timeouts,
            "num_cancels": self.num_cancels,
            "num_quarantines": self.num_quarantines,
        }
