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
    (:meth:`Scheduler.grow`); :meth:`Scheduler.plan_segments` lays decode
    rows first, then prefill chunks under the remaining budget;
  - on pool exhaustion the youngest-admitted request is displaced: a
    mid-prefill victim is *paused* (keeps pages and cursor), a decoding
    victim is *preempted* (pages released, generated tokens folded into the
    prompt, recomputed on re-admission); as a last resort a paused
    request's pages are *reclaimed*.

Termination: the victim is always the youngest admission, and ``add``
refuses any request whose whole KV lifetime cannot fit the pool alone, so
the oldest request always progresses and drains end at any pool size.
The prefix cache, speculative page asks and bounded admission come with
later slices of the port.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs.telemetry import NULL as _NULL_OBS
from repro_torch.serving.kv_cache import OutOfPages, PagedKVPool, SequencePages

__all__ = ["AdmissionError", "Request", "Scheduler", "finish_reason_for"]


class AdmissionError(RuntimeError):
    """``Scheduler.add`` refused a request; ``kind="impossible"``: its KV
    budget can never fit ``max_len`` or the pool even running alone."""

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


# spare pages an admission leaves free while other requests run
WATERMARK_PAGES = 1


class Scheduler:
    def __init__(self, max_slots: int, pool: PagedKVPool, max_len: int, *,
                 eager: bool = False, chunk_tokens: Optional[int] = None,
                 chunk_align: int = 1, telemetry=None):
        self.max_slots = max_slots
        self.pool = pool
        self.max_len = max_len
        self.eager = eager
        self.chunk_tokens = chunk_tokens       # None: monolithic prefill
        self.chunk_align = max(1, chunk_align)   # layout m_r: chunks stay tiles
        self.obs = telemetry if telemetry is not None else _NULL_OBS
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}          # slot -> request
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._admit_counter = 0
        self.num_preemptions = 0
        self.num_pauses = 0
        self.prefill_stall_steps = 0           # steps where a chunk got < ask

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def add(self, req: Request) -> None:
        """Queue one request in arrival order (never ahead of preempted or
        paused ones), or raise :class:`AdmissionError` if it could never run."""
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
        req.status = "waiting"
        i, n = 0, len(self.waiting)
        while i < n and self.waiting[i].preempted:
            i += 1
        while i < n and self.waiting[i].arrival <= req.arrival:
            i += 1
        self.waiting.insert(i, req)
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
            req.preempted = False
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            if req.pages is None:            # a paused request keeps its pages
                req.pages = SequencePages(self.pool, owner=req.rid)
            if self.chunk_tokens is not None:
                req.status = "prefilling"
                req.len = req.prefill_cursor
                if self.eager:               # the lifetime up front
                    req.pages.ensure(req.kv_budget)
            else:
                req.status = "running"
                req.pages.ensure(req.kv_budget if self.eager
                                 else req.prompt_len)
            self.running[req.slot] = req
            self.obs.request_admitted(req)
            admitted.append(req)
        return admitted

    def _pages_available(self, req: Request) -> bool:
        if self.eager:
            return self.pool.can_fit(req.kv_budget)
        reserve = WATERMARK_PAGES if self.running else 0
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

    def grow(self) -> List[Request]:
        """Give every decoding request a KV slot for the position its next
        token writes, oldest admission first.  On pool exhaustion displace
        the youngest admission and retry (pause a prefill, preempt a
        decode; reclaim paused waiters before a request preempts itself).
        Returns the displaced requests."""
        displaced: List[Request] = []
        for req in sorted(self.running.values(), key=lambda r: r.admit_seq):
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
        victim.pages.release()
        victim.prefill_cursor = 0
        victim.len = 0
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

    def quarantine(self, req: Request) -> None:
        """Retire a running row whose logits were not finite, alone: its
        pages and slot are returned and it finishes as ``"error"``."""
        if self.running.get(req.slot) is not req:
            raise RuntimeError(f"quarantine of rid {req.rid} not running")
        self.obs.request_cancelled(req, "error")
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        req.pages.release()
        req.pages = None
        req.prefill_cursor = 0
        req.len = 0
        req.status = "finished"
        req.finish_reason = "error"
