"""Speculative decode over the paged steps: drafters and the acceptance
rule.

A transcription of the JAX package's speculative module.  A drafter
proposes up to ``k`` guesses for a decoding row's next tokens; the engine
feeds the row ``[fed-back token, d_1 .. d_k]`` through the step it already
runs (``k + 1`` positions of one row), reads the target logits after every
fed position, and keeps the longest draft prefix the target itself would
have produced.

The acceptance rule is exact match against the engine's own pick: the
pick is a pure function of the logits row, the request and the position
(greedy ``argmax``, or the sampled draw keyed by ``(seed, rid, position)``),
so at each position the engine computes the pick the non-speculative
engine would make, accepts the draft token iff it equals it, and stops at
the first mismatch, whose pick is the correction.  Tokens are therefore
identical with speculation on and off, greedy and sampled; a drafter only
changes how many steps a drain takes.

Two drafters:

- :class:`NgramDrafter`: prompt lookup on the request's own context (no
  model, no device work);
- :class:`DraftModelDrafter`: a smaller model with the target's vocabulary,
  drafting greedily.  Attached to an engine, it drafts from its own paged
  cache, one page per engine slot sized to hold a whole stream; every
  decoding row's catch-up rides one ``[slots, w]`` call of the draft
  model's paged step (``w`` a power of two), then each further draft
  position one ``[slots, 1]`` call.  On the card these are the draft
  model's CUDA graphs, held in the drafter's own graph table and captured
  by :meth:`DraftModelDrafter.warmup`.  Standalone (:meth:`propose`), it
  keeps one dense cache per request and feeds the catch-up in
  power-of-two pieces through the dense ``decode`` step, which runs
  eagerly on the card: each request's cache is its own tensor, and a
  graph binds one cache's addresses.

The engine rolls rejected KV back by truncating the row's block table
(:meth:`~repro_torch.serving.kv_cache.SequencePages.truncate`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.layout import round_up
from repro_torch.core.linear import prepack_params
from repro_torch.models.model import GraphTable
from repro_torch.models.transformer import tree_map
from repro_torch.obs.telemetry import NULL as _NULL_OBS
from repro_torch.serving.scheduler import Request

__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter", "accept_tokens",
           "request_context"]


def request_context(req: Request) -> np.ndarray:
    """The request's token stream: the (possibly fold-extended) prompt and
    the generated tokens not yet folded into it.  Invariant under
    preemption, which copies ``out_tokens[:folded]`` into the prompt."""
    return np.concatenate([req.prompt,
                           np.asarray(req.out_tokens[req.folded:], np.int32)])


def accept_tokens(req: Request, drafts: List[int], logits_rows: np.ndarray,
                  n_eff: int, pick) -> Tuple[int, int]:
    """The acceptance rule.  ``logits_rows`` [K, V]: row ``j`` is the
    target's distribution after the row's ``j``-th fed token (0: the
    fed-back token, ``j >= 1``: ``drafts[j-1]``); ``n_eff`` tokens were
    fed.  ``pick(row, req)`` is the engine's own pick, which reads
    ``len(req.out_tokens)`` for its key, so each pick is appended before
    the next is made.  Appends the accepted drafts and the correction (or
    bonus) pick, stopping at eos or ``max_new`` where the engine without
    drafts would, and returns ``(appended, accepted)``; ``req.len`` is the
    engine's to advance."""
    if not 1 <= n_eff <= logits_rows.shape[0]:
        raise ValueError(f"accept_tokens: n_eff={n_eff} outside the verify "
                         f"rows [1, {logits_rows.shape[0]}] for rid {req.rid}")
    if len(drafts) < n_eff - 1:
        raise ValueError(f"accept_tokens: {len(drafts)} drafts cannot cover "
                         f"n_eff={n_eff} fed tokens for rid {req.rid}")
    appended = accepted = 0
    for j in range(n_eff):
        tok = pick(logits_rows[j], req)
        req.out_tokens.append(tok)
        appended += 1
        matched = j < n_eff - 1 and tok == drafts[j]
        if matched:
            accepted += 1
        if req.done() or not matched:
            break
    return appended, accepted


class Drafter:
    """A source of draft tokens.  :meth:`propose` returns up to ``k``
    guesses for the tokens after ``req.out_tokens[-1]`` (fewer, or none,
    when it has nothing to say); a wrong guess costs verify compute, never
    a token.  The engine calls :meth:`attach` from its constructor,
    :meth:`warmup` from its warmup and :meth:`forget` when a request
    finishes."""

    # telemetry (repro_torch.obs): the engine sets its own recorder
    obs = _NULL_OBS

    def attach(self, engine) -> None:
        """Bind sizes derived from the engine."""

    def warmup(self) -> None:
        """Make the drafter's own step programs."""

    def propose(self, req: Request, k: int) -> List[int]:
        raise NotImplementedError

    def propose_all(self, jobs: List[Tuple[Request, int]]) -> dict:
        """``{rid: drafts}`` for one step's decoding rows."""
        out = {req.rid: self.propose(req, k) for req, k in jobs}
        self.obs.draft_batch(len(jobs), sum(len(d) for d in out.values()))
        return out

    def forget(self, rid: int) -> None:
        """Drop the state of a finished request."""

    def stats(self) -> dict:
        return {}


class NgramDrafter(Drafter):
    """Prompt lookup: match the trailing ``n``-gram of the request's
    context (longest ``n`` first, most recent match) against its earlier
    positions and propose what followed."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}, {max_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.proposals = 0
        self.misses = 0

    def propose(self, req: Request, k: int) -> List[int]:
        ctx = request_context(req)
        size = int(ctx.shape[0])
        for n in range(min(self.max_ngram, size - 1), self.min_ngram - 1, -1):
            tail = ctx[size - n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((win[:size - n] == tail).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n
                self.proposals += 1
                return [int(t) for t in ctx[start:start + k]]
        self.misses += 1
        return []

    def stats(self) -> dict:
        return {"drafter": "ngram", "max_ngram": self.max_ngram,
                "proposals": self.proposals, "misses": self.misses}


class DraftModelDrafter(Drafter):
    """Greedy drafts from a smaller pure-attention model with the target's
    vocabulary, batched over the engine's slots through the draft model's
    paged step (the attached mode of the JAX package's drafter).

    Each :meth:`propose_all` reconciles every row's cache against the
    context the target committed (speculated positions survive while their
    tokens match), feeds each row's unseen context in one ragged
    ``[slots, w]`` call (``w`` the power of two at or above the widest
    catch-up; padding goes to the trash page), then drafts ``k`` tokens by
    greedy ``[slots, 1]`` calls.  The draft cache's page holds
    ``round_up(max_len + k + 1, m_r)`` tokens, so its paged step attends
    through ``core_attention``.

    The standalone :meth:`propose` (an unattached drafter) keeps a dense
    ``[1, max_len]`` cache per request and runs the model's ``"decode"``
    step eagerly (the kernels launch and are counted; no graph, since
    every request's cache lies elsewhere)."""

    def __init__(self, model, params):
        if any(t != "attn" for t in model.cfg.layer_types):
            raise ValueError(f"draft model {model.cfg.name}: recurrent mixers "
                             f"cannot reconcile rejected speculative state by "
                             f"overwrite; speculative drafting needs a "
                             f"pure-attention draft model")
        self.model = model
        params = tree_map(lambda t: t.to(model.device), params)
        self.params = prepack_params(params, model.ctx)
        self.max_len = model.shape.seq_len
        self._graphs = GraphTable()
        self._step = model.compiled_step("decode")
        self._paged = None
        self._caches = None
        self._state: dict = {}       # rid -> {ctx_len, spec[, caches]}
        self._rows: dict = {}        # rid -> draft row
        self._lru: dict = {}         # rid -> last propose tick
        self._tick = 0
        self.draft_steps = 0

    def attach(self, engine) -> None:
        if self.model.cfg.vocab != engine.model.cfg.vocab:
            raise ValueError(f"draft model vocab {self.model.cfg.vocab} != "
                             f"target vocab {engine.model.cfg.vocab}: drafter "
                             f"and target must share the tokenizer")
        if self.model.device != engine.device:
            raise ValueError(f"draft model lives on {self.model.device}, "
                             f"engine on {engine.device}")
        # the target's context limit, the final pick and k - 1 speculated
        # writes
        self.max_len = engine.scheduler.max_len + engine.spec_tokens + 1
        self._slots = engine.slots
        layout = self.model.ctx.layout(self.model.compute_dtype)
        self._page_tokens = round_up(self.max_len, layout.m_r)
        self._paged = self.model.compiled_step("paged")

    def _ensure_caches(self) -> None:
        if self._caches is None:
            self._caches = self.model.init_paged_cache(
                1 + self._slots, self._page_tokens, self._slots)

    def _batch_widths(self) -> List[int]:
        """Catch-up widths: powers of two up to the one at or above
        ``max_len``."""
        w, out = 1, []
        while True:
            out.append(w)
            if w >= self.max_len:
                return out
            w *= 2

    def _widths(self) -> List[int]:
        """The standalone catch-up widths: powers of two up to ``max_len``."""
        w, out = 1, []
        while w <= self.max_len:
            out.append(w)
            w *= 2
        return out

    def warmup(self) -> None:
        """Attached: make every ``[slots, w]`` catch-up program (``w = 1``
        is the draft step); every row inert, so every write goes to the
        trash page.  Standalone: every dense ``[1, w]`` program, against a
        scratch cache."""
        if self._paged is None:
            for w in self._widths():
                self._decode(self.model.init_cache(1, self.max_len),
                             np.zeros((1, w), np.int32), 0)
            return
        self._ensure_caches()
        zb = torch.zeros((self._slots,), dtype=torch.int32)
        btz = torch.zeros((self._slots, 1), dtype=torch.int32)
        for w in self._batch_widths():
            self._paged(self.params, self._caches,
                        torch.zeros((self._slots, w), dtype=torch.int32),
                        btz, zb, zb, None, graphs=self._graphs)

    def _row_for(self, rid: int, job_rids: set) -> int:
        """The draft row backing ``rid``; when every row is taken, evict
        the least recently proposing state outside this step's jobs."""
        if rid in self._rows:
            return self._rows[rid]
        taken = set(self._rows.values())
        free = [r for r in range(self._slots) if r not in taken]
        if free:
            row = free[0]
        else:
            victim = min((r for r in self._rows if r not in job_rids),
                         key=lambda r: self._lru.get(r, -1))
            row = self._rows.pop(victim)
            self._state.pop(victim, None)
            self._lru.pop(victim, None)
        self._rows[rid] = row
        return row

    def _decode(self, caches: dict, token: np.ndarray, pos: int) -> np.ndarray:
        """One eager call of the draft model's dense ``decode`` step (its
        signature counted as the step's trace); float32 logits [1, s, V]
        on the host."""
        dev = self.model.device
        args = (torch.from_numpy(token).to(dev),
                torch.tensor(pos, dtype=torch.int32, device=dev), None)
        self._step.count(args, caches=caches)
        logits, _ = self._step.fn(self.params, caches, *args)
        self.draft_steps += 1
        return logits.float().cpu().numpy()

    def propose(self, req: Request, k: int) -> List[int]:
        """``k`` greedy drafts for ``req`` from its own dense cache: the
        speculated positions of the last propose survive while their tokens
        match the committed context; the unseen context is fed in
        power-of-two pieces (one token early when the cache already covers
        it: the dropped logits are recomputed by an identical overwrite);
        the last draft's KV is never written."""
        ctx = request_context(req)
        size = int(ctx.shape[0])
        st = self._state.get(req.rid)
        if st is None:
            st = {"caches": self.model.init_cache(1, self.max_len),
                  "ctx_len": 0, "spec": np.zeros((0,), np.int32)}
            self._state[req.rid] = st
        base, spec = st["ctx_len"], st["spec"]
        m = 0
        while (m < spec.shape[0] and base + m < size
               and spec[m] == ctx[base + m]):
            m += 1
        start = min(base + m, size - 1)
        caches, pos, i = st["caches"], start, start
        logits = None
        while i < size:                      # catch-up, binary decomposition
            w = 1
            while w * 2 <= size - i:
                w *= 2
            logits = self._decode(caches, ctx[None, i:i + w], pos)
            pos += w
            i += w
        drafted: List[int] = []
        for j in range(k):
            t = int(np.argmax(logits[0, -1]))
            drafted.append(t)
            if j == k - 1:
                break                # the last draft's KV is never needed
            logits = self._decode(caches, np.asarray([[t]], np.int32), pos)
            pos += 1
        st["ctx_len"] = size
        # positions written past the committed context: all drafts but the
        # last
        st["spec"] = np.asarray(drafted[:-1], np.int32)
        return drafted

    def propose_all(self, jobs: List[Tuple[Request, int]]) -> dict:
        if self._paged is None or not jobs:
            return super().propose_all(jobs)
        self._ensure_caches()
        self._tick += 1
        job_rids = {req.rid for req, _ in jobs}
        plans = []
        for req, k in jobs:
            row = self._row_for(req.rid, job_rids)
            self._lru[req.rid] = self._tick
            st = self._state.get(req.rid)
            if st is None:
                st = {"ctx_len": 0, "spec": np.zeros((0,), np.int32)}
                self._state[req.rid] = st
            ctx = request_context(req)
            size = int(ctx.shape[0])
            # reconcile, then start one token early when the speculated
            # cache already covers the context (its logits were dropped)
            base, spec = st["ctx_len"], st["spec"]
            m = 0
            while (m < spec.shape[0] and base + m < size
                   and spec[m] == ctx[base + m]):
                m += 1
            start = min(base + m, size - 1)
            plans.append({"row": row, "req": req, "k": k, "ctx": ctx,
                          "size": size, "start": start, "st": st})
        maxn = max(p["size"] - p["start"] for p in plans)
        w = 1
        while w < maxn:
            w *= 2
        rows_n = self._slots
        token = np.zeros((rows_n, w), np.int32)
        lens = np.zeros((rows_n,), np.int32)
        counts = np.zeros((rows_n,), np.int32)
        bt = np.zeros((rows_n, 1), np.int32)
        for p in plans:
            r, n = p["row"], p["size"] - p["start"]
            token[r, :n] = p["ctx"][p["start"]:p["size"]]
            lens[r] = p["start"]
            counts[r] = n
            bt[r, 0] = 1 + r
        logits = self._run_batch(token, bt, lens, counts)
        drafted = {p["row"]: [] for p in plans}
        kmax = max(p["k"] for p in plans)
        for j in range(kmax):
            for p in plans:
                if j < p["k"]:
                    drafted[p["row"]].append(
                        int(np.argmax(logits[p["row"], 0])))
            if j == kmax - 1:
                break                # the last draft's KV is never needed
            token = np.zeros((rows_n, 1), np.int32)
            lens = np.zeros((rows_n,), np.int32)
            counts = np.zeros((rows_n,), np.int32)
            for p in plans:
                r = p["row"]
                if j + 1 >= p["k"]:
                    continue         # this row is done: inert this call
                token[r, 0] = drafted[r][-1]
                lens[r] = p["size"] + j
                counts[r] = 1
            logits = self._run_batch(token, bt, lens, counts)
        out = {}
        for p in plans:
            d = drafted[p["row"]]
            p["st"]["ctx_len"] = p["size"]
            # positions written past the committed context: all drafts but
            # the last
            p["st"]["spec"] = np.asarray(d[:-1], np.int32)
            out[p["req"].rid] = d
        self.obs.draft_batch(len(jobs), sum(len(d) for d in out.values()))
        return out

    def _run_batch(self, token, bt, lens, counts) -> np.ndarray:
        """One call of the draft model's paged step; float32 logits
        [slots, 1, V] on the host."""
        logits, _ = self._paged(
            self.params, self._caches, torch.from_numpy(token),
            torch.from_numpy(bt), torch.from_numpy(lens),
            torch.from_numpy(counts), None, graphs=self._graphs)
        self.draft_steps += 1
        return logits.float().cpu().numpy()

    def forget(self, rid: int) -> None:
        self._state.pop(rid, None)
        self._rows.pop(rid, None)
        self._lru.pop(rid, None)

    def stats(self) -> dict:
        return {"drafter": "draft-model", "model": self.model.cfg.name,
                "draft_steps": self.draft_steps,
                "live_states": len(self._state),
                "compiles": dict(self.model.trace_counts),
                "captures": dict(self._graphs.captures)}
