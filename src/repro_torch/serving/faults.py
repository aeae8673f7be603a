"""Deterministic fault injection for the serving engine.

The resilience contract is **identity under chaos**: under any seeded
:class:`FaultPlan`, every request that survives the plan gives the tokens
of the fault-free drain, and the allocator balances once the drain ends.
The engine's failure handling only ever removes work (a shed admission, a
quarantined row, a displaced row recomputed later), rows are independent,
and every pick is keyed by ``(seed, rid, position)``, so a survivor
cannot see a casualty.

A plan is host-side instrumentation of one engine instance.
:meth:`FaultPlan.install` wraps the engine's ``step`` to count steps and
arms one-shot faults at the planned ones:

- ``"oom"``: the next ``pool.alloc`` raises ``OutOfPages`` (the
  admission rollback and growth displacement);
- ``"drafter"``: the next ``drafter.propose_all`` raises, before the
  drafter does anything (the speculative degradation ladder);
- ``"nan"``: one live row of the step's logits is overwritten with NaN on
  the host, after the device call returned them (the quarantine).  The
  logits are a host copy, so no device state, captured graph or pool is
  touched, and a warmed engine captures nothing for it;
- ``"copier"``: the next ``pool.page_copier`` call raises before the
  device copy is launched (the copy-on-write failure paths).

A plan's events derive from its seed through ``np.random.Philox``, so the
same plan replays the same faults at the same steps.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.telemetry import NULL as _NULL_OBS
from repro_torch.serving.kv_cache import OutOfPages

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "InjectedFault",
           "StallError"]

FAULT_KINDS = ("oom", "drafter", "nan", "copier")


class StallError(RuntimeError):
    """A drain stopped advancing: a step scheduled zero tokens with live
    slots, or arrived work waited ``watchdog_steps`` consecutive steps
    without any progress.  The message names the rids that did not
    advance."""


class InjectedFault(RuntimeError):
    """Raised only by an injected drafter or copier fault, so a test can
    tell an injection from a real failure."""


@dataclass(frozen=True)
class FaultEvent:
    """Arm a one-shot fault of ``kind`` at engine step ``step`` (0-based,
    counted over ``Engine.step`` calls)."""
    step: int
    kind: str


class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    :meth:`install` patches one engine instance (never a class) and
    :meth:`uninstall` restores every patched attribute, so a plan can
    cover one drain of a long-lived engine; :meth:`on` pairs the two."""

    def __init__(self, events: Sequence[FaultEvent], *, seed: int = 0):
        for e in events:
            if e.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
            if e.step < 0:
                raise ValueError(f"fault step must be >= 0, got {e.step}")
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.step, e.kind))
        self.seed = seed
        self.fired = {k: 0 for k in FAULT_KINDS}
        self._armed: List[str] = []
        self._step_no = 0
        self._installed = None
        self._undo: List[Tuple[object, str, object, bool]] = []
        self._obs = _NULL_OBS

    @classmethod
    def random(cls, seed: int, *, steps: int = 32, num_events: int = 4,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """``num_events`` faults over engine steps ``[1, steps)``, kinds
        drawn uniformly; the same seed gives the same plan."""
        rng = np.random.Generator(np.random.Philox(seed))
        events = [FaultEvent(int(rng.integers(1, max(2, steps))),
                             kinds[int(rng.integers(len(kinds)))])
                  for _ in range(num_events)]
        return cls(events, seed=seed)

    def _take(self, kind: str) -> bool:
        """Consume one armed fault of ``kind``."""
        if kind in self._armed:
            self._armed.remove(kind)
            self.fired[kind] += 1
            self._obs.fault(kind, self._step_no - 1)
            return True
        return False

    @staticmethod
    def _victim_slot(engine) -> Optional[int]:
        """The NaN victim: the smallest decoding slot, else the smallest
        live slot (a prefilling row), else None (an idle step has no row
        to poison)."""
        running = engine.scheduler.running
        decoding = [s for s, r in running.items() if r.status == "running"]
        if decoding:
            return min(decoding)
        return min(running) if running else None

    def _wrap(self, obj, name: str, wrapper) -> None:
        had = name in obj.__dict__
        self._undo.append((obj, name, getattr(obj, name) if had else None,
                           had))
        setattr(obj, name, wrapper)

    def install(self, engine) -> "FaultPlan":
        if self._installed is not None:
            raise RuntimeError("FaultPlan is already installed")
        self._installed = engine
        self._step_no = 0
        self._obs = engine.obs
        plan = self

        orig_step = engine.step

        def step(*, now=None, greedy=True, seed=0):
            plan._armed = [e.kind for e in plan.events
                           if e.step == plan._step_no]
            plan._step_no += 1
            try:
                return orig_step(now=now, greedy=greedy, seed=seed)
            finally:
                plan._armed = []
        self._wrap(engine, "step", step)

        pool = engine.pool
        orig_alloc = pool.alloc

        def alloc(*a, **k):
            if plan._take("oom"):
                raise OutOfPages(f"injected OutOfPages spike (FaultPlan "
                                 f"seed={plan.seed}, step {plan._step_no - 1})")
            return orig_alloc(*a, **k)
        self._wrap(pool, "alloc", alloc)

        if pool.page_copier is not None:
            orig_copier = pool.page_copier

            def copier(src, dst):
                if plan._take("copier"):
                    raise InjectedFault(f"injected page_copier failure ({src} "
                                        f"-> {dst}, FaultPlan seed={plan.seed})")
                return orig_copier(src, dst)
            self._wrap(pool, "page_copier", copier)

        if engine.drafter is not None:
            orig_propose = engine.drafter.propose_all

            def propose_all(jobs):
                if plan._take("drafter"):
                    raise InjectedFault(f"injected drafter failure (FaultPlan "
                                        f"seed={plan.seed}, step "
                                        f"{plan._step_no - 1})")
                return orig_propose(jobs)
            self._wrap(engine.drafter, "propose_all", propose_all)

        orig_paged = engine._run_paged

        def run_paged(token, bt, lens, counts, idx=None, caches=None):
            rows = orig_paged(token, bt, lens, counts, idx, caches)
            # a monolithic prefill runs on a prefill view (caches set); the
            # JAX engine's prefill does not pass through this entry, so the
            # fault waits for the step's batched call, as it does there
            if "nan" in plan._armed and caches is None:
                slot = plan._victim_slot(engine)
                if slot is not None and plan._take("nan"):
                    rows = np.array(rows)
                    rows[slot] = np.nan
            return rows
        self._wrap(engine, "_run_paged", run_paged)

        if engine.flat:
            orig_flat = engine._run_flat

            def run_flat(token, bt, row_ids, q_pos, idx):
                out = orig_flat(token, bt, row_ids, q_pos, idx)
                if "nan" in plan._armed:
                    slot = plan._victim_slot(engine)
                    if slot is not None and plan._take("nan"):
                        out = np.array(out)
                        # the flat step gathers slot s's logits at rows
                        # s*k1 .. (s+1)*k1 (Engine._step_flat's idx)
                        k1 = out.shape[0] // engine.slots
                        out[slot * k1:(slot + 1) * k1] = np.nan
                return out
            self._wrap(engine, "_run_flat", run_flat)
        return self

    def uninstall(self) -> None:
        for obj, name, orig, had in reversed(self._undo):
            if had:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
        self._undo = []
        self._armed = []
        self._installed = None

    @contextlib.contextmanager
    def on(self, engine):
        """``with plan.on(engine): engine.drain()``: installed for the
        block, removed afterwards even when the drain raises."""
        self.install(engine)
        try:
            yield self
        finally:
            self.uninstall()

    def stats(self) -> dict:
        return {"seed": self.seed,
                "events": [(e.step, e.kind) for e in self.events],
                "fired": dict(self.fired)}
