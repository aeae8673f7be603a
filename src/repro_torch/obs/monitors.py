"""Online serving anomaly monitors over the live metrics registry.

Host-side, allocation-light detectors the telemetry layer runs once per
``step_end``: each keeps a small bounded window of recent observations
and emits a typed :class:`Alert` when its rule trips.  Alerts land in
three places — the bounded ``Monitors.alerts`` deque (surfaced as
``Engine.telemetry()["alerts"]``), an ``alert:<kind>`` instant on the
``monitor`` trace track, and the ``alerts_emitted`` counter.  Like every
other ``repro_torch.obs`` component the monitors are strict observers:
they read scheduler/pool/step state that the engine already computed,
never touch a compiled step or a device tensor, and a drain with monitors
on is token-identical to one without (checked in
``tests/test_torch_attrib.py``).

Monitors (all windows are step-indexed, sizes are constructor knobs):

``step-outlier``
    Per-family step device time vs the family's rolling median: a step
    slower than ``outlier_factor`` x median over a warm window (>=
    ``outlier_min`` samples) is an anomaly — a GC stall, a page-copy
    storm, a noisy neighbour.  Per family, not global, so a legitimate
    wide-prefill step never shadows a slow decode step.
``preempt-storm``
    Preemptions over the last ``window`` steps above ``storm_limit``:
    the pool is thrashing (working set over capacity) and throughput is
    going to recompute, not progress.
``prefix-churn``
    Prefix-cache evictions over the window above ``churn_limit`` while
    the same window's hit count stays at or below it: the cache is
    cycling entries without serving them (capacity too small or keys
    never reused).
``queue-growth``
    Wait-queue depth sampled each step grew monotonically across the
    full window and by at least ``growth_min``: arrivals outpace service
    and the backlog is diverging, the page admission control should be
    shedding.
``slo-burn``
    TTFT/ITL observations violating the configured SLO targets
    (``slo_ttft_s`` / ``slo_itl_s``; ``None`` disables) at a rate above
    ``burn_rate`` over the last ``slo_window`` observations: the error
    budget is burning faster than sustainable.  Disabled by default —
    set the targets to enable (``Engine.obs.monitors.slo_itl_s = ...``).

Every alert kind re-arms only after its condition clears (one alert per
excursion, not one per step), so a pathological drain cannot flood the
trace; the deque bound caps total retention regardless.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["Alert", "Monitors"]


@dataclasses.dataclass(frozen=True)
class Alert:
    """One typed anomaly finding."""

    kind: str          # step-outlier | preempt-storm | prefix-churn |
                       # queue-growth | slo-burn
    severity: str      # "warn" | "crit"
    step: int          # engine step index the rule tripped at
    t: float           # telemetry clock at emission
    value: float       # the observed quantity
    threshold: float   # the bound it crossed
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class Monitors:
    """The monitor bank one :class:`~repro_torch.obs.telemetry.Telemetry` owns.
    ``observe_step`` is the single per-step entry point; TTFT/ITL
    observations stream in via ``observe_ttft``/``observe_itl``."""

    def __init__(self, *, window: int = 32, outlier_factor: float = 4.0,
                 outlier_min: int = 8, storm_limit: Optional[int] = None,
                 churn_limit: int = 8, growth_min: Optional[int] = None,
                 slo_ttft_s: Optional[float] = None,
                 slo_itl_s: Optional[float] = None,
                 burn_rate: float = 0.10, slo_window: int = 32,
                 max_alerts: int = 256):
        self.window = window
        self.outlier_factor = outlier_factor
        self.outlier_min = outlier_min
        self.storm_limit = storm_limit      # None -> scheduler slots
        self.churn_limit = churn_limit
        self.growth_min = growth_min        # None -> scheduler slots
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self.burn_rate = burn_rate
        self.alerts: Deque[Alert] = deque(maxlen=max_alerts)
        self._step = 0
        self._fam_dev: Dict[str, Deque[float]] = {}
        self._preempt: Deque[int] = deque(maxlen=window)
        self._evict: Deque[int] = deque(maxlen=window)
        self._hits: Deque[int] = deque(maxlen=window)
        self._depth: Deque[int] = deque(maxlen=window)
        self._ttft_viol: Deque[bool] = deque(maxlen=slo_window)
        self._itl_viol: Deque[bool] = deque(maxlen=slo_window)
        self._last_preempt = 0
        self._last_evict = 0
        self._last_hits = 0
        self._armed = {k: True for k in
                       ("step-outlier", "preempt-storm", "prefix-churn",
                        "queue-growth", "slo-burn:ttft", "slo-burn:itl")}
        self._emitted: List[Alert] = []     # this step's fresh alerts

    # ------------------------------------------------------------------
    def observe_ttft(self, v: float) -> None:
        if self.slo_ttft_s is not None:
            self._ttft_viol.append(v > self.slo_ttft_s)

    def observe_itl(self, v: float) -> None:
        if self.slo_itl_s is not None:
            self._itl_viol.append(v > self.slo_itl_s)

    def observe_step(self, *, t: float, scheduler, telemetry,
                     families, device_s: float) -> List[Alert]:
        """Run every rule against this step; returns the alerts that
        fired *this step* (already appended to ``self.alerts``)."""
        self._step += 1
        self._emitted = []
        slots = max(1, scheduler.max_slots)
        storm_limit = (self.storm_limit if self.storm_limit is not None
                       else slots)
        growth_min = (self.growth_min if self.growth_min is not None
                      else slots)

        # per-family step-time outlier vs the rolling median.  The
        # current sample joins the window only after the comparison, so
        # a single spike cannot drag its own baseline up.
        for label, real, width, dev_s in families:
            win = self._fam_dev.setdefault(
                label, deque(maxlen=self.window))
            if len(win) >= self.outlier_min:
                med = _median(win)
                bound = self.outlier_factor * med
                if med > 0 and dev_s > bound:
                    self._fire("step-outlier", "warn", t, dev_s, bound,
                               f"{label}: device {dev_s * 1e3:.2f}ms > "
                               f"{self.outlier_factor:.0f}x rolling median "
                               f"{med * 1e3:.2f}ms")
                elif dev_s <= bound:
                    self._armed["step-outlier"] = True
            win.append(dev_s)

        # preemption storm: window sum of per-step preemption deltas
        cur = scheduler.num_preemptions
        self._preempt.append(cur - self._last_preempt)
        self._last_preempt = cur
        storm = sum(self._preempt)
        if storm > storm_limit:
            self._fire("preempt-storm", "crit", t, storm, storm_limit,
                       f"{storm} preemptions in the last "
                       f"{len(self._preempt)} steps (> {storm_limit}): "
                       f"the pool is thrashing")
        else:
            self._armed["preempt-storm"] = True

        # prefix-cache churn: evictions without hits over the window
        reg = telemetry.registry
        evict = reg.counter("prefix_evictions").value
        hits = reg.counter("prefix_hits").value
        self._evict.append(evict - self._last_evict)
        self._hits.append(hits - self._last_hits)
        self._last_evict, self._last_hits = evict, hits
        churn, served = sum(self._evict), sum(self._hits)
        if churn > self.churn_limit and served <= self.churn_limit:
            self._fire("prefix-churn", "warn", t, churn, self.churn_limit,
                       f"{churn} prefix-cache evictions vs {served} hits "
                       f"over {len(self._evict)} steps: the cache is "
                       f"cycling without serving")
        else:
            self._armed["prefix-churn"] = True

        # queue growth: depth monotonically increasing across the window
        self._depth.append(len(scheduler.waiting))
        d = self._depth
        if len(d) == d.maxlen and d[-1] - d[0] >= growth_min \
                and all(b >= a for a, b in zip(d, list(d)[1:])):
            self._fire("queue-growth", "crit", t, d[-1] - d[0], growth_min,
                       f"wait queue grew {d[0]} -> {d[-1]} monotonically "
                       f"over {len(d)} steps: arrivals outpace service")
        else:
            self._armed["queue-growth"] = True

        # SLO burn rate over the recent observation window
        for name, win in (("ttft", self._ttft_viol),
                          ("itl", self._itl_viol)):
            key = f"slo-burn:{name}"
            if len(win) < max(4, win.maxlen // 4):
                continue
            rate = sum(win) / len(win)
            if rate > self.burn_rate:
                self._fire(key, "crit", t, rate, self.burn_rate,
                           f"{name} SLO violated on {rate:.0%} of the "
                           f"last {len(win)} observations "
                           f"(budget {self.burn_rate:.0%})",
                           kind="slo-burn")
            else:
                self._armed[key] = True
        return self._emitted

    # ------------------------------------------------------------------
    def _fire(self, key: str, severity: str, t: float, value: float,
              threshold: float, message: str, *,
              kind: Optional[str] = None) -> None:
        if not self._armed.get(key, True):
            return                          # one alert per excursion
        self._armed[key] = False
        alert = Alert(kind=kind or key, severity=severity, step=self._step,
                      t=t, value=float(value), threshold=float(threshold),
                      message=message)
        self.alerts.append(alert)
        self._emitted.append(alert)
