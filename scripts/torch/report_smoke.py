#!/usr/bin/env python
"""Attribution-report smoke on the port: exposition formats + completeness,
end to end (the port's counterpart of ``scripts/report_smoke.py``, with
its configurations and request mix).

Run via ``scripts/torch/tier1.sh --report`` or directly with
``PYTHONPATH=src``.  Drains a small deterministic request mix on a
telemetry-enabled, warmed engine per configuration (chunked and flat;
warmup builds the roofline cost model), writes the HTML/Prometheus report
pair to a temp dir, and checks:

  * attribution completeness: every per-step record's
    ``sched + device + draft + host`` reconstructs the measured wall
    within float tolerance, and the drain totals inherit the identity;
  * the Prometheus text passes :func:`repro_torch.obs.export.lint_prometheus`;
  * the HTML report is a self-contained single file (waterfall,
    per-family table, latency percentiles, alert log; no ``<script>``);
  * the cost model is warmup-only: it exists after ``warmup()``, covers
    every family label the drain measured, and the drain makes no new
    step signature (on the card: captures no graph) with attribution on.

Exits 1 on any violation, printing the offending config/check.

    PYTHONPATH=src python scripts/torch/report_smoke.py               # the card
    PYTHONPATH=src python scripts/torch/report_smoke.py --device cpu
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

CONFIGS = {
    "chunked": dict(chunk_tokens=8, flat=False),
    "flat": dict(chunk_tokens=8, token_budget=16),
}


def _requests(vocab, seed=11):
    rng = np.random.Generator(np.random.Philox(seed))
    lens, news = [5, 11, 8, 3], [6, 4, 9, 7]
    return [(rng.integers(1, vocab, size=l).astype(np.int32), n)
            for l, n in zip(lens, news)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions); "
                         "without a card cuda raises")
    args = ap.parse_args(argv)

    from repro_torch.analysis.runner import build_model
    from repro_torch.core.hardware import require_device
    from repro_torch.kernels.ragged_attn.ops import HEAD_WIDTHS, TILE
    from repro_torch.obs.export import lint_prometheus
    from repro_torch.serving.engine import Engine

    device = require_device(args.device)
    # the JAX script's reduced model and 8-token pages; on the card heads
    # 64 wide and pages of 16 tokens, the narrowest heads and the one page
    # size the ragged attention kernel takes
    card = device.type == "cuda"
    model, params = build_model(slots=3, device=device,
                                d_head=HEAD_WIDTHS[0] if card else None)
    page_tokens = TILE if card else 8
    reqs = _requests(model.cfg.vocab)
    failures = 0
    print(f"report smoke on {device.type}: {model.cfg.name}, "
          f"{len(CONFIGS)} configurations")

    def fail(where, msg):
        nonlocal failures
        failures += 1
        print(f"  FAIL  {where}: {msg}")

    for cname, kwargs in CONFIGS.items():
        eng = Engine(model, params, device=device, max_slots=3,
                     page_tokens=page_tokens, telemetry=True, **kwargs)
        eng.warmup()
        if eng.cost_model is None:
            fail(cname, "warmup() built no cost model")
            continue
        traces = sum(model.trace_counts.values())
        captures = sum(eng.stats()["captures"].values())
        for prompt, n in reqs:
            eng.add_request(prompt, n)
        eng.drain()

        if sum(model.trace_counts.values()) != traces:
            fail(cname, "attribution made a new step signature post-warmup")
        if sum(eng.stats()["captures"].values()) != captures:
            fail(cname, "attribution captured a graph post-warmup")

        recs = list(eng.obs.step_records)
        if not recs:
            fail(cname, "drain produced no attribution records")
        for i, rec in enumerate(recs):
            parts = (rec["sched"] + rec["device"] + rec["draft"]
                     + rec["host"])
            if abs(parts - rec["wall"]) > 1e-9 + 1e-6 * rec["wall"]:
                fail(cname, f"step {i}: components {parts:.9f} != "
                            f"wall {rec['wall']:.9f}")
        summary = eng.obs.attribution_summary()
        tot = summary["totals"]
        comp = (tot["sched_s"] + tot["device_s"] + tot["draft_s"]
                + tot["host_s"])
        if abs(comp - tot["wall_s"]) > 1e-9 + 1e-6 * tot["wall_s"]:
            fail(cname, f"totals: components {comp:.9f} != "
                        f"wall {tot['wall_s']:.9f}")
        measured = set(summary["families"])
        modelled = set(eng.cost_model.families)
        if not measured <= modelled:
            fail(cname, f"families outside the warmup cost model: "
                        f"{sorted(measured - modelled)}")
        if not (0 < summary.get("mfu", 0) < 1):
            fail(cname, f"mfu out of range: {summary.get('mfu')}")

        with tempfile.TemporaryDirectory() as tmp:
            tel = eng.telemetry(report=f"{tmp}/drain")
            prom = open(tel["report"]["prom"]).read()
            page = open(tel["report"]["html"]).read()
        for p in lint_prometheus(prom):
            fail(cname, f"prometheus lint: {p}")
        for marker in ("Attribution waterfall", "Per-family predicted vs",
                       "Latency percentiles", "Alerts"):
            if marker not in page:
                fail(cname, f"HTML report missing {marker!r}")
        if "<script" in page or "http://" in page or "https://" in page:
            fail(cname, "HTML report is not self-contained")

        print(f"  ok    {cname}: {tot['steps']} steps, "
              f"{len(measured)} families, mfu {summary['mfu']:.2e}, "
              f"prom {len(prom)} B, html {len(page)} B")

    if failures:
        print(f"report_smoke: {failures} failure(s)")
        return 1
    print("report_smoke: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
