#!/usr/bin/env python
"""Seeded fault-plan smoke on the port: chaos-vs-clean identity + allocator
balance (the port's counterpart of ``scripts/chaos_smoke.py``, with its
configurations, plans and request mix).

Run via ``scripts/torch/tier1.sh --chaos`` or directly with
``PYTHONPATH=src``.  For each engine configuration, drains a small
deterministic request mix once cleanly and once under each seeded
:class:`FaultPlan` (an OutOfPages spike, a drafter failure burst mid-spec,
a NaN-logit injection, a page-copier failure), then checks **identity
under chaos**:

  * every surviving request's tokens are bit-identical to the clean run
    (quarantined ``error`` rows are the only permitted casualties);
  * the allocator is balanced afterwards (ledger audit clean, no retired
    rid holding pages, live pages == cache-held pages);
  * no new step signature after warmup, faults included (on the card: no
    CUDA graph captured during the drain).

Exits 1 on any mismatch, printing the offending config/plan/rid.

    PYTHONPATH=src python scripts/torch/chaos_smoke.py               # the card
    PYTHONPATH=src python scripts/torch/chaos_smoke.py --device cpu
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

CONFIGS = {
    "chunked": dict(chunk_tokens=8, flat=False),
    "flat-spec-cache": dict(chunk_tokens=8, spec_tokens=3,
                            prefix_cache=True),
}

PLANS = {
    "oom-spike": [(0, "oom"), (1, "oom"), (2, "oom")],
    "drafter-burst": [(s, "drafter") for s in (1, 2, 3, 5, 7)],
    "nan-logits": [(3, "nan")],
    "copier-failure": [(1, "copier"), (3, "copier")],
}


def _requests(vocab, seed=7):
    rng = np.random.Generator(np.random.Philox(seed))
    lens, news = [5, 11, 8, 3], [6, 4, 9, 7]
    return [(rng.integers(1, vocab, size=l).astype(np.int32), n)
            for l, n in zip(lens, news)]


def _drain(engine, reqs, plan=None, *, greedy=True, seed=0):
    for prompt, n in reqs:
        engine.add_request(prompt, n)
    if plan is None:
        fin = engine.drain(greedy=greedy, seed=seed)
    else:
        with plan.on(engine):
            fin = engine.drain(greedy=greedy, seed=seed)
    return {r.rid: (list(r.out_tokens), r.finish_reason) for r in fin}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions); "
                         "without a card cuda raises")
    args = ap.parse_args(argv)

    from repro_torch.analysis.aliasing import check_pool_consistency
    from repro_torch.analysis.runner import build_model
    from repro_torch.core.hardware import require_device
    from repro_torch.kernels.ragged_attn.ops import HEAD_WIDTHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import FaultEvent, FaultPlan

    device = require_device(args.device)
    # the JAX script's reduced model; on the card with heads 64 wide, the
    # narrowest the ragged attention kernel takes (its heads are 16 wide)
    model, params = build_model(
        slots=3, device=device,
        d_head=HEAD_WIDTHS[0] if device.type == "cuda" else None)
    reqs = _requests(model.cfg.vocab)
    failures = 0
    print(f"chaos smoke on {device.type}: {model.cfg.name}, "
          f"{len(CONFIGS)} configurations x {len(PLANS)} plans")

    for cname, kwargs in CONFIGS.items():
        clean_eng = Engine(model, params, device=device, max_slots=3, **kwargs)
        clean = _drain(clean_eng, reqs)
        for pname, events in PLANS.items():
            eng = Engine(model, params, device=device, max_slots=3, **kwargs)
            eng.warmup()
            traces = sum(model.trace_counts.values())
            captures = sum(eng.stats()["captures"].values())
            plan = FaultPlan([FaultEvent(s, k) for s, k in events])
            out = _drain(eng, reqs, plan)
            here = f"{cname} / {pname}"

            survivors = casualties = 0
            for rid, (toks, reason) in sorted(out.items()):
                if reason == "error":
                    casualties += 1
                    continue
                survivors += 1
                if (toks, reason) != clean[rid]:
                    print(f"FAIL {here}: rid {rid} diverged — "
                          f"{(toks, reason)} != clean {clean[rid]}")
                    failures += 1
            if set(out) != set(clean):
                print(f"FAIL {here}: lost requests "
                      f"{sorted(set(clean) - set(out))}")
                failures += 1
            for f in check_pool_consistency(eng, here):
                print(f"FAIL {here}: allocator audit: {f.message}")
                failures += 1
            live = sum(len(s.pages) for s in eng.pool.sequences())
            cached = (len(set(eng.prefix_cache.pages()))
                      if eng.prefix_cache is not None else 0)
            if eng.pool.num_used != cached or live != cached:
                print(f"FAIL {here}: allocator unbalanced "
                      f"(used={eng.pool.num_used}, live={live}, "
                      f"cached={cached})")
                failures += 1
            retraces = sum(model.trace_counts.values()) - traces
            recaptures = sum(eng.stats()["captures"].values()) - captures
            if retraces or recaptures:
                print(f"FAIL {here}: {retraces} new step signatures, "
                      f"{recaptures} graph captures after warmup")
                failures += 1
            res = eng.stats()["resilience"]
            print(f"ok   {here}: {survivors} identical survivors, "
                  f"{casualties} quarantined, fired={plan.fired}, "
                  f"quarantines={res['quarantines']}, "
                  f"spec_auto_disables={res['spec_auto_disables']}")

    if failures:
        print(f"chaos smoke: {failures} failure(s)")
        return 1
    print("chaos smoke: identity under chaos holds; allocator balanced; "
          "zero post-warmup traces")
    return 0


if __name__ == "__main__":
    sys.exit(main())
