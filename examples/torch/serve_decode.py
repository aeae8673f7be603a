"""Ragged-arrival serving example on the PyTorch/CUDA port: continuous
batching over a paged KV cache with pre-packed weights (the paper's
amortized standalone packing, §4.1).  ``examples/serve_decode.py`` is the
JAX package's; this file keeps its flags, trace and printed lines.

Requests with mixed prompt lengths and budgets arrive over time; the engine
admits each into a free decode slot as soon as one opens (no lock-step
batch), allocates KV pages *lazily* as sequences grow (tile-aligned to the
active packed layout), and retires each request the step it completes.  With
``--pool-pages`` set below the working set, the scheduler preempts the
youngest request on exhaustion and recomputes it: outputs are unchanged.
With ``--chunk-tokens`` (pure-attention models), prefill fuses into the
flat decode step under a per-step token budget, again without changing a
token.  With ``--spec-tokens k``, a prompt-lookup n-gram drafter rides up
to k guesses per decode row through the same fused step and the engine
accepts the prefix the target model agrees with: the same tokens, greedy
or sampled.  With ``--prefix-cache``, every request shares one system
prompt and the layout-keyed prefix cache serves the shared pages: later
arrivals prefill only their own suffix, and not a token changes against
the same trace without the cache.  ``--queue-limit`` sheds arrivals past
the queue's depth as typed ``rejected`` rows; ``--deadline`` gives each
request an SLO on the trace clock (``timeout`` when overrun).

``--trace-out`` / ``--metrics-json`` / ``--report`` run the drain with the
:mod:`repro_torch.obs` telemetry live (a Chrome trace, the metrics
registry snapshot, the HTML report with its Prometheus text beside it);
telemetry is host-side only, the tokens are identical with it on or off.

On the card every step is a replay of a CUDA graph captured at its
signature's first call, through the hand-written kernels (mmt4d, pack,
unpack and, in the flat step, ragged attention).  The prompts are the JAX
example's ``jax.random.randint`` draws (``sampling.randint``); the
encdec/vlm static path's frames and patches its ``jax.random.normal``
draws (``sampling.normal``).

Run:  PYTHONPATH=src python examples/torch/serve_decode.py            # the card
CPU:                       ... serve_decode.py --device cpu
Fused:                     ... serve_decode.py --chunk-tokens 16
Speculative:               ... serve_decode.py --spec-tokens 3
Prompt caching:            ... serve_decode.py --prefix-cache
Overload:                  ... serve_decode.py --queue-limit 2 --deadline 8
Telemetry:                 ... serve_decode.py --trace-out serve.json
"""

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import require_device
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import fold_in, normal, prng_key, randint


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm2-135m")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="KV pool size in pages (default: ample); small "
                    "values exercise preemption-by-recomputation")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="fuse prefill into the decode step in chunks of "
                    "this many tokens (pure-attention models; rounded up "
                    "to the layout m_r)")
    ap.add_argument("--spec-tokens", type=int, default=None,
                    help="speculative decode with an n-gram (prompt-lookup) "
                    "drafter proposing up to this many tokens per decode "
                    "row (pure-attention models; outputs are unchanged)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests via the layout-"
                    "keyed prefix cache (pure-attention models); the trace "
                    "prepends a common system prompt so later arrivals hit "
                    "the cache; outputs are unchanged, prefill work drops")
    ap.add_argument("--sys-tokens", type=int, default=32,
                    help="shared system-prompt length for --prefix-cache")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the wait queue: arrivals past this depth "
                    "are shed as typed 'rejected' rows (admission control)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLO on the trace clock (1 tick per "
                    "step): requests still unfinished this long after "
                    "arrival finish as 'timeout' with their pages released")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="run with telemetry on and write a Chrome "
                    "trace_event JSON (Perfetto / chrome://tracing) of "
                    "the drain")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="run with telemetry on and dump the streaming-"
                    "metrics registry snapshot as JSON")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="run with telemetry on and write the single-file "
                    "HTML attribution report plus the Prometheus text "
                    "exposition next to it (.prom)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT SLO target in seconds: arms the slo-burn "
                    "monitor and defines goodput for first tokens")
    ap.add_argument("--slo-itl", type=float, default=None,
                    help="ITL SLO target in seconds (slo-burn monitor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels and graphs) or cpu (their "
                    "plain versions); without a card cuda raises")
    return ap.parse_args(argv)


def make_trace(args, vocab: int, shared_prefix: bool) -> list:
    """The JAX example's ragged arrival trace: request i arrives at tick
    2*i with a prompt drawn under ``fold_in(PRNGKey(1), i)``, lengths and
    budgets from ``default_rng(1)``; with ``shared_prefix`` each prompt
    starts with one ``--sys-tokens`` system prompt."""
    rng = np.random.default_rng(1)
    key = prng_key(1)
    sysp = (randint(key, (args.sys_tokens,), 0, vocab) if shared_prefix
            else np.zeros((0,), np.int32))
    trace = []
    for i in range(args.requests):
        plen = int(rng.integers(2, args.max_prompt + 1))
        prompt = randint(fold_in(key, i), (plen,), 0, vocab)
        trace.append((2.0 * i, np.concatenate([sysp, prompt]),
                      int(rng.integers(2, args.new_tokens + 1))))
    return trace


def _static(engine, cfg, args, device, log) -> dict:
    """encdec/vlm: the static batch loop over the JAX example's batch."""
    key = prng_key(1)
    batch = {"tokens": randint(key, (args.slots, args.max_prompt), 0, cfg.vocab)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(normal(
            key, (args.slots, args.max_len // cfg.audio_downsample,
                  cfg.d_model))).to(device)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(normal(
            key, (args.slots, cfg.vision_tokens, cfg.d_model))).to(device)
    out = np.asarray(engine.generate_static(batch, args.new_tokens,
                                            greedy=not args.sample))
    log(f"[serve] {cfg.name} (static batch): generated {out.shape}")
    log(out[:, :12])
    return {"engine": engine, "static": out}


def serve(cfg, args, params=None, device="cuda", log=print,
          shared_prefix: Optional[bool] = None,
          on_engine: Optional[Callable] = None) -> dict:
    """Serve the trace of ``args`` (:func:`parse_args`) with ``cfg`` in
    float32 on ``device``: the weights are ``params``, or the model's init
    from ``torch.Generator().manual_seed(0)`` (a CPU generator: the same
    weights on either device).  ``shared_prefix`` (default
    ``args.prefix_cache``) prepends the system prompt, so a run without
    the cache can serve the cache's trace; ``on_engine(engine)`` is called
    before the first request (a caller's recorders).  Returns the engine,
    the finished requests (by rid) and the stats."""
    device = require_device(device)
    shared_prefix = args.prefix_cache if shared_prefix is None else shared_prefix
    want_obs = (args.trace_out is not None or args.metrics_json is not None
                or args.report is not None or args.slo_ttft is not None
                or args.slo_itl is not None)
    shape = ShapeSpec("serve", args.max_len, args.slots, "decode")
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat=False)
    model = build_model(cfg, run, shape, device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))

    engine = Engine(model, params, device=device,   # weights pre-packed
                    max_slots=args.slots, num_pages=args.pool_pages,
                    chunk_tokens=args.chunk_tokens,
                    spec_tokens=args.spec_tokens,
                    prefix_cache=args.prefix_cache,
                    queue_limit=args.queue_limit,
                    telemetry=want_obs)
    if want_obs and engine.continuous:
        engine.obs.monitors.slo_ttft_s = args.slo_ttft
        engine.obs.monitors.slo_itl_s = args.slo_itl
        # warmup builds the per-family roofline cost model the attribution
        # report prices padding waste / MFU / MBU against
        engine.warmup()
    if on_engine is not None:
        on_engine(engine)
    if not engine.continuous:
        return _static(engine, cfg, args, device, log)

    # feed each request in as its arrival tick passes, so --queue-limit
    # sheds against the queue the server has at that moment; every add
    # happens in an iteration that also steps, so shed rows are collected
    trace = make_trace(args, cfg.vocab, shared_prefix)
    t0 = time.perf_counter()
    pending = list(trace)
    clock, finished = 0.0, []
    while pending or engine.scheduler.has_work:
        while pending and pending[0][0] <= clock:
            arrival, prompt, max_new = pending.pop(0)
            engine.add_request(prompt, max_new, arrival=arrival,
                               deadline_s=args.deadline)
        finished += engine.step(now=clock, greedy=not args.sample)
        clock += 1.0
    dt = time.perf_counter() - t0

    total = sum(len(r.out_tokens) for r in finished)
    st = engine.pool.stats()
    es = engine.stats()
    mode = (f"fused chunk={engine.chunk_tokens}" if engine.chunked
            else "monolithic prefill")
    if engine.spec_tokens is not None:
        mode += f" + spec k={engine.spec_tokens}"
    if engine.prefix_cache is not None:
        mode += " + prefix cache"
    log(f"[serve] {cfg.name}: {len(finished)} ragged requests ({mode}), "
        f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on "
        f"{device.type}; page={st['page_tokens']} tok — m_r-aligned; "
        f"peak {st['peak_used']}/{st['num_pages'] - 1} pages, "
        f"{engine.num_preemptions} preemptions, "
        f"{engine.num_pauses} prefill pauses)")
    log(f"[serve] stats: {es['steps']} steps @ {es['mean_step_ms']:.2f} ms, "
        f"occupancy {es['mean_slot_occupancy']:.2f}, "
        f"{es['mixed_steps']} mixed steps, "
        f"{es['prefill_stall_steps']} prefill-stall steps, "
        f"{es['chunks_per_prompt']:.2f} chunks/prompt, "
        f"compiles {es['compiles']}")
    if "prefix_cache" in es:
        pc = es["prefix_cache"]
        log(f"[serve] prefix cache: hit rate {pc['hit_rate']:.2f} "
            f"({pc['hits']}/{pc['lookups']} lookups, "
            f"{pc['hit_tokens']} prompt tokens served from cache), "
            f"prefill computed {es['prefill_tokens']} tokens, "
            f"{pc['entries']} cached pages "
            f"({pc['shared_pages']} currently shared), "
            f"{pc['cow_copies']} CoW copies, {pc['evictions']} evictions")
    res = es["resilience"]
    log(f"[serve] resilience: {res['sheds']} shed "
        f"(queue_limit={res['queue_limit']}), {res['timeouts']} timeouts "
        f"(deadline={args.deadline}), {res['cancels']} cancels, "
        f"{res['quarantines']} quarantined, "
        f"{res['drafter_errors']} drafter errors "
        f"({res['spec_auto_disables']} spec auto-disables), "
        f"{res['watchdog_trips']} watchdog trips")
    if "speculative" in es:
        sp = es["speculative"]
        log(f"[serve] speculation: accepted {sp['accepted']}/{sp['drafted']} "
            f"drafts ({sp['acceptance_rate']:.2f}), "
            f"{sp['decode_tokens_per_row_step']:.2f} decode tokens/row-step, "
            f"{sp['accepted_per_step']:.2f} accepted/step, "
            f"draft overhead {sp['draft_overhead']:.2f}, "
            f"{sp['rollback_pages']} pages rolled back "
            f"({sp['drafter']})")
    tel = None
    if want_obs:
        tel = engine.telemetry(report=args.report)
        _print_telemetry(engine, es, tel, args, log)
    for r in sorted(finished, key=lambda r: r.rid):
        log(f"  rid={r.rid} arrive@{r.arrival:>4.0f} prompt={r.prompt_len:>3} "
            f"-> {len(r.out_tokens):>2} tokens ({r.finish_reason}): "
            f"{r.out_tokens[:10]}")
    return {"engine": engine, "stats": es, "telemetry": tel, "seconds": dt,
            "finished": {r.rid: r for r in finished}}


def _print_telemetry(engine, es, tel, args, log) -> None:
    slo = es["slo"]
    log(f"[serve] slo: goodput {slo['goodput_tokens']}/"
        f"{slo['tokens_out']} tokens inside deadline "
        f"({slo['goodput_ratio']:.2f}), p99s: "
        f"ttft {slo['ttft_p99_s']:.4f}s, itl {slo['itl_p99_s']:.4f}s, "
        f"e2e {slo['e2e_p99_s']:.4f}s")
    at = tel["attribution"]
    if "mfu" in at:
        t = at["totals"]
        log(f"[serve] attribution: wall {t['wall_s']:.3f}s = "
            f"sched {t['sched_s']:.3f} + device {t['device_s']:.3f} "
            f"+ draft {t['draft_s']:.3f} + host {t['host_s']:.3f}; "
            f"mfu {at['mfu']:.2e}, mbu {at['mbu']:.2e}, "
            f"padding waste {at['padding_waste_ratio']:.2f} of "
            f"device, roofline fraction {at['roofline_fraction']:.3f}")
    if tel["alerts"]:
        log(f"[serve] alerts ({len(tel['alerts'])}):")
        for a in tel["alerts"]:
            log(f"  [{a['severity']}] {a['kind']} @ step {a['step']}: "
                f"{a['message']}")
    if args.report:
        log(f"[serve] report -> {tel['report']['html']} + "
            f"{tel['report']['prom']}")
    log("[serve] latency percentiles (s):")
    log(f"  {'':<14}{'count':>6}{'p50':>10}{'p95':>10}{'p99':>10}{'max':>10}")
    for name, snap in tel["latency"].items():
        log(f"  {name:<14}{snap['count']:>6}{snap['p50']:>10.4f}"
            f"{snap['p95']:>10.4f}{snap['p99']:>10.4f}{snap['max']:>10.4f}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(tel["metrics"], f, indent=2, sort_keys=True)
        log(f"[serve] metrics snapshot -> {args.metrics_json}")
    if args.trace_out:
        engine.obs.export_trace(args.trace_out)
        n = len(engine.obs.tracer.events())
        log(f"[serve] Perfetto trace ({n} events) -> {args.trace_out}")


def main(argv=None) -> int:
    args = parse_args(argv)
    serve(reduced_config(get_config(args.arch)), args, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
