"""Serving launcher: continuous-batching generation through one of the
engine's three step families.

Requests with mixed prompt lengths (drawn from ``--seed`` between
``--min-prompt`` and ``--max-prompt``) each ask for ``--new`` tokens; the
engine admits them into slots over a paged KV cache and drains them.
Weights are random, drawn from ``--seed``.  The family:

- no ``--chunk-tokens``: the monolithic step (each admission prefilled
  alone, then a ``[slots, 1]`` decode step), as the JAX launcher serves;
- ``--chunk-tokens C``: the flat token-level step;
- ``--chunk-tokens C --no-flat``: the dense chunked ``[slots, s]`` step.

``--eager`` reserves each request's whole KV lifetime at admission.  The
other defaults are the requests of ``chip_smoke.py``'s drains: 8
requests, prompts of 64-512 tokens, 32 new tokens each, 4 slots, seq_len
1024 (its flat drain adds ``--chunk-tokens 128``).  The engine warms up
first: on the card it captures one CUDA graph per step shape, and every
step of the drain replays one.

Usage (on a machine with a CUDA card; ``--device cpu`` runs the kernels'
plain versions instead):
    PYTHONPATH=src python -m repro_torch.launch.serve --chunk-tokens 128
``--profile trace.json`` traces the drain with ``torch.profiler`` and
prints the device time of each kernel (those of graph replays included),
the device's idle share, and the port's kernel launches the trace saw
beside those the wrappers' counts give.
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine


def _timed_drain(engine: Engine):
    t0 = time.perf_counter()
    finished = engine.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return finished, time.perf_counter() - t0


# the port's CUDA kernels by symbol (csrc/*.cu), named as their wrappers
_PORT_KERNEL = re.compile(r"::(mmt4d|pack|unpack|ragged_attn)(?:_bf16|_f32)?_kernel\b")


def _print_device_time(prof, wall: float, counted: dict) -> None:
    """Device time by kernel over the traced drain, then summed for each of
    the port's kernels and for PyTorch's own, and the device's busy share
    of its wall time (kernels run on one stream, so they do not overlap).
    ``counted``: the port's launches over the drain by the wrappers'
    counts; the trace must have seen as many, or its device time misses
    the kernels of graph replays."""
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"[profile] wall {wall:.6f} s, device busy {busy:.6f} s "
          f"({100 * busy / wall:.2f}%), idle {100 * (1 - busy / wall):.2f}%")
    for e in rows[:12]:
        t = e.self_device_time_total / 1e6
        print(f"[profile] {t:.6f} s {100 * t / wall:6.2f}% of wall "
              f"{e.count:>7} calls  {e.key[:90]}")
    sums: dict = {}
    for e in rows:
        m = _PORT_KERNEL.search(e.key)
        t, n = sums.get(m.group(1) if m else "pytorch", (0.0, 0))
        sums[m.group(1) if m else "pytorch"] = (t + e.self_device_time_total / 1e6,
                                                n + e.count)
    for name, (t, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] total {name}: {t:.6f} s ({100 * t / busy:.1f}% of "
              f"device time), {n} launches")
    seen = {k: n for k, (_, n) in sums.items() if k != "pytorch"}
    for name, n in counted.items():
        print(f"[profile] {name}: {seen.get(name, 0)} launches in the trace, "
              f"{n} by the wrappers' counts"
              + ("" if seen.get(name, 0) == n else
                 " (MISMATCH: the trace does not hold every kernel the card "
                 "ran)"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm2-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--min-prompt", type=int, default=64)
    ap.add_argument("--max-prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="the chunked policy's chunk (flat step); without "
                         "it the monolithic step")
    ap.add_argument("--no-flat", action="store_true",
                    help="with --chunk-tokens: the dense chunked step")
    ap.add_argument("--eager", action="store_true",
                    help="reserve each request's full KV lifetime at "
                         "admission")
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None, metavar="TRACE_JSON",
                    help="trace the drain with torch.profiler, write the "
                         "Chrome trace here and print device time by kernel")
    args = ap.parse_args(argv)
    if args.no_flat and args.chunk_tokens is None:
        ap.error("--no-flat needs --chunk-tokens (the dense chunked step)")
    if args.profile and args.device != "cuda":
        ap.error("--profile measures the card's device time: it needs "
                 "--device cuda")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = RunConfig(param_dtype=args.dtype, compute_dtype=args.dtype)
    model = build_model(cfg, run, ShapeSpec("serve", args.max_len, args.slots,
                                            "decode"), device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    engine = Engine(model, params, device=args.device, max_slots=args.slots,
                    page_tokens=args.page_tokens, num_pages=args.pool_pages,
                    chunk_tokens=args.chunk_tokens,
                    flat=False if args.no_flat else None, eager=args.eager)
    family = ("flat" if engine.flat else "dense chunked" if engine.chunked
              else "monolithic")
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine.warmup()
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = engine.stats()["compiles"]
    kept = ""
    if cuda:      # the graphs' pool, which empty_cache cannot release
        torch.cuda.empty_cache()
        kept = (f", {(torch.cuda.memory_reserved() - reserved) / 2**20:.1f} "
                f"MiB kept (graph pool and buffers)")
    print(f"[serve] {family} step; warmup {warm_s:.3f} s, "
          f"{sum(warm.values())} programs {warm}{kept}")

    rng = np.random.default_rng(args.seed)
    for plen in rng.integers(args.min_prompt, args.max_prompt + 1, args.requests):
        engine.add_request(rng.integers(0, cfg.vocab, int(plen)), args.new)
    kernels.reset_launch_counts()
    if args.profile:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            finished, wall = _timed_drain(engine)
        prof.export_chrome_trace(args.profile)
        _print_device_time(prof, wall, {k: v for k, v in
                                        kernels.launch_counts().items() if v})
    else:
        finished, wall = _timed_drain(engine)
    if engine.stats()["compiles"] != warm:
        raise RuntimeError(f"the drain made new programs after warmup: "
                           f"{warm} -> {engine.stats()['compiles']}")
    total = sum(len(r.out_tokens) for r in finished)
    print(f"[serve] {cfg.name} on {engine.device}: {len(finished)} requests, "
          f"{total} tokens in {wall:.6f} s ({total / wall:.4f} tokens/s), "
          f"{engine.stats()['steps']} steps, "
          f"{1e3 * wall / max(1, engine.stats()['steps']):.3f} ms per step "
          f"(paged KV: {engine.pool.page_tokens} tok/page, "
          f"{engine.pool.num_pages} pages, peak {engine.pool.peak_used} used, "
          f"{engine.num_preemptions} preemptions)")
    for r in sorted(finished, key=lambda r: r.rid)[:8]:
        print(f"  rid={r.rid} prompt={r.prompt_len:>3} new={len(r.out_tokens):>3} "
              f"[{r.finish_reason}] {r.out_tokens[:8]}")
    return finished


if __name__ == "__main__":
    main()
