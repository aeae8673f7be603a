"""Serving launcher: continuous-batching generation through one of the
engine's three step families, or the static batch loop.

Requests with mixed prompt lengths (drawn from ``--seed`` between
``--min-prompt`` and ``--max-prompt``) each ask for ``--new`` tokens; the
engine admits them into slots over a paged KV cache and drains them.
Weights are random, drawn from ``--seed``.  The family:

- no ``--chunk-tokens``: the monolithic step (each admission prefilled
  alone, then a ``[slots, 1]`` decode step), as the JAX launcher serves;
- ``--chunk-tokens C``: the flat token-level step;
- ``--chunk-tokens C --no-flat``: the dense chunked ``[slots, s]`` step.

``--arch`` takes every registered architecture (the dense, vlm, encdec,
ssm, moe and hybrid families); ``--layers`` cuts its depth (no moe config
fits one card whole: ``--arch qwen3-moe-235b-a22b --layers 8``, ``--arch
arctic-480b --layers 1``, ``--arch jamba-v0.1-52b --layers 16``).  A
hybrid's weights and caches are stacked per position of its layer
period (jamba's 8: seven mamba mixers and attention at index 4, moe on
every second layer), so ``--layers`` must be a whole number of periods.
A moe model prints the drain's dropped fraction (of the real tokens'
assignments: ``moe.DropCounter``).  A recurrent model (``--arch
rwkv6-1.6b``, jamba) is served by the monolithic step only:
``--chunk-tokens`` raises, with the engine's reason.  Its prompts prefill
at exact lengths, each length making its program (on the card, its
graph) at its first prefill, so the launcher serves the requests once
before the timed drain, which then replays.
``--static`` serves one batch of ``--slots`` prompts of ``--prompt-len``
tokens in lock step through ``Engine.generate_static`` (the dense-cache
decode step); a static family is served only so: encdec
(``--arch whisper-small``) with frame embeddings ``[slots, max_len / 4,
d]``, vlm (``--arch internvl2-26b``) with patch embeddings ``[slots,
vision_tokens, d]`` before the prompt, each drawn from ``--seed``.  It
runs the batch twice: the first call makes the step's programs (on the
card, captures its two graphs), the second is timed and must make none.

``--policy`` picks the layout policy (``scalable``, the default;
``fixed``; ``unpacked``, plain ``torch.matmul`` with no mmt4d, pack or
unpack) and ``$REPRO_HW`` the hardware descriptor whose tiles the layout
takes (``h100``, ``h100_vl256``, ``h100_vl512`` on the card; ``tpu_v5e``,
``tpu_vl256``, ``tpu_vl512`` ... on the CPU); the launcher prints the
descriptor and its tiles.

``--eager`` reserves each request's whole KV lifetime at admission.  The
other defaults are the requests of ``chip_smoke.py``'s drains: 8
requests, prompts of 64-512 tokens, 32 new tokens each, 4 slots, seq_len
1024 (its flat drain adds ``--chunk-tokens 128``).  The engine warms up
first: on the card it captures one CUDA graph per step shape, and every
step of the drain replays one.

Weights are drawn on the device the model runs on (a card's own
generator, so a model of billions of parameters starts in seconds) and
packed as they are drawn (``prepack_params(..., consume=True)``), so the
unpacked and the packed weights never fill the card side by side.

Usage (on a machine with a CUDA card; ``--device cpu`` runs the kernels'
plain versions instead):
    PYTHONPATH=src python -m repro_torch.launch.serve --chunk-tokens 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --chunk-tokens 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b --layers 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --layers 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
        --layers 8 --chunk-tokens 128
    REPRO_HW=h100_vl512 PYTHONPATH=src python -m repro_torch.launch.serve \
        --chunk-tokens 128 --policy fixed
``--profile trace.json`` traces the drain with ``torch.profiler`` and
prints the device time of each kernel (those of graph replays included),
the device's idle share, and the port's kernel launches the trace saw
beside those the wrappers' counts give.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import (ARCHS, RunConfig, ShapeSpec, get_config,
                                 reduced_config)
from repro_torch.core.linear import prepack_params
from repro_torch.models.model import build_model
from repro_torch.models.moe import DropCounter
from repro_torch.models.transformer import pattern_period
from repro_torch.serving.engine import Engine


# the architectures the launcher serves: every registered one
SERVABLE = list(ARCHS)


def describe_hw(model) -> str:
    """The model's descriptor, policy and tiles, as the launchers print it."""
    lay = model.ctx.layout(model.compute_dtype)
    return (f"hardware {model.ctx.hw.name}, policy {lay.policy.value}, tiles "
            f"(m_r, n_r, k_r) = ({lay.m_r}, {lay.n_r}, {lay.k_r}) in "
            f"{lay.dtype}")


def _timed_drain(engine: Engine):
    t0 = time.perf_counter()
    finished = engine.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return finished, time.perf_counter() - t0


# the port's CUDA kernels by symbol (csrc/*.cu), named as their wrappers
# (wkv6 has a one-token kernel beside its chunked one); mmt4d's gradient
# products share one kernel per dtype, whose first template argument is
# true for wgrad; the recurrences' backward wrappers launch a second
# kernel each, the sum of their blocks' partials (``<name>_sum``), which
# their launch counts leave out
_PORT_KERNEL = re.compile(
    r"::(mmt4d|pack|unpack|ragged_attn|wkv6_bwd_sum|wkv6_bwd|wkv6|"
    r"selective_scan_bwd_sum|selective_scan_bwd|selective_scan)"
    r"(?:_bf16|_f32|_decode)?_kernel\b")
_GRAD_KERNEL = re.compile(r"::packed_gemm(?:_wgmma)?_kernel<(true|false)\b")


def port_kernel(symbol: str) -> str:
    """The wrapper name of the port kernel behind a profiled symbol, or
    "pytorch" for PyTorch's own."""
    m = _PORT_KERNEL.search(symbol)
    if m:
        return m.group(1)
    m = _GRAD_KERNEL.search(symbol)
    if m:
        return "mmt4d_wgrad" if m.group(1) == "true" else "mmt4d_dgrad"
    return "pytorch"


def print_device_time(prof, wall: float, counted: dict, tag: str = "profile") -> dict:
    """Device time by kernel over the traced drain, then summed for each of
    the port's kernels and for PyTorch's own, and the device's busy share
    of its wall time (kernels run on one stream, so they do not overlap).
    ``counted``: the port's launches over the drain by the wrappers'
    counts; the trace must have seen as many, or its device time misses
    the kernels of graph replays.  Returns the port's launches the trace
    saw, by kernel."""
    # (a scheduled profile's ProfilerStep annotations span whole steps)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"[{tag}] wall {wall:.6f} s, device busy {busy:.6f} s "
          f"({100 * busy / wall:.2f}%), idle {100 * (1 - busy / wall):.2f}%")
    for e in rows[:12]:
        t = e.self_device_time_total / 1e6
        print(f"[{tag}] {t:.6f} s {100 * t / wall:6.2f}% of wall "
              f"{e.count:>7} calls  {e.key[:90]}")
    sums: dict = {}
    for e in rows:
        name = port_kernel(e.key)
        t, n = sums.get(name, (0.0, 0))
        sums[name] = (t + e.self_device_time_total / 1e6, n + e.count)
    for name, (t, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}] total {name}: {t:.6f} s ({100 * t / busy:.1f}% of "
              f"device time), {n} launches")
    seen = {k: n for k, (_, n) in sums.items() if k != "pytorch"}
    for name, n in counted.items():
        print(f"[{tag}] {name}: {seen.get(name, 0)} launches in the trace, "
              f"{n} by the wrappers' counts"
              + ("" if seen.get(name, 0) == n else
                 " (MISMATCH: the trace does not hold every kernel the card "
                 "ran)"))
    return seen


def static_batch(cfg, args) -> dict:
    """The static batch: ``--slots`` prompts of ``--prompt-len`` tokens
    and, for encdec, frame embeddings, for vlm patch embeddings, drawn
    from ``--seed``."""
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (args.slots, args.prompt_len),
                                    dtype=np.int32)}
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(args.seed + 1)
        batch["frames"] = torch.randn(
            (args.slots, args.max_len // cfg.audio_downsample, cfg.d_model),
            generator=gen)
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(args.seed + 1)
        batch["patches"] = torch.randn(
            (args.slots, cfg.vision_tokens, cfg.d_model), generator=gen)
    return batch


def serve_static(model, params, args) -> np.ndarray:
    """Serve one static batch twice through ``generate_static``; the
    second call is timed (traced with ``--profile``) and must make no
    program and capture no graph."""
    cfg = model.cfg
    engine = Engine(model, params, device=args.device, max_slots=args.slots)
    batch = static_batch(cfg, args)
    cuda = engine.device.type == "cuda"
    t0 = time.perf_counter()
    first = engine.generate_static(batch, args.new)
    warm_s = time.perf_counter() - t0
    made = (dict(model.trace_counts), dict(engine._graphs.captures))
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.synchronize()
    if args.profile:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = engine.generate_static(batch, args.new)
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(args.profile)
        print_device_time(prof, wall, {k: v for k, v in
                                        kernels.launch_counts().items() if v})
    else:
        t0 = time.perf_counter()
        out = engine.generate_static(batch, args.new)
        wall = time.perf_counter() - t0
    if (dict(model.trace_counts), dict(engine._graphs.captures)) != made:
        raise RuntimeError(f"the second static batch made programs or "
                           f"graphs: {made} -> {model.trace_counts}, "
                           f"{engine._graphs.captures}")
    if not np.array_equal(out, first):
        raise RuntimeError("two static batches of the same inputs differ")
    total = out.size
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    print(f"[serve] {cfg.name} (static) on {engine.device}: batch "
          f"{args.slots} x prompt {args.prompt_len}, {args.new} new; first "
          f"call {warm_s:.3f} s (programs {made[0]['decode']}, graphs "
          f"{made[1]['decode']}); second {wall:.6f} s, "
          f"{total / wall:.4f} tokens/s, launches {launches}")
    print(out[:, :16])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm2-135m", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--policy", default="scalable",
                    choices=["scalable", "fixed", "unpacked"],
                    help="the layout policy; the descriptor comes from "
                         "$REPRO_HW (the device's own without it)")
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
    ap.add_argument("--static", action="store_true",
                    help="the static batch loop (generate_static); always "
                         "for a static family (encdec)")
    ap.add_argument("--prompt-len", type=int, default=256,
                    help="the static batch's shared prompt length")
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
        cfg = reduced_config(cfg, layers=args.layers)
    elif args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    try:
        pattern_period(cfg)
    except ValueError as e:
        ap.error(f"--layers {cfg.n_layers}: {e} (the weights and caches are "
                 f"stacked per period position: cut the depth in whole periods)")
    run = RunConfig(param_dtype=args.dtype, compute_dtype=args.dtype,
                    layout_policy=args.policy)
    model = build_model(cfg, run, ShapeSpec("serve", args.max_len, args.slots,
                                            "decode"), device=args.device)
    print(f"[serve] {describe_hw(model)}")
    params = prepack_params(
        model.init(torch.Generator(device=model.device).manual_seed(args.seed)),
        model.ctx, consume=True)
    if args.static or cfg.family in ("encdec", "vlm"):
        return serve_static(model, params, args)
    engine = Engine(model, params, device=args.device, max_slots=args.slots,
                    page_tokens=args.page_tokens, num_pages=args.pool_pages,
                    chunk_tokens=args.chunk_tokens,
                    flat=False if args.no_flat else None, eager=args.eager)
    family = ("flat" if engine.flat else "dense chunked" if engine.chunked
              else "monolithic")
    cuda = engine.device.type == "cuda"
    drops = DropCounter(engine.device).install() if cfg.moe else None
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
    prompts = [rng.integers(0, cfg.vocab, int(plen)) for plen in
               rng.integers(args.min_prompt, args.max_prompt + 1, args.requests)]
    exact = not engine.chunked and engine._bucket == 1
    if exact:
        # each prompt length makes its prefill's program at its first use
        for p in prompts:
            engine.add_request(p, args.new)
        t0 = time.perf_counter()
        engine.drain()
        warm = engine.stats()["compiles"]
        print(f"[serve] exact-length prefills: a first pass over the "
              f"requests made {sum(warm.values())} programs {warm} in "
              f"{time.perf_counter() - t0:.3f} s")
    for p in prompts:
        engine.add_request(p, args.new)
    steps0 = engine.stats()["steps"]
    kernels.reset_launch_counts()
    if drops is not None:
        drops.reset()
    if args.profile:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            finished, wall = _timed_drain(engine)
        prof.export_chrome_trace(args.profile)
        print_device_time(prof, wall, {k: v for k, v in
                                        kernels.launch_counts().items() if v})
    else:
        finished, wall = _timed_drain(engine)
    made = engine.stats()["compiles"]
    if made != warm:
        raise RuntimeError(f"the drain made new programs after warmup: "
                           f"{warm} -> {made}")
    total = sum(len(r.out_tokens) for r in finished)
    steps = engine.stats()["steps"] - steps0
    print(f"[serve] {cfg.name} on {engine.device}: {len(finished)} requests, "
          f"{total} tokens in {wall:.6f} s ({total / wall:.4f} tokens/s), "
          f"{steps} steps, {1e3 * wall / max(1, steps):.3f} ms per step "
          f"(paged KV: {engine.pool.page_tokens} tok/page, "
          f"{engine.pool.num_pages} pages, peak {engine.pool.peak_used} used, "
          f"{engine.num_preemptions} preemptions)")
    if drops is not None:
        print(f"[serve] moe: {cfg.n_experts} experts, top-{cfg.top_k}, "
              f"capacity factor {cfg.capacity_factor}; the drain dropped "
              f"{drops.dropped_frac():.6f} of its real tokens' routed "
              f"assignments")
        drops.uninstall()
    for r in sorted(finished, key=lambda r: r.rid)[:8]:
        print(f"  rid={r.rid} prompt={r.prompt_len:>3} new={len(r.out_tokens):>3} "
              f"[{r.finish_reason}] {r.out_tokens[:8]}")
    return finished


if __name__ == "__main__":
    main()
