"""Where the compiled train step's capture finds its memory (ROADMAP C11).

Qwen3-MoE at its published widths cut to ``--layers`` (default 1), bf16,
the default AdamW (float32 moments), ``--batch`` x ``--seq`` tokens
(default 4 x 1024), weights drawn on the card from seed 0.

``--mode diagnose`` runs the step as ``models/model.py:capture_graph``
runs its warmup: one eager call of the trainer's step function on the
model's capture stream, then prints, in GiB,

- the state (parameters and moments) and the memory allocated and
  reserved after the eager call, after ``gc.collect()`` and after
  ``torch.cuda.empty_cache()``;
- what the collection freed: the tensors it found in reference cycles
  (count and bytes) and the port's frames among the cycles' objects;
- the allocation stacks of the live blocks outside the state right after
  the eager call (``torch.cuda.memory._record_memory_history``), summed
  by the innermost frame in ``repro_torch``.

``--mode capture`` runs the trainer's compiled step once (its eager
warmup, then its capture) with the allocation history recorded; if the
capture runs out of memory it prints, from a snapshot taken there, the
live blocks by pool (the default pool or the graph's), allocating stream
and innermost frame in ``repro_torch``.

``--mode train`` runs the trainer's compiled step (``CompiledTrainStep``:
its capture included) for ``--steps`` steps and prints the losses, the
peak memory allocated and reserved, and the memory allocated after the
run.  Without ``--mode`` the three run, each in
a process of its own (a lazy import that makes cycles happens once per
process).

Usage (on the card):  python3 scripts/c11_memory.py [--layers 1]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import subprocess
import sys
import types

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import RunConfig, ShapeSpec, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
GIB = 2.0 ** 30


def gib(n: float) -> str:
    return f"{n / GIB:.2f}"


def memory(label: str) -> None:
    torch.cuda.synchronize()
    print(f"  {label}: allocated {gib(torch.cuda.memory_allocated())}, reserved "
          f"{gib(torch.cuda.memory_reserved())}, peak allocated "
          f"{gib(torch.cuda.max_memory_allocated())} GiB")


def trainer_for(args) -> Trainer:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=args.layers)
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", remat=False,
                    warmup_steps=1)
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    model = build_model(cfg, run, shape, device="cuda")
    return Trainer(model, SyntheticLM(cfg, shape, seed=0), run,
                   total_steps=args.steps, log_fn=lambda s: None)


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for t in leaves({"params": state.params, "opt_state": state.opt_state}))


def live_stacks(snapshot, skip: set, top: int = 12, by_pool: bool = False) -> list:
    """(bytes, frame) of the blocks not free whose address is not a state
    tensor's, summed by the innermost frame in the port's package (with
    ``by_pool``, also by the segment's pool and stream and the block's
    state: allocated, or freed and waiting on a stream's use)."""
    by = {}
    for seg in snapshot["segments"]:
        addr = seg["address"]
        pool = ("default pool" if tuple(seg["segment_pool_id"]) == (0, 0)
                else "graph pool")
        for blk in seg["blocks"]:
            if blk["state"] != "inactive" and addr not in skip:
                where = "(no port frame)"
                for f in blk.get("frames", []):
                    if "repro_torch" in f["filename"]:
                        where = (f"{f['filename'].split('src/')[-1]}:{f['line']} "
                                 f"{f['name']}")
                        break
                if by_pool:
                    where = (f"{pool}, stream {seg['stream']:#x}, {blk['state']}: "
                             f"{where}")
                by[where] = by.get(where, 0) + blk["size"]
            addr += blk["size"]
    return sorted(((n, w) for w, n in by.items()), reverse=True)[:top]


def capture(args) -> None:
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    tr = trainer_for(args)
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    skip = {t.data_ptr() for t in leaves({"params": state.params,
                                          "opt_state": state.opt_state})}
    print(f"{ARCH}, {args.layers} layer(s): state {gib(state_bytes(state))} GiB; the "
          f"model's capture stream {tr.model.capture_stream.cuda_stream:#x}, the "
          f"default stream {torch.cuda.current_stream().cuda_stream:#x}")
    snaps = []

    def on_oom(device, alloc, device_alloc, device_free):   # inside the allocator
        snaps.append(torch.cuda.memory._snapshot())
        stats = torch.cuda.memory_stats()
        snaps.append({k: stats[k] for k in ("allocated_bytes.all.current",
                                            "reserved_bytes.all.current",
                                            "active_bytes.all.current")})

    torch._C._cuda_attach_out_of_memory_observer(on_oom)
    try:
        tr.step_fn(state, tr.data.batch_at(0))
        memory("after the first call (eager step and capture)")
    except torch.OutOfMemoryError as e:
        print(f"  out of memory in the capture: {str(e).splitlines()[0][:160]}")
        print("  live blocks outside the state when the allocator ran out, by pool, "
              "stream and innermost frame in repro_torch (GiB):")
        for n, where in live_stacks(snaps[0], skip, top=12, by_pool=True):
            print(f"    {gib(n):>8}  {where}")
        pools = {}
        for seg in snaps[0]["segments"]:
            key = "default pool" if tuple(seg["segment_pool_id"]) == (0, 0) else \
                f"pool {tuple(seg['segment_pool_id'])}"
            p = pools.setdefault(key, [0, 0, 0, 0])
            p[0] += seg["total_size"]
            p[1] += seg["allocated_size"]
            p[2] += seg["active_size"]
            p[3] += 1
        for key, (tot, alloc, active, n) in pools.items():
            print(f"  {key}: {n} segments, reserved {gib(tot)}, allocated {gib(alloc)}, "
                  f"active {gib(active)} GiB")
        print("  the allocator's counters then: " + ", ".join(
            f"{k} {gib(v)}" for k, v in snaps[1].items()))
    torch.cuda.memory._record_memory_history(enabled=None)


def diagnose(args) -> None:
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    tr = trainer_for(args)
    state = tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    model, step = tr.model, tr.step_fn
    print(f"{ARCH}, {args.layers} layer(s), bf16, float32 moments, "
          f"{args.batch} x {args.seq} tokens: state {gib(state_bytes(state))} GiB")
    memory("state made")
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in tr.data.batch_at(0).items()}
    scalars = tr.optimizer.scalars(0, model.device)
    torch.cuda.reset_peak_memory_stats()
    s = model.capture_stream
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eager = step.fn(state, batch, scalars)
    torch.cuda.current_stream().wait_stream(s)
    memory("after the eager call")
    skip = {t.data_ptr() for t in leaves({"params": state.params,
                                          "opt_state": state.opt_state})}
    snap = torch.cuda.memory._snapshot()
    print("  live blocks outside the state after the eager call, by the "
          "innermost frame in repro_torch (GiB):")
    for n, where in live_stacks(snap, skip):
        print(f"    {gib(n):>8}  {where}")
    del snap
    gc.set_debug(gc.DEBUG_SAVEALL)
    found = gc.collect()
    tensors = [o for o in gc.garbage if isinstance(o, torch.Tensor) and o.is_cuda]
    frames = [o for o in gc.garbage if isinstance(o, types.FrameType)
              and "repro_torch" in o.f_code.co_filename]
    print(f"  gc.collect(): {found} objects in cycles, {len(tensors)} CUDA tensors "
          f"of {gib(sum(t.untyped_storage().nbytes() for t in tensors))} GiB "
          f"(storages, shared ones counted each time); the port's frames among them:")
    for f in frames:
        held = sum(v.untyped_storage().nbytes() for v in f.f_locals.values()
                   if isinstance(v, torch.Tensor) and v.is_cuda)
        print(f"    {f.f_code.co_filename.split('src/')[-1]}:{f.f_lineno} "
              f"{f.f_code.co_name}, locals' storages {gib(held)} GiB")
    del tensors, frames
    gc.set_debug(0)
    gc.garbage.clear()
    gc.collect()
    memory("after gc.collect()")
    torch.cuda.empty_cache()
    memory("after torch.cuda.empty_cache()")
    del eager
    torch.cuda.memory._record_memory_history(enabled=None)


def train(args) -> None:
    tr = trainer_for(args)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, history = tr.fit(gen)
    torch.cuda.synchronize()
    sbytes = state_bytes(state)
    stats = torch.cuda.memory_stats()
    print(f"{ARCH}, {args.layers} layer(s), bf16, float32 moments, {args.batch} x "
          f"{args.seq} tokens, {len(history)} steps through the compiled step "
          f"({tr.step_fn.captures} capture): losses "
          + ", ".join(f"{x:.4f}" for x in history))
    print(f"  state {gib(sbytes)} GiB; peak allocated "
          f"{gib(stats['allocated_bytes.all.peak'])}, peak reserved "
          f"{gib(stats['reserved_bytes.all.peak'])}; allocated now "
          f"{gib(torch.cuda.memory_allocated())} GiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--mode", choices=("diagnose", "capture", "train"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("c11_memory: needs a CUDA card")
    modes = {"diagnose": diagnose, "capture": capture, "train": train}
    if args.mode:
        modes[args.mode](args)
        return 0
    rest = list(sys.argv[1:] if argv is None else argv)
    for mode in modes:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--mode", mode, *rest],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
