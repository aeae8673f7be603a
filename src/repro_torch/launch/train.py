"""Training launcher: the fault-tolerant trainer on the synthetic stream.

On the card by default (``--device cuda`` raises without one); ``--device
cpu`` runs the kernels' plain versions.  Prints a ``[train] ...`` line and
the step's captures: on the card the first step runs eagerly and captures
the step into a CUDA graph, which every later step replays.
``--profile out.json.gz`` (on the card) traces every step after the
second (replays; the second warms the profiler up) with
``torch.profiler`` and prints the device time by
kernel, summed per port kernel and for PyTorch's own, with the device's
idle share.  ``--policy`` picks the layout policy and ``$REPRO_HW`` the
hardware descriptor (as in :mod:`repro_torch.launch.serve`); the launcher
prints both and the tiles.

Every family trains: ``--arch`` takes each config (``--layers N`` cuts
its depth; no moe config fits one card whole, nor jamba's period; one
Qwen3-MoE layer trains on one card with ``--adam-8bit``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --seq 1024 \
        --batch 4 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 20 --seq 1024 --batch 4 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b \
        --layers 1 --adam-8bit --steps 5 --seq 1024 --batch 4 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \
        --reduced --device cpu --steps 4 --seq 32 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 4 --seq 32 --batch 2
    REPRO_HW=tpu_vl512 PYTHONPATH=src python -m repro_torch.launch.train \
        --reduced --device cpu --steps 4 --seq 32 --batch 2 --policy unpacked
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import describe_hw
from repro_torch.models.model import build_model
from repro_torch.training.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm2-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU-scale runs")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (a hybrid: a "
                         "whole number of its periods)")
    ap.add_argument("--policy", default="scalable",
                    choices=["scalable", "fixed", "unpacked"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup steps (default: a fifth of --steps, plus "
                         "one, at most 20)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--adam-8bit", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (restart drills)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile", default=None,
                    help="trace the steps after the first into this Chrome "
                         "trace (card only) and print device time by kernel")
    args = ap.parse_args(argv)
    if args.profile and (args.device != "cuda" or args.steps < 3):
        raise ValueError("--profile traces steps after the second on the card: "
                         "needs --device cuda and --steps >= 3")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, layers=args.layers)
    elif args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    run = RunConfig(layout_policy=args.policy, microbatch=args.microbatch,
                    param_dtype=args.dtype, compute_dtype=args.dtype,
                    lr=args.lr, adam_8bit=args.adam_8bit,
                    grad_compression=args.grad_compression,
                    remat=False,
                    warmup_steps=(min(20, args.steps // 5 + 1) if args.warmup is None
                                  else args.warmup))

    model = build_model(cfg, run, shape, device=args.device)
    print(f"[train] {describe_hw(model)}")
    data = SyntheticLM(cfg, shape, seed=args.seed)
    trainer = Trainer(model, data, run, ckpt_dir=args.ckpt_dir,
                      total_steps=args.steps, ckpt_every=args.ckpt_every)
    # weights drawn on the model's device (a moe layer's experts are
    # billions of parameters: the host would take minutes)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    if args.profile:
        state, history = _profiled_fit(trainer, gen, args)
    else:
        state, history = trainer.fit(gen, fail_at=args.fail_at)
    if history:
        print(f"[train] {cfg.name}: step {int(state.step)}  "
              f"loss {history[0]:.3f} -> {history[-1]:.3f}  "
              f"stragglers={trainer.straggler_events}")
        if len(history) >= 10:
            print(f"[train] mean loss of the first 5 steps "
                  f"{sum(history[:5]) / 5:.4f}, of the last 5 "
                  f"{sum(history[-5:]) / 5:.4f}")
        print(f"[train] captures {trainer.step_fn.captures} "
              f"({trainer.step_fn.capture_seconds:.3f} s); first step "
              f"{trainer.step_ms[0]:.1f} ms (on the card: the eager step and "
              f"its capture)")
    else:
        print(f"[train] {cfg.name}: already at step {int(state.step)}, "
              f"nothing to do")
    return state, history


def _profiled_fit(trainer, gen, args):
    """``trainer.fit`` with every step after the second traced (the second
    warms the profiler up: a trace that starts cold has dropped a kernel
    or two of its first step); the wall is the traced steps' own
    (``trainer.step_ms``), and the trace's port launches are held beside
    the wrappers' counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels
    from repro_torch.launch.serve import print_device_time

    def on_step(step):
        if len(trainer.step_ms) == 2:
            kernels.reset_launch_counts()
        prof.step()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=args.steps - 2)) as prof:
        out = trainer.fit(gen, fail_at=args.fail_at, on_step=on_step)
    traced = trainer.step_ms[2:]
    prof.export_chrome_trace(args.profile)
    counted = {k: v for k, v in kernels.launch_counts().items() if v}
    seen = print_device_time(prof, 1e-3 * sum(traced), counted, tag="train profile")
    print(f"[train profile] {len(traced)} traced steps, "
          f"{sum(traced) / len(traced):.1f} ms per step")
    if any(seen.get(k, 0) != n for k, n in counted.items()):
        raise RuntimeError("--profile: the trace misses kernels of the "
                           "replayed steps; its device time is incomplete")
    return out


if __name__ == "__main__":
    main()
