"""§Perf hillclimb on the port: run RunConfig variants through the
port's dry-run on the three chosen cells and record per-variant roofline
terms (experiments/torch/perf/<cell>_<variant>.json); the port's
counterpart of ``experiments/hillclimb.py``, with its cells and variants.

Cells (the JAX hillclimb's):
  - qwen2-7b x train_4k      : most representative of the paper's technique
                               (dense, matmul-dominated)
  - qwen3-moe-235b x train_4k: most collective-bound
  - qwen2-7b x decode_32k    : memory-bound decode representative

Host only: :func:`repro_torch.launch.dryrun.run_cell` prices each cell on
the 256-device pod mesh from meta trees (nothing is allocated, nothing
runs on a device), with the descriptor of ``--device`` (cuda: the card's
``h100`` and its published peaks; cpu: ``tpu_v5e``).  Each record keeps
the JAX hillclimb's fields (``compute_s``, ``memory_s``, ``collective_s``,
``bottleneck``, ``memory_per_device``).  The JAX hillclimb reads
``memory_per_device["temp_size_in_bytes"]`` from XLA's compiled memory
analysis; the port has no compiler to ask, so here it is the dry-run's
reckoned step peak per device (``peak_bytes``: the held arguments plus
the step's transients).

Usage: PYTHONPATH=src python experiments/torch/hillclimb.py [--cell qwen2|moe|decode] [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.configs import RunConfig
from repro_torch.core.hardware import query
from repro_torch.launch.dryrun import run_cell

BASE = RunConfig(microbatch=8)

VARIANTS = {
    # paper-faithful layout ablation: propagation ON (paper §4.3) vs OFF
    "baseline": BASE,
    "noprop": dataclasses.replace(BASE, propagate=False),
    "unpacked": dataclasses.replace(BASE, layout_policy="unpacked"),
    "fixed": dataclasses.replace(BASE, layout_policy="fixed"),
    # distribution iterations
    "nofsdp": dataclasses.replace(BASE, fsdp=False),
    "mb4": dataclasses.replace(BASE, microbatch=4),
    "mb16": dataclasses.replace(BASE, microbatch=16),
    "noseqkv": dataclasses.replace(BASE, seq_shard_kv=False),
    "moelocal": dataclasses.replace(BASE, moe_local_dispatch=True),
}

CELLS = {
    "qwen2": ("qwen2-7b", "train_4k",
              ["baseline", "noprop", "unpacked", "fixed", "nofsdp", "mb4",
               "mb16"]),
    "moe": ("qwen3-moe-235b-a22b", "train_4k",
            ["baseline", "noprop", "nofsdp", "mb4", "moelocal"]),
    "decode": ("qwen2-7b", "decode_32k",
               ["baseline", "noprop", "unpacked", "noseqkv"]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="all",
                    choices=["all", *CELLS.keys()])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default="experiments/torch/perf")
    ap.add_argument("--device", default="cuda",
                    help="whose descriptor prices the cells: cuda (the "
                         "card's h100; without a card it raises) or cpu "
                         "(tpu_v5e); nothing is allocated on it")
    args = ap.parse_args(argv)

    hw = query(args.device)
    os.makedirs(args.out, exist_ok=True)
    todo = CELLS if args.cell == "all" else {args.cell: CELLS[args.cell]}
    failures = 0
    for cell, (arch, shape, variants) in todo.items():
        if args.variant:
            variants = [args.variant]
        for v in variants:
            run = VARIANTS[v]
            try:
                rec = run_cell(arch, shape, "pod", run, out_dir=None,
                               verbose=False, hw=hw)
            except Exception as e:      # a failure here is a sharding bug
                failures += 1
                print(f"[perf] {cell} {v}: FAIL {str(e)[:200]}")
                continue
            rec["variant"] = v
            mem = rec.get("memory_per_device") or {}
            # the dry-run's reckoned step peak (see the module docstring)
            mem["temp_size_in_bytes"] = mem.get("peak_bytes", 0)
            with open(os.path.join(args.out, f"{cell}_{v}.json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[perf] {cell:7s} {v:9s}: "
                  f"cmp {rec['compute_s']*1e3:9.1f}ms "
                  f"mem {rec['memory_s']*1e3:9.1f}ms "
                  f"coll {rec['collective_s']*1e3:9.1f}ms "
                  f"temp {mem['temp_size_in_bytes']/2**30:6.1f}GiB "
                  f"bound={rec['bottleneck']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
