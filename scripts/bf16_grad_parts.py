"""How far bfloat16 moves one train step's gradients from float32, leaf by
leaf, on the CPU's plain path (no card needed).

RWKV-6 1.6B at its published widths cut to 2 layers (``--arch`` and
``--layers`` choose another), seq 128, batch 2, the first SyntheticLM batch;
the float32 weights drawn from a CPU generator, seed 0, and the bf16 ones
drawn from the same seed (the float32 weights rounded).  For each gradient
leaf it prints the leaf's norm in float32 and in bfloat16 and
||g_bf16 - g_f32|| / ||g_f32||, then both losses and the global gradient
norms.  ``chip_smoke.py``'s bf16 witnesses hold the card's bf16 step to
the CPU's bf16 path, not to float32, because of what this shows.

Usage:  PYTHONPATH=src python3 scripts/bf16_grad_parts.py [--threads 4]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import leaves
from repro_torch.training.step import value_and_grad


def leaf_names(tree, prefix="") -> list:
    """The '/'-joined keys of a tree's leaves, in ``leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    batch = SyntheticLM(cfg, shape, seed=0).batch_at(0)
    res = {}
    for dt in ("float32", "bfloat16"):
        run = RunConfig(param_dtype=dt, compute_dtype=dt, remat=False)
        model = build_model(cfg, run, shape, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        (loss, _), grads = value_and_grad(model, params, batch)
        res[dt] = (float(loss), [g.float() for g in leaves(grads)], leaf_names(params))
    (l32, g32, names), (l16, g16, _) = res["float32"], res["bfloat16"]
    for n, a, b in zip(names, g32, g16, strict=True):
        print(f"{n:40s} f32 {a.norm().item():10.4f} bf16 {b.norm().item():10.4f} "
              f"parted {((b - a).norm() / a.norm()).item():.3e}")
    norm = [torch.sqrt(sum((g ** 2).sum() for g in gs)).item() for gs in (g32, g16)]
    print(f"loss f32 {l32:.7f} bf16 {l16:.7f}; gradient norm f32 {norm[0]:.4f} "
          f"bf16 {norm[1]:.4f}")


if __name__ == "__main__":
    main()
