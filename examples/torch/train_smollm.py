"""End-to-end training example on the PyTorch/CUDA port: SmolLM2-135M, the
paper's own e2e model (``examples/train_smollm.py`` is the JAX package's).

Trains with the port's production stack: packed scalable layouts, grad
accumulation, AdamW (+schedule), atomic checkpoints with auto-resume, the
deterministic data pipeline.  Defaults are CPU-sized (reduced config);
pass ``--full`` for the real 135M config.  On the card each step is a
replay of the CUDA graph the trainer captures at its first call, through
the hand-written kernels (mmt4d, mmt4d_dgrad, mmt4d_wgrad, pack, unpack).

Run:  PYTHONPATH=src python examples/torch/train_smollm.py --steps 200             # the card
      PYTHONPATH=src python examples/torch/train_smollm.py --steps 8 --device cpu
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import require_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.training.trainer import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="true 135M config (CPU: slow)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_smollm_ckpt"))
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="peak learning rate (the JAX example's 3e-3, set "
                    "for the reduced model: at --full the loss rises over "
                    "the first 20 steps, in both packages; 3e-4 with "
                    "--warmup 1 lowers it)")
    ap.add_argument("--warmup", type=int, default=20,
                    help="linear warmup steps (the JAX example's 20)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels and graphs) or cpu (their "
                    "plain versions); without a card cuda raises")
    return ap.parse_args(argv)


def config(args):
    """The JAX example's model: SmolLM2-135M, reduced to 4 layers unless
    ``--full``."""
    cfg = get_config("smollm2-135m")
    return cfg if args.full else reduced_config(cfg, layers=4)


def train(cfg, args, params=None, device="cuda", log=print) -> dict:
    """Train ``cfg`` for ``args.steps`` from the latest valid checkpoint in
    ``args.ckpt_dir``, else from ``params``, else from the model's init
    drawn from ``torch.Generator().manual_seed(0)``.  Returns the loss
    history and the trainer."""
    device = require_device(device)
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat=False, lr=args.lr, warmup_steps=args.warmup,
                    microbatch=args.microbatch)
    model = build_model(cfg, run, shape, device=device)
    data = SyntheticLM(cfg, shape, seed=0)
    trainer = Trainer(model, data, run, ckpt_dir=args.ckpt_dir,
                      total_steps=args.steps, ckpt_every=50, log_fn=log)
    state, hist = trainer.fit(torch.Generator().manual_seed(0), params=params)
    w = max(1, len(hist) // 10)
    first, last = float(np.mean(hist[:w])), float(np.mean(hist[-w:]))
    log("")
    log(f"[train_smollm] {cfg.name}: {len(hist)} steps "
        f"loss {first:.3f} -> {last:.3f} "
        f"({'LEARNING' if last < first else 'check config'})")
    return {"history": hist, "trainer": trainer, "state": state}


def main(argv=None) -> int:
    args = parse_args(argv)
    train(config(args), args, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
