"""Time the bf16 train step and mmt4d's gradient kernels of two source trees
on one card, in turns.

    python3 scripts/grad_ab.py --tree parent=build/parent --tree change=. \
        --order parent,change,change,parent [--steps 12] [--out ab.json]

Each turn runs in a subprocess from its tree's root, with that tree's
``src`` on the path and its own kernel build: first the gradient kernels
(``chip_smoke.KernelChecks.grads``: bf16, 4,096 tokens, the gate with its
silu, the down projection, the tied head and the K projection, each held
to its plain version and timed L2-cold beside ``torch.matmul``), then
full-width SmolLM2-135M trained in bf16 (seq 1024, batch 4, SyntheticLM,
AdamW, no remat) for ``--steps`` steps through ``Trainer``, its ms per
step the median after the first.  One JSON line per turn, then the
medians by tree.  Compare trees only within one run: two runs may land on
two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# runs inside the tree under test (its chip_smoke.py and src/)
_TURN = r"""
import json, sys, time
import torch
sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.configs import RunConfig, ShapeSpec, get_config
from repro_torch.core.hardware import query
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import build
from repro_torch.models.model import build_model
from repro_torch.training.trainer import Trainer

torch.backends.cuda.matmul.allow_tf32 = False
build.load_library()
hw = query("cuda")
checks = cs.KernelChecks(hw, torch.Generator(device="cuda").manual_seed(0))
tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ
for k, n, act, label in ((576, 1536, "silu", "gate"), (1536, 576, None, "down"),
                         (576, 49152, None, "tied head"), (576, 192, None, "k proj")):
    checks.grads(cs.BF, tokens, k, n, act, label)
kernels = {f"{name} {c['shape'].split(' dZ')[0]}": {
               "ms": c["kernel_ms"], "torch_matmul_ms": c["library_ms"]}
           for name in ("mmt4d_dgrad", "mmt4d_wgrad") for c in checks.cases[name]}
cfg = get_config("smollm2-135m")
run = RunConfig(remat=False, warmup_steps=1)
model = build_model(cfg, run, ShapeSpec("train", cs.TRAIN_SEQ, cs.TRAIN_BATCH, "train"),
                    device="cuda")
tr = Trainer(model, SyntheticLM(cfg, model.shape, seed=0), run, total_steps=STEPS,
             log_fn=lambda m: None)
_, hist = tr.fit(torch.Generator().manual_seed(0), steps=STEPS)
steady = sorted(tr.step_ms[1:])
ms = steady[len(steady) // 2]
print("RESULT " + json.dumps({"card": cs.card_line(), "kernels": kernels,
                              "step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
                              "first_step_ms": tr.step_ms[0], "losses": hist}))
"""


def turn(name: str, root: str, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _TURN.replace("STEPS", str(steps))],
                         cwd=root, env=env, capture_output=True, text=True, timeout=900)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: rc {out.returncode}\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    return {"tree": name, **json.loads(lines[-1][len("RESULT "):])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="name=path of a source tree (its root holds chip_smoke.py)")
    ap.add_argument("--order", required=True, help="tree names in turn, comma-separated")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    results = []
    for name in args.order.split(","):
        r = turn(name, os.path.abspath(trees[name]), args.steps)
        print(json.dumps(r), flush=True)
        results.append(r)
    for name in trees:
        mine = [r for r in results if r["tree"] == name]
        if not mine:
            continue
        print(f"{name}: step ms {[round(r['step_ms'], 1) for r in mine]}, median "
              f"{statistics.median(r['step_ms'] for r in mine):.1f} ms, "
              f"{statistics.median(r['tokens_per_s'] for r in mine):.0f} tokens/s; "
              + "; ".join(f"{k} {statistics.median(r['kernels'][k]['ms'] for r in mine):.4f} ms"
                          for k in mine[0]["kernels"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
