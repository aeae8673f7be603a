"""Bisect the float32 gap between the card and the CPU in the recurrent
models, one op class at a time (ROADMAP C9).

RWKV-6 1.6B at its published widths cut to 2 layers, and the hybrid test
configuration (jamba-v0.1's mixers, one period of 8 layers, moe=False),
in float32 with TF32 off, weights drawn on the card from seed 0 (as
``chip_smoke.py``'s recurrent phase draws them).  One prompt (the first
of that phase's f32 drain) goes through ``ReproModel.forward`` on the card
and on the CPU, and the gap is max |card - CPU| over the last position's
logits (the first monolithic call's) and over every position, as a share
of max(1, max |logit|).

Each op class is a function of the model modules (the linears through
mmt4d, the head, the norms, RWKV-6's decay LoRA, wkv6 and group norm;
mamba's ``dt_proj``, convolution and scan, the attention core).  For each
class the script measures

- ``only``: the gap when only that class runs on the card (every other
  op on the CPU; the class's inputs and outputs cross the bus), which is
  its own share of the gap;
- ``without``: the gap when that class runs on the CPU and every other
  op on the card;
- ``local``: at the class's first call in the CPU forward, the card's
  output on the same inputs against the CPU's, max |diff| over max |out|;
  for the linears also each side's distance from a float64 product.

Usage (on the card):  python3 scripts/c9_bisect.py [--out results.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import RunConfig, ShapeSpec, get_config  # noqa: E402
from repro_torch.core.hardware import query  # noqa: E402
from repro_torch.core.linear import MatmulContext  # noqa: E402
from repro_torch.core.propagation import PackedArray  # noqa: E402
from repro_torch.kernels.mmt4d.ref import ACTIVATIONS  # noqa: E402
from repro_torch.models import attention, mamba, mlp, rwkv6  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

F32 = RunConfig(param_dtype="float32", compute_dtype="float32")
SHAPE = ShapeSpec("serve", 64, 4, "decode")
# the card's side ("cpu" rehearses the script on the CPU: every gap 0)
CARD = "cuda"

# op class -> the (module, attribute) pairs it patches
CLASSES = {
    "rwkv6": {
        "linears (mmt4d)": [(rwkv6, "linear_apply")],
        "head (mmt4d)": [(transformer, "linear_apply")],
        "layer norms": [(transformer, "norm_apply")],
        "decay LoRA (torch.matmul)": [(rwkv6, "_decay")],
        "wkv6": [(rwkv6, "wkv6")],
        "group norm": [(rwkv6, "_group_norm")],
    },
    "hybrid": {
        "linears (mmt4d)": [(mamba, "linear_apply"), (attention, "linear_apply"),
                            (mlp, "linear_apply")],
        "head (mmt4d)": [(transformer, "linear_apply")],
        "rms norms": [(transformer, "norm_apply")],
        "dt_proj (torch.matmul)": [(mamba, "_delta")],
        "conv": [(mamba, "_causal_conv")],
        "scan": [(mamba, "selective_scan")],
        "attention core": [(attention, "core_attention")],
    },
}


def move(obj, dev, ctxs):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, PackedArray):
        return dataclasses.replace(obj, data=obj.data.to(dev))
    if isinstance(obj, MatmulContext):
        return ctxs["cpu" if torch.device(dev).type == "cpu" and dev != CARD
                    else "cuda"]
    if isinstance(obj, dict):
        return {k: move(v, dev, ctxs) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(move(v, dev, ctxs) for v in obj)
    return obj


def relocated(fn, dev, ctxs):
    """``fn`` run on ``dev``: arguments moved there (a MatmulContext
    swapped for that device's), the result moved back."""
    def wrapper(*args, **kw):
        home = next((a.device if isinstance(a, torch.Tensor) else a.data.device
                     for a in list(args) + list(kw.values())
                     if isinstance(a, (torch.Tensor, PackedArray))), None)
        out = fn(*move(args, dev, ctxs), **move(kw, dev, ctxs))
        return move(out, home, ctxs)
    return wrapper


class Patch:
    def __init__(self, pairs, make):
        self.pairs, self.make, self.saved = pairs, make, []

    def __enter__(self):
        for mod, name in self.pairs:
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))
            setattr(mod, name, self.make(orig))

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self.saved):
            setattr(mod, name, orig)
        self.saved = []


def logits(model, params, tokens):
    with torch.no_grad():
        out, _ = model.forward(params, {"tokens": tokens[None]})
    return out[0].float().cpu().numpy()


def gap(a, b):
    scale = max(1.0, float(np.abs(b[-1]).max()))
    return {"last": float(np.abs(a[-1] - b[-1]).max()) / scale,
            "all": float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))}


def local_errors(pairs, models, params, tokens, ctxs):
    """The class's first call in the CPU forward, replayed on the card."""
    seen = {}

    def make(orig):
        def rec(*args, **kw):
            out = orig(*args, **kw)
            if "call" not in seen:
                seen["call"] = (orig, args, kw, out)
            return out
        return rec

    with Patch(pairs, make):
        logits(models["cpu"], params["cpu"], tokens)
    orig, args, kw, out = seen["call"]
    card = move(orig(*move(args, CARD, ctxs), **move(kw, CARD, ctxs)), "cpu", ctxs)
    if isinstance(out, tuple):
        out, card = out[0], card[0]
    if isinstance(out, PackedArray):
        out, card = out.unpack(), card.unpack()
    scale = float(out.abs().max()) or 1.0
    res = {"shape": list(out.shape),
           "card_vs_cpu": float((card - out).abs().max()) / scale}
    if orig.__name__ == "linear_apply" and "w" in args[0]:
        p, x = args[0], args[1]
        x = x.unpack() if isinstance(x, PackedArray) else x
        truth = x.double() @ p["w"].double()
        if "b" in p:
            truth = truth + p["b"].double()
        truth = ACTIVATIONS[kw.get("activation")](truth)
        res["cpu_vs_f64"] = float((out.double() - truth).abs().max()) / scale
        res["card_vs_f64"] = float((card.double() - truth).abs().max()) / scale
        res["k"] = int(x.shape[-1])
    return res


def bisect(label, cfg, classes, card):
    card_hw = query(CARD, "h100" if CARD == "cuda" else "tpu_v5e")
    models = {"cuda": build_model(cfg, F32, SHAPE, hw=card_hw, device=CARD),
              "cpu": build_model(cfg, F32, SHAPE, hw=query("cpu", "tpu_v5e"),
                                 device="cpu")}
    ctxs = {dev: m.ctx for dev, m in models.items()}
    pc = models["cuda"].init(torch.Generator(device=CARD).manual_seed(0))
    params = {"cuda": pc, "cpu": transformer.tree_map(lambda t: t.cpu(), pc)}
    rng = np.random.default_rng(2)
    lens = rng.integers(5, 25, 4)
    tokens_np = rng.integers(0, cfg.vocab, int(lens[0]))
    tok = {"cuda": torch.as_tensor(tokens_np, device=CARD),
           "cpu": torch.as_tensor(tokens_np)}
    t0 = time.perf_counter()
    ref = logits(models["cpu"], params["cpu"], tok["cpu"])
    full = logits(models["cuda"], params["cuda"], tok["cuda"])
    base = gap(full, ref)
    print(f"{label}: prompt of {len(tokens_np)} tokens; card vs CPU, every op "
          f"on its side: last position {base['last']:.3e}, every position "
          f"{base['all']:.3e} of max(1, max |logit|) (max |logit| "
          f"{float(np.abs(ref[-1]).max()):.3f}) ({card})")
    rows = {}
    for name, pairs in classes.items():
        with Patch(pairs, lambda f: relocated(f, CARD, ctxs)):
            only = gap(logits(models["cpu"], params["cpu"], tok["cpu"]), ref)
        with Patch(pairs, lambda f: relocated(f, "cpu", ctxs)):
            without = gap(logits(models["cuda"], params["cuda"], tok["cuda"]), ref)
        local = local_errors(pairs, models, params, tok["cpu"], ctxs)
        rows[name] = {"only": only, "without": without, "local": local}
        f64 = (f"; first call vs float64: CPU {local['cpu_vs_f64']:.3e}, card "
               f"{local['card_vs_f64']:.3e} (K {local['k']})"
               if "card_vs_f64" in local else "")
        print(f"  {name:28s} only on the card {only['last']:.3e} (all "
              f"{only['all']:.3e}); on the CPU, rest on the card "
              f"{without['last']:.3e}; first call card vs CPU "
              f"{local['card_vs_cpu']:.3e} of max |out| {local['shape']}{f64}")
    every = [pair for pairs in classes.values() for pair in pairs]
    with Patch(every, lambda f: relocated(f, "cpu", ctxs)):
        rest = gap(logits(models["cuda"], params["cuda"], tok["cuda"]), ref)
    print(f"  {'every class on the CPU':28s} the rest (embedding gather, "
          f"lerps, gates, residual adds) on the card {rest['last']:.3e} (all "
          f"{rest['all']:.3e}) ({time.perf_counter() - t0:.1f} s)")
    return {"base": base, "classes": rows, "rest": rest,
            "prompt_len": len(tokens_np)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c9_bisect: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    out = {"card": card}
    rw = get_config("rwkv6-1.6b")
    out["rwkv6"] = bisect(f"rwkv6-1.6b (2 of {rw.n_layers} layers, f32)",
                          dataclasses.replace(rw, n_layers=2),
                          CLASSES["rwkv6"], card)
    jamba = get_config("jamba-v0.1-52b")
    hyb = dataclasses.replace(jamba, n_layers=len(jamba.block_pattern), moe=False)
    out["hybrid"] = bisect("hybrid (jamba-v0.1's mixers, 8 layers, moe=False, f32)",
                           hyb, CLASSES["hybrid"], card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
