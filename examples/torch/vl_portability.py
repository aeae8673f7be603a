"""The paper's headline demo on the PyTorch/CUDA port: vector-length-agnostic
execution (``examples/vl_portability.py`` is the JAX package's).

One model, one set of weights, one code path, executed under hardware
descriptors whose vector width differs 4x.  The layouts (and the kernels'
operands built on them) adapt at instantiation time; the logits agree up
to float32 reduction order.  The FIXED layout keeps its compile-time tiles
and cannot exploit the wider unit (the NEON-analogue counterexample).

On the CPU the descriptors are the JAX example's ``tpu_vl128/256/512``; on
the card ``h100``, ``h100_vl256`` and ``h100_vl512`` (the same card with
its tiles widened: the card does not get wider vectors).  The batch is the
JAX example's ``jax.random.randint`` draw, made on the host by
``repro_torch.serving.sampling.randint``.

Run:  PYTHONPATH=src python examples/torch/vl_portability.py            # the card
      PYTHONPATH=src python examples/torch/vl_portability.py --device cpu
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core import make_layout, query
from repro_torch.core.hardware import require_device
from repro_torch.models.model import build_model
from repro_torch.serving.sampling import prng_key, randint

DESCRIPTORS = {"cpu": ("tpu_vl128", "tpu_vl256", "tpu_vl512"),
               "cuda": ("h100", "h100_vl256", "h100_vl512")}


def default_config():
    """The JAX example's model: SmolLM2-135M reduced to 2 layers."""
    return reduced_config(get_config("smollm2-135m"), layers=2)


def run(cfg=None, params=None, device="cuda", log=print) -> dict:
    """One forward of ``cfg`` (default :func:`default_config`) under each
    descriptor of ``device``, float32, the same weights each time:
    ``params``, or the model's init from ``torch.Generator().manual_seed(0)``
    (a CPU generator: the same weights on either device).  Returns each
    descriptor's tiles, logits and max |Δlogits| against the first."""
    device = require_device(device)
    cfg = cfg if cfg is not None else default_config()
    shape = ShapeSpec("demo", 32, 2, "train")
    run_cfg = RunConfig(param_dtype="float32", compute_dtype="float32",
                        remat=False)
    batch = {"tokens": torch.from_numpy(
        randint(prng_key(1), (2, 32), 0, cfg.vocab)).to(device)}

    ref, rows = None, []
    log(f"{'hardware':10s} {'scalable tiles':>18s} {'fixed tiles':>14s} "
        f"{'max |Δlogits|':>14s}")
    for hwname in DESCRIPTORS[device.type]:
        hw = query(device, hwname)
        model = build_model(cfg, run_cfg, shape, hw=hw, device=device)
        if params is None:
            params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
        logits = logits.float().cpu().numpy()
        if ref is None:
            ref = logits
        err = float(np.max(np.abs(logits - ref)))
        s = make_layout("scalable", hw, torch.float32)
        f = make_layout("fixed", hw, torch.float32)
        tiles = (f"{s.m_r}x{s.n_r}x{s.k_r}", f"{f.m_r}x{f.n_r}x{f.k_r}")
        log(f"{hwname:10s} {tiles[0]:>18s} {tiles[1]:>14s} {err:14.2e}")
        rows.append({"hw": hwname, "scalable": tiles[0], "fixed": tiles[1],
                     "logits": logits, "max_dlogits": err})

    log("")
    log("same weights, same code; scalable tiles follow the hardware, "
        "fixed tiles do not (the paper's SVE-vs-NEON dichotomy).")
    return {"rows": rows, "max_logit": float(np.abs(ref).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (their plain "
                         "versions); without a card cuda raises")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
