"""Quickstart: the paper's scalable packed layouts in five minutes, on the
PyTorch/CUDA port (``examples/quickstart.py`` is the JAX package's).

Walks the core abstraction bottom-up:
  1. query the hardware descriptor (the ``svcntw()`` moment);
  2. instantiate a VL-parametric packed layout;
  3. pack -> mmt4d -> unpack on real data, compare against torch.matmul;
  4. show the NEON-analogue (fixed) and eager-analogue (unpacked) policies;
  5. run a packed linear chain with layout propagation (zero repacking).

The inputs are the JAX example's: ``jax.random.normal`` under the same
seeds, drawn on the host by ``repro_torch.serving.sampling.normal``.  On the
card the descriptor is ``h100`` and every product runs in the hand-written
kernels (pack, mmt4d with its tanh-gelu epilogue, unpack); on the CPU it is
``tpu_v5e`` and the same calls take the kernels' plain versions.

Run:  PYTHONPATH=src python examples/torch/quickstart.py            # the card
      PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (MatmulContext, linear_apply, make_layout, matmul,
                              pack_activation, presets, query)
from repro_torch.core.hardware import require_device
from repro_torch.serving.sampling import normal, prng_key

RTOL, ATOL = 1e-4, 1e-3       # the JAX example's tolerances


def _normal(seed: int, shape, device) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape)`` on ``device``."""
    return torch.from_numpy(normal(prng_key(seed), shape)).to(device)


def _linear(seed: int, d_in: int, d_out: int, device) -> dict:
    """The JAX package's ``linear_init(PRNGKey(seed), d_in, d_out)``."""
    return {"w": _normal(seed, (d_in, d_out), device) * d_in ** -0.5}


def _mem(nbytes: int) -> str:
    """VMEM in MiB as the JAX example prints it; a card's shared memory a
    block (under 1 MiB) in KiB."""
    return f"{nbytes >> 20}MiB" if nbytes >= 2**20 else f"{nbytes >> 10}KiB"


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def run(device="cuda", log=print) -> dict:
    """The walk-through on ``device``; raises if a product misses the
    tolerances.  Returns the descriptor's name and each policy's max
    error."""
    device = require_device(device)
    # 1. hardware descriptor: runtime-queried, like SVE's vector length
    hw = query(device)
    log(f"hardware: {hw.name}: lanes={hw.lanes} sublanes={hw.sublanes} "
        f"mxu_k={hw.mxu_k} vmem={_mem(hw.vmem_bytes)}")

    # 2. layouts are FUNCTIONS of the descriptor (paper §4.2)
    for dtype in (torch.float32, torch.bfloat16):
        lay = make_layout("scalable", hw, dtype)
        log(f"scalable layout[{str(dtype)[6:]}]: "
            f"(m_r,n_r,k_r)=({lay.m_r},{lay.n_r},{lay.k_r}) "
            f"chain_compatible={lay.chain_compatible}")

    # ... and adapt when the hardware widens, without touching this code
    wide_hw = (presets["tpu_vl512"] if device.type == "cpu"
               else query(device, "h100_vl512"))
    wide = make_layout("scalable", wide_hw, torch.float32)
    log(f"same code on a 4x-wider vector unit: "
        f"(m_r,n_r,k_r)=({wide.m_r},{wide.n_r},{wide.k_r})")

    # 3. packed matmul == plain matmul (padding semantics handle ragged dims)
    a = _normal(0, (1000, 333), device)
    b = _normal(1, (333, 777), device)
    ref = a @ b
    lay = make_layout("scalable", hw, torch.float32)
    _close(matmul(a, b, lay), ref)
    log("packed matmul matches torch.matmul on (1000x333)@(333x777)  OK")

    # 4. three codegen policies, one entry point
    errs = {}
    for pol in ("scalable", "fixed", "unpacked"):
        out = matmul(a, b, make_layout(pol, hw, torch.float32))
        _close(out, ref)
        errs[pol] = float((out - ref).abs().max())
        log(f"policy={pol:9s} -> max err {errs[pol]:.2e}")

    # 5. layout propagation: a packed MLP with zero intermediate repacking
    ctx = MatmulContext(hw=hw)
    x = _normal(2, (4, 128, 512), device)
    p1 = _linear(3, 512, 2048, device)
    p2 = _linear(4, 2048, 512, device)
    px = pack_activation(x, ctx.layout(x.dtype))      # pack ONCE
    h = linear_apply(p1, px, ctx, activation="gelu", keep_packed=True)
    y = linear_apply(p2, h, ctx, keep_packed=True)    # consumes packed direct
    out = (px + y).unpack()                           # residual in packed dom.
    gelu = torch.nn.functional.gelu(x @ p1["w"], approximate="tanh")
    ref = x + gelu @ p2["w"]
    _close(out, ref)
    log("packed MLP chain with residual: one pack, one unpack  OK")
    return {"hw": hw.name, "errs": errs,
            "chain_err": float((out - ref).abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (their plain "
                         "versions); without a card cuda raises")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
