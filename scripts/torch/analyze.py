#!/usr/bin/env python
"""Run the port's layout-contract analyzer over the engine matrix (the
port's counterpart of ``scripts/analyze.py``).

Exit status 0 iff every pass is green; any finding prints and fails the
run, which is what lets ``scripts/torch/tier1.sh --analyze`` gate a change
on the port's serving invariants.  The matrix is the JAX package's
(``repro_torch.analysis.runner.CONFIG_MATRIX``) over one reduced model on
``--device``: the traced passes read the aten graph of each step family
(fake tensors, nothing runs), the sanitized drains run it.

    PYTHONPATH=src python scripts/torch/analyze.py                  # the card
    PYTHONPATH=src python scripts/torch/analyze.py --device cpu --static
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--static", action="store_true",
                    help="ladder algebra + AST lint only (no traced steps, "
                         "no sanitized traffic): seconds instead of minutes")
    ap.add_argument("--no-traffic", action="store_true",
                    help="skip the sanitized drains (keep the traced steps)")
    ap.add_argument("--config", action="append", default=None,
                    metavar="LABEL",
                    help="analyze only this configuration of the matrix "
                         "(repeatable; default: every one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions); "
                         "without a card cuda raises")
    args = ap.parse_args(argv)

    from repro_torch.analysis import run_all
    from repro_torch.analysis.runner import CONFIG_MATRIX
    from repro_torch.core.hardware import require_device
    from repro_torch.kernels.ragged_attn.ops import HEAD_WIDTHS

    device = require_device(args.device)
    labels = [label for label, _ in CONFIG_MATRIX]
    unknown = sorted(set(args.config or ()) - set(labels))
    if unknown:
        ap.error(f"unknown --config {unknown}; have {labels}")
    matrix = [(label, kw) for label, kw in CONFIG_MATRIX
              if args.config is None or label in args.config]
    # on the card the reduced model's heads are 64 wide, the narrowest the
    # ragged attention kernel takes (the reduced config's are 16 wide)
    report = run_all(traffic=not (args.static or args.no_traffic),
                     trace=not args.static, matrix=matrix, device=device,
                     log=lambda m: print(m, flush=True),
                     d_head=HEAD_WIDTHS[0] if device.type == "cuda" else None)
    print(report.format())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
