#!/usr/bin/env python
"""AST invariant lint (analysis pass 4) over the port: the port's
counterpart of ``scripts/lint_invariants.py``, stdlib ``ast`` only.

Enforces the syntactic rules over ``src/repro_torch/serving/``,
``src/repro_torch/obs/`` and ``src/repro_torch/kernels/`` (see
:mod:`repro_torch.analysis.ast_lint`): allocator privacy, usable-pages
capacity asserts, no unseeded randomness, monotonic clocks in serving/obs,
kernel ref-oracles under test.  Host only: nothing runs on a device.
Exit 1 on any finding.

    python scripts/torch/lint_invariants.py                     # default tree
    python scripts/torch/lint_invariants.py src/repro_torch     # a wider sweep
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: serving + kernels "
                         "+ obs)")
    ap.add_argument("--no-oracles", action="store_true",
                    help="skip the kernel-oracle rule (tests dir scan)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.ast_lint import lint_kernel_oracles, lint_paths

    pkg = REPO / "src" / "repro_torch"
    serving, kernels, obs = pkg / "serving", pkg / "kernels", pkg / "obs"
    paths = args.paths or [serving, kernels, obs]
    findings = lint_paths(paths, serving_root=serving,
                          clock_roots=(serving, obs))
    if not args.no_oracles and (REPO / "tests").is_dir():
        findings += lint_kernel_oracles(kernels, REPO / "tests")

    for f in findings:
        print(f.format())
    print(f"{len(findings)} finding(s)" if findings else "OK — no findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
