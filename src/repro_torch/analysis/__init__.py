"""Checks of the serving stack's contracts, the JAX package's analyzer on
the port:

1. ``shapes``: the shape-ladder linter's algebra (m_r alignment, ladder
   membership, the step families warmup makes);
2. ``aliasing``: the allocator audit (refcounts against the holders);
3. ``retrace``: the recompile-hazard detector (names the argument of any
   program made after warmup);
4. ``ast_lint``: the AST lint (allocator privacy, capacity guards,
   unseeded randomness, the monotonic clock, kernel oracles).

``sanitize`` checks the pool write path at run time (``REPRO_SANITIZE=1``)
and ``runner.run_all`` drives everything over the JAX package's engine
matrix.  The JAX package's jaxpr passes have no counterpart here.
"""

from repro_torch.analysis.aliasing import check_pool_consistency
from repro_torch.analysis.ast_lint import (lint_file, lint_kernel_oracles,
                                          lint_paths)
from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.analysis.retrace import RetraceDetector, diff_signatures
from repro_torch.analysis.runner import analyze_engine, run_all, run_ast_lint
from repro_torch.analysis.sanitize import SanitizerError, StepSanitizer, install
from repro_torch.analysis.shapes import lint_engine_shapes, step_families

__all__ = [
    "AnalysisReport", "Finding",
    "lint_engine_shapes", "step_families",
    "check_pool_consistency",
    "RetraceDetector", "diff_signatures",
    "lint_paths", "lint_file", "lint_kernel_oracles",
    "SanitizerError", "StepSanitizer", "install",
    "analyze_engine", "run_all", "run_ast_lint",
]
