"""Checks of the serving stack's contracts, the JAX package's analyzer on
the port:

1. ``shapes``: the shape-ladder linter's algebra (m_r alignment, ladder
   membership, the step families warmup makes) and, with ``trace=True``,
   the static-dims audit of every traced step family;
2. ``aliasing``: the KV-write taint pass over the traced steps (every pool
   write indexed through the block-table gather and the trash-page route)
   and the allocator audit (refcounts against the holders);
3. ``retrace``: the recompile-hazard detector (names the argument of any
   program made after warmup);
4. ``ast_lint``: the AST lint (allocator privacy, capacity guards,
   unseeded randomness, the monotonic clock, kernel oracles).

``sanitize`` checks the pool write path at run time (``REPRO_SANITIZE=1``)
and ``runner.run_all`` drives everything over the JAX package's engine
matrix.  The traced passes read the aten graph ``make_fx`` records of a
step run on fake tensors (``graph_tools``, the JAX package's
``jaxpr_tools``), in which each kernel of the port is one
``torch.ops.repro_torch`` node.
"""

from repro_torch.analysis.aliasing import (check_pool_consistency,
                                          lint_engine_aliasing, lint_kv_writes,
                                          taint_step)
from repro_torch.analysis.ast_lint import (lint_file, lint_kernel_oracles,
                                          lint_paths)
from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.analysis.retrace import RetraceDetector, diff_signatures
from repro_torch.analysis.runner import analyze_engine, run_all, run_ast_lint
from repro_torch.analysis.sanitize import SanitizerError, StepSanitizer, install
from repro_torch.analysis.graph_tools import (TaintWalker, TraceError,
                                              WriteSite, iter_nodes, node_where,
                                              trace_step)
from repro_torch.analysis.shapes import (check_static_dims, lint_engine_shapes,
                                         step_families)

__all__ = [
    "AnalysisReport", "Finding",
    "lint_engine_shapes", "step_families", "check_static_dims",
    "taint_step", "lint_kv_writes", "lint_engine_aliasing",
    "check_pool_consistency",
    "trace_step", "iter_nodes", "node_where", "TaintWalker", "TraceError",
    "WriteSite",
    "RetraceDetector", "diff_signatures",
    "lint_paths", "lint_file", "lint_kernel_oracles",
    "SanitizerError", "StepSanitizer", "install",
    "analyze_engine", "run_all", "run_ast_lint",
]
