"""The analyzer's runner: the AST lint, then each engine configuration of the
JAX package's matrix (monolithic, dense chunked, flat, flat with
speculation, dense chunked with the prefix cache) through the shape-ladder
algebra, a sanitized warm drain, the recompile-hazard report and the
pool-ledger audit.  One reduced model backs every engine, so the step
signatures are shared and the matrix runs in test time.

The JAX package's jaxpr passes (``lint_engine_aliasing`` and
``lint_engine_shapes(trace=True)``) have no PyTorch counterpart and are
skipped; the sanitizer checks every KV write of the drain instead.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import aliasing, ast_lint, retrace, sanitize, shapes
from repro_torch.analysis.report import AnalysisReport, Finding

__all__ = ["CONFIG_MATRIX", "build_model", "analyze_engine", "run_ast_lint",
           "run_all"]

# the JAX package's matrix (src/repro/analysis/runner.py): reduced-scale
# chunks that still give the chunk ladder more than one rung and the flat
# ladder its cap and sub-widths
CONFIG_MATRIX = [
    ("monolithic", dict()),
    ("chunked-dense", dict(chunk_tokens=16, flat=False)),
    ("flat", dict(chunk_tokens=16)),
    ("flat-spec", dict(chunk_tokens=16, spec_tokens=2)),
    ("chunked-prefix", dict(chunk_tokens=16, flat=False, prefix_cache=True)),
]


def build_model(arch: str = "smollm2-135m", *, layers: int = 2,
                slots: int = 2, max_len: int = 64, device="cuda"):
    """The reduced float32 model and its parameters (seed 0), shared by
    every analyzed engine."""
    from repro_torch.configs import (RunConfig, ShapeSpec, get_config,
                                     reduced_config)
    from repro_torch.models.model import build_model as _build

    cfg = reduced_config(get_config(arch), layers=layers)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    remat=False)
    model = _build(cfg, run, ShapeSpec("serve", max_len, slots, "decode"),
                   device=device)
    return model, model.init(torch.Generator().manual_seed(0))


def _traffic(engine, *, seed: int = 0) -> None:
    """The JAX package's drain: mixed prompt lengths, a shared prefix for
    the cache configurations, and one request cancelled mid-flight, so the
    sanitizer's retired-rid and zero-leak checks meet real traffic."""
    rng = np.random.Generator(np.random.Philox(seed))
    shared = rng.integers(1, 50, size=12).astype(np.int32)
    prompts = [
        np.concatenate([shared, rng.integers(1, 50, size=5).astype(np.int32)]),
        rng.integers(1, 50, size=21).astype(np.int32),
        np.concatenate([shared, rng.integers(1, 50, size=2).astype(np.int32)]),
        rng.integers(1, 50, size=3).astype(np.int32),
    ]
    rids = [engine.add_request(p, n) for p, n in zip(prompts, [6, 5, 7, 4])]
    engine.step(greedy=True, seed=seed)
    engine.cancel(rids[2])
    engine.drain(greedy=True, seed=seed)


def analyze_engine(model, params, label: str, engine_kwargs: dict, *,
                   traffic: bool = True,
                   report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """The ladder algebra, then (with ``traffic``) a sanitized drain after
    warmup, its retrace report and the pool-ledger audit, on one
    configuration."""
    from repro_torch.serving.engine import Engine

    report = report if report is not None else AnalysisReport()
    engine = Engine(model, params, device=model.device, **engine_kwargs)
    report.extend(shapes.lint_engine_shapes(engine, label),
                  section=f"{label}:shapes")
    if traffic:
        san = sanitize.install(engine)
        det = retrace.RetraceDetector(model)
        engine.warmup()
        det.mark()
        _traffic(engine)
        idle = [] if san.checks else [Finding(
            "sanitizer", "no-checks", label,
            "the sanitizer checked no model call: it is not on the path")]
        report.extend(idle, section=f"{label}:sanitizer")
        report.extend(det.findings(label), section=f"{label}:retrace")
        report.extend(aliasing.check_pool_consistency(engine, label),
                      section=f"{label}:pool-ledger")
    return report


def _repo_dirs():
    pkg = Path(__file__).resolve().parent.parent
    return (pkg / "serving", pkg / "kernels", pkg / "obs",
            pkg.parent.parent / "tests")


def run_ast_lint(report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """The AST lint over the port's serving, kernels and obs trees, and
    the kernel-oracle rule against the tests."""
    report = report if report is not None else AnalysisReport()
    serving_dir, kernels_dir, obs_dir, tests_dir = _repo_dirs()
    report.extend(ast_lint.lint_paths([serving_dir, kernels_dir, obs_dir],
                                      serving_root=serving_dir,
                                      clock_roots=(serving_dir, obs_dir)),
                  section="ast-lint:src")
    if tests_dir.is_dir():
        report.extend(ast_lint.lint_kernel_oracles(kernels_dir, tests_dir),
                      section="ast-lint:kernel-oracles")
    return report


def run_all(*, traffic: bool = True, matrix=None, device="cuda",
            log=None) -> AnalysisReport:
    """Everything: the AST lint, then every configuration of
    ``matrix`` (default :data:`CONFIG_MATRIX`) over one reduced model on
    ``device``."""
    report = run_ast_lint()
    model, params = build_model(device=device)
    for label, kwargs in (matrix if matrix is not None else CONFIG_MATRIX):
        if log:
            log(f"analyzing {label} ...")
        analyze_engine(model, params, label, kwargs, traffic=traffic,
                       report=report)
    return report
