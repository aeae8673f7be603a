"""The analyzer's runner: the AST lint, then each engine configuration of the
JAX package's matrix (monolithic, dense chunked, flat, flat with
speculation, dense chunked with the prefix cache) through the shape-ladder
linter (with ``trace=True`` the static-dims audit of every traced step
family), the KV-write aliasing pass on the traced steps, and (with
``traffic=True``) a sanitized warm drain, the recompile-hazard report and
the pool-ledger audit.  One reduced model backs every engine, so the step
signatures are shared and the matrix runs in test time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import aliasing, ast_lint, retrace, sanitize, shapes
from repro_torch.analysis.report import AnalysisReport, Finding

__all__ = ["CONFIG_MATRIX", "build_model", "analyze_engine", "run_ast_lint",
           "run_all", "fake_engine", "trace_widest"]

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
                slots: int = 2, max_len: int = 64, device="cuda",
                d_head: Optional[int] = None):
    """The reduced float32 model and its parameters (seed 0), shared by
    every analyzed engine; ``d_head`` widens the reduced config's 16-wide
    heads (the card's ragged attention takes 64 and 128 only)."""
    import dataclasses

    from repro_torch.configs import (RunConfig, ShapeSpec, get_config,
                                     reduced_config)
    from repro_torch.models.model import build_model as _build

    cfg = reduced_config(get_config(arch), layers=layers)
    if d_head is not None:
        cfg = dataclasses.replace(cfg, d_head=d_head)
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
                   traffic: bool = True, trace: bool = True,
                   report: Optional[AnalysisReport] = None) -> AnalysisReport:
    """The shape-ladder linter (``trace``: with its static-dims audit),
    the KV-write aliasing pass, then (with ``traffic``) a sanitized drain
    after warmup, its retrace report and the pool-ledger audit, on one
    configuration."""
    from repro_torch.serving.engine import Engine

    report = report if report is not None else AnalysisReport()
    engine = Engine(model, params, device=model.device, **engine_kwargs)
    report.extend(shapes.lint_engine_shapes(engine, label, trace=trace),
                  section=f"{label}:shapes")
    report.extend(aliasing.lint_engine_aliasing(engine, label),
                  section=f"{label}:aliasing")
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


def fake_engine(model, **engine_kwargs):
    """An ``Engine`` over ``model`` whose parameters and caches are fake
    tensors on the model's device (one ``FakeTensorMode``): random-init
    shapes and dtypes from the model's own init on the meta device, so a
    model of any size is built, prepacked and traced at its published
    widths with nothing allocated.  Its steps can be traced
    (:func:`trace_widest`), not run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import MetaGenerator
    from repro_torch.models.model import build_model as _build
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving.engine import Engine

    meta = _build(model.cfg, model.run, model.shape, hw=model.ctx.hw,
                  device="meta")
    params = meta.init(MetaGenerator())
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = tree_map(lambda t: torch.empty_strided(
            tuple(t.shape), t.stride(), dtype=t.dtype, device=model.device), params)
        return Engine(model, fake, device=model.device, **engine_kwargs)


def trace_widest(engine, label: str = "engine") -> dict:
    """The traced passes on ``engine``'s widest step family
    (:func:`repro_torch.analysis.aliasing.widest_family`) from one trace:
    its static-dims and KV-aliasing findings, its :class:`~repro_torch.
    roofline.graph_cost.GraphCost` and the closed-form FLOPs the cost
    model gives it.  ``{"family", "static_dims", "aliasing", "cost",
    "closed_flops", "trace_s"}``; ``cost`` is None when the trace stopped
    on a host sync.  The graph is traced without call sites, and again
    with them only where a finding needs its site named."""
    import time

    from repro_torch.obs.attrib import build_cost_model
    from repro_torch.roofline.graph_cost import graph_cost

    fam = aliasing.widest_family(engine)
    fn, args, roles = aliasing.step_args(engine, fam)
    t0 = time.perf_counter()
    gm, dims = shapes.trace_findings(fn, args, f"{label} {fam}",
                                     device=engine.device, stacks=False)
    trace_s = time.perf_counter() - t0
    alias = ([] if gm is None else
             aliasing.lint_engine_aliasing(engine, label, traced=(gm, args, roles)))
    if gm is not None and (dims or alias):
        gm, dims = shapes.trace_findings(fn, args, f"{label} {fam}",
                                         device=engine.device)
        alias = aliasing.lint_engine_aliasing(engine, label,
                                              traced=(gm, args, roles))
    # the closed form at the model's own tiles (no device query: the
    # engine's tensors may be fake)
    closed = build_cost_model(engine, hw=engine.model.ctx.hw).families[fam].flops
    return {"family": fam, "static_dims": dims, "aliasing": alias,
            "cost": None if gm is None else graph_cost(gm),
            "closed_flops": closed, "trace_s": trace_s}


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


def run_all(*, traffic: bool = True, trace: bool = True, matrix=None,
            device="cuda", log=None, d_head: Optional[int] = None
            ) -> AnalysisReport:
    """Everything: the AST lint, then every configuration of
    ``matrix`` (default :data:`CONFIG_MATRIX`) over one reduced model on
    ``device`` (``d_head``: :func:`build_model`'s)."""
    report = run_ast_lint()
    model, params = build_model(device=device, d_head=d_head)
    for label, kwargs in (matrix if matrix is not None else CONFIG_MATRIX):
        if log:
            log(f"analyzing {label} ...")
        analyze_engine(model, params, label, kwargs, traffic=traffic,
                       trace=trace, report=report)
    return report
