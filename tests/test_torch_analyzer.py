"""The port's analyzer (``repro_torch.analysis``: ``retrace``, ``ast_lint``,
``runner``) on the CPU, mirroring the JAX package's ``tests/test_analysis.py``:

- seeded faults: each AST rule fires on its planted fault (a free-list
  write outside ``kv_cache.py``, a raw-capacity assert and raise guard, a
  draw from a global generator, numpy's, the standard library's and
  torch's, a wall-clock read in a clock-ruled tree, a kernel package whose
  plain version no test imports) and is quiet on what it allows; the whole
  lint is quiet on the port's own tree, and so is the reference's lint
  there;
- the retrace detector stays quiet on a cache hit, names the argument of a
  planted dtype leak (an int64 position where warmup saw int32) and an
  unwarmed step family;
- ``run_all`` is green on the JAX package's five configurations, with the
  reference's section count, and ``CONFIG_MATRIX`` is the reference's.
"""

import pytest
import torch

from repro.analysis import lint_paths as jlint_paths
from repro.analysis.runner import CONFIG_MATRIX as JCONFIG_MATRIX
from repro_torch.analysis import (RetraceDetector, diff_signatures,
                                  lint_kernel_oracles, lint_paths, run_all,
                                  run_ast_lint)
from repro_torch.analysis.runner import CONFIG_MATRIX, _repo_dirs, build_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smollm():
    return build_model(device="cpu")


# ---------------------------------------------------------------- AST rules

def test_seeded_free_list_mutation(tmp_path):
    scratch = tmp_path / "scratch.py"
    scratch.write_text(
        "def leak(pool, p):\n"
        "    pool._free.append(p)      # bypasses the double-free check\n"
        "    pool._ref[p] = 1\n"
        "    return len(pool._free)    # a read is allowed\n")
    findings = lint_paths([scratch])
    assert [f.rule for f in findings] == ["allocator-privacy"] * 2
    assert "scratch.py:2" in findings[0].where and "_free" in findings[0].message
    assert "scratch.py:3" in findings[1].where
    owner = tmp_path / "kv_cache.py"
    owner.write_text(scratch.read_text())
    assert lint_paths([owner]) == []


def test_seeded_raw_capacity_assert_and_raise_guard(tmp_path):
    serving = tmp_path / "serving"
    serving.mkdir()
    (serving / "sched_patch.py").write_text(
        "def admit(pool, need):\n"
        "    assert need <= pool.free_pages\n"
        "    if need > pool.num_free:\n"
        "        raise AdmissionError(0, 'page-demand', 'full')\n"
        "    if need > pool.num_available:\n"
        "        raise AdmissionError(0, 'page-demand', 'full')\n"
        "    assert need <= pool.usable_pages\n")
    findings = lint_paths([serving], serving_root=serving)
    assert [f.rule for f in findings] == ["capacity-asserts"] * 2
    assert "free_pages" in findings[0].message and "num_free" in findings[1].message
    assert [int(f.where.rsplit(":", 1)[1]) for f in findings] == [2, 3]
    assert lint_paths([serving]) == []      # outside serving/ the rule is off


def test_seeded_unseeded_randomness(tmp_path):
    bad = tmp_path / "noise.py"
    bad.write_text(
        "import random\n"
        "import numpy as np\n"
        "import torch\n"
        "from torch import randn\n"
        "jitter = random.random()\n"
        "noise = np.random.randn(4)\n"
        "rng = np.random.default_rng()\n"
        "a = torch.randn(4)\n"
        "b = torch.randint(0, 9, (4,))\n"
        "torch.manual_seed(0)\n"
        "torch.cuda.manual_seed(0)\n"
        "c = torch.multinomial(torch.ones(3), 1)\n"
        "ok = np.random.Generator(np.random.Philox(0))\n"
        "ok2 = np.random.default_rng(7)\n"
        "g = torch.Generator().manual_seed(3)\n"
        "ok3 = torch.randn(4, generator=g)\n"
        "ok4 = torch.randperm(5, generator=g)\n")
    findings = lint_paths([bad])
    assert {f.rule for f in findings} == {"unseeded-randomness"}
    lines = sorted(int(f.where.rsplit(":", 1)[1]) for f in findings)
    assert lines == [4, 5, 6, 7, 8, 9, 10, 11, 12]     # the seeded ones pass


def test_seeded_wall_clock(tmp_path):
    obs = tmp_path / "obs"
    obs.mkdir()
    (obs / "timing_patch.py").write_text(
        "import time\n"
        "import time as walltime\n"
        "from time import time as tt\n"
        "def span():\n"
        "    t0 = time.time()\n"
        "    t1 = walltime.time()\n"
        "    t2 = tt()\n"
        "    ok = time.perf_counter()\n"
        "    return t1 - t0, t2, ok\n"
        "def expired(req, now):\n"
        "    return now >= req.deadline\n")
    findings = lint_paths([obs], clock_roots=(obs,))
    assert [f.rule for f in findings] == ["monotonic-clock"] * 3
    assert {int(f.where.rsplit(":", 1)[1]) for f in findings} == {5, 6, 7}
    assert "perf_counter" in findings[0].message
    assert lint_paths([obs]) == []          # outside the clock roots


def test_kernel_oracle_rule(tmp_path):
    kernels = tmp_path / "kernels"
    (kernels / "fancy").mkdir(parents=True)
    (kernels / "fancy" / "ops.py").write_text(
        "from repro_torch.kernels import build\n"
        "def fancy(x):\n"
        "    return build.load_library().repro_fancy(x)\n")
    (kernels / "fancy" / "ref.py").write_text("def fancy_ref():\n    pass\n")
    (kernels / "host_only").mkdir()
    (kernels / "host_only" / "ops.py").write_text("def plan():\n    pass\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_none.py").write_text("import math\n")
    (tests / "test_other.py").write_text(
        "from repro_torch.kernels.fancy.ref import fancy_ref\n")
    findings = lint_kernel_oracles(kernels, tests)
    assert [f.rule for f in findings] == ["kernel-oracle"]   # host_only launches nothing
    assert "fancy" in findings[0].message
    (tests / "test_torch_none.py").write_text(
        "from repro_torch.kernels.fancy.ref import fancy_ref\n")
    assert lint_kernel_oracles(kernels, tests) == []
    (kernels / "fancy" / "ref.py").unlink()
    assert "no ref.py" in lint_kernel_oracles(kernels, tests)[0].message


def test_port_tree_is_clean():
    """The port's lint over its serving, kernels and obs trees (and the
    oracle rule against the tests) finds nothing; neither does the JAX
    package's lint over the same trees."""
    report = run_ast_lint()
    assert report.ok, report.format()
    assert report.sections == ["ast-lint:src", "ast-lint:kernel-oracles"]
    serving, kernels, obs, _ = _repo_dirs()
    assert jlint_paths([serving, kernels, obs], serving_root=serving,
                       clock_roots=(serving, obs)) == []


# ---------------------------------------------------------------- retrace

def _decode(model, params, caches, pos):
    step = model.compiled_step("decode")
    return step(params, caches, torch.zeros((1, 1), dtype=torch.int32), pos, None)


def test_retrace_quiet_on_cache_hit(smollm):
    model, params = smollm
    caches = model.init_cache(1, 16)
    _decode(model, params, caches, torch.tensor(0, dtype=torch.int32))    # warmup
    det = RetraceDetector(model)
    _decode(model, params, caches, torch.tensor(1, dtype=torch.int32))
    assert det.retraces() == [] and det.findings() == []


def test_seeded_dtype_leak_retrace(smollm):
    """Warm the decode step with an int32 position, then call it with an
    int64 one (``torch.tensor(0)``'s default): the detector names ``pos``
    and its dtype."""
    model, params = smollm
    caches = model.init_cache(1, 16)
    _decode(model, params, caches, torch.tensor(0, dtype=torch.int32))
    det = RetraceDetector(model)
    n0 = model.trace_counts["decode"]
    _decode(model, params, caches, torch.tensor(0))                      # the leak
    assert model.trace_counts["decode"] == n0 + 1
    findings = det.findings("leak")
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "post-warmup-trace" and f.where == "leak compiled_step('decode')"
    assert f.detail["diff"] == ["pos: dtype 'torch.int32' -> 'torch.int64'"]
    det.mark()
    assert det.findings() == []


def test_unwarmed_kind_and_diff_signatures():
    class _Model:
        trace_log = [{"kind": "flat", "args": {"token": ((1, 16), "torch.int32")}}]

    m = _Model()
    det = RetraceDetector(m)
    m.trace_log.append({"kind": "paged", "args": {"token": ((3, 1), "torch.int32")}})
    m.trace_log.append({"kind": "flat", "args": {"token": ((1, 24), "torch.int32"),
                                                 "logits_idx": None}})
    rules = [f.rule for f in det.findings()]
    assert rules == ["unwarmed-kind", "post-warmup-trace"]
    assert diff_signatures({"a": ((1,), "x"), "b": None}, {"a": ((2,), "x")}) == \
        ["a: shape (1,) -> (2,)"]
    assert diff_signatures({"a": ((1,), "x")}, {"b": ((1,), "x")}) == \
        ["a: ((1,), 'x') -> absent", "b: absent -> ((1,), 'x')"]


# ---------------------------------------------------------------- the runner

def test_config_matrix_is_the_reference():
    assert CONFIG_MATRIX == JCONFIG_MATRIX


def test_run_all_green():
    report = run_all(device="cpu")
    assert report.ok, report.format()
    # the reference's count (tests/test_analysis.py: at least the two lint
    # sections and four per configuration: shapes, aliasing, retrace,
    # ledger); the port adds its sanitizer's
    assert len(report.sections) == 2 + 5 * len(CONFIG_MATRIX)
    labels = [label for label, _ in JCONFIG_MATRIX]
    for label in labels:
        assert [s.split(":")[1] for s in report.sections
                if s.startswith(label + ":")] == ["shapes", "aliasing", "sanitizer",
                                                   "retrace", "pool-ledger"]


def test_runner_sees_a_planted_retrace(monkeypatch):
    """The drain's retrace report is live: a program made after warmup
    (here the traffic ends with a static decode step, a family the engine
    never warmed) comes back as a finding of that configuration."""
    from repro_torch.analysis import runner
    traffic = runner._traffic

    def leaky(engine, seed=0):
        traffic(engine, seed=seed)
        m = engine.model
        _decode(m, engine.params, m.init_cache(1, 16), torch.tensor(0))

    monkeypatch.setattr(runner, "_traffic", leaky)
    model, params = build_model(device="cpu")
    report = runner.analyze_engine(model, params, "flat", dict(chunk_tokens=16))
    assert [(f.pass_name, f.rule) for f in report.findings] == \
        [("retrace", "unwarmed-kind")], report.format()
    assert report.sections == ["flat:shapes", "flat:aliasing", "flat:sanitizer",
                               "flat:retrace", "flat:pool-ledger"]
