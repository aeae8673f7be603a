"""The port's serving engine vs the JAX package's on the flat step, and the
port's standing rules.

- The same request trace (reduced SmolLM2, float32, the reference's
  parameters) through the JAX ``Engine`` and the port's
  ``Engine(device="cpu")``: identical tokens, finish reasons, preemption
  and pause counts and flat-step counters, with an ample pool and with a
  pool small enough to force preemptions and mid-prefill pauses.
- No module of the port, not chip_smoke.py, and none of the port's
  examples, gate scripts and hillclimb (``examples/torch/``,
  ``scripts/torch/``, ``experiments/torch/``) imports jax or the JAX
  package (an AST scan).
- ``build_model`` and ``Engine`` default to the card and raise without
  one unless ``device="cpu"`` is passed, sampled, prefix-cache,
  speculative and static (whisper) engines included; those run on the CPU,
  as does the standalone ``DraftModelDrafter.propose`` (the dense decode
  step) over a CPU model, and ``flat=True`` without ``chunk_tokens``
  raises; so does every ``main`` of those examples and scripts.
"""

import ast
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    jm = jbuild_model(jcfg, JRun(**F32), JShape("serve", 64, 3, "decode"))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec("serve", 64, 3, "decode"),
                    device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _trace(lens, news, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip(lens, news)]


def _drain(eng, reqs):
    rids = [eng.add_request(p, n) for p, n in reqs]
    fin = {r.rid: r for r in eng.drain()}
    assert sorted(fin) == sorted(rids)
    return [(fin[r].out_tokens, fin[r].finish_reason) for r in rids]


CASES = {
    "ample": (dict(chunk_tokens=16, token_budget=24),
              _trace([13, 21, 3, 16, 30], [8, 6, 10, 7, 5], seed=1)),
    "tight": (dict(chunk_tokens=8, num_pages=1 + 6),
              _trace([4, 25, 6, 30, 4, 5], [16, 10, 16, 8, 16, 16], seed=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(models, case):
    jm, jparams, m, params = models
    kw, reqs = CASES[case]
    jeng = JEngine(jm, jparams, max_slots=3, page_tokens=8, **kw)
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8, **kw)
    assert jeng.flat and eng._flat_shapes() == jeng._flat_shapes()
    assert _drain(eng, reqs) == _drain(jeng, reqs)
    assert (eng.num_preemptions, eng.num_pauses) == \
        (jeng.num_preemptions, jeng.num_pauses)
    assert eng.stats()["flat"] == jeng.stats()["flat"]
    assert eng.pool.num_used == 0
    assert eng.pool.total_allocs == eng.pool.total_frees
    if case == "tight":
        assert eng.num_preemptions + eng.num_pauses >= 1


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the port's examples, gate scripts and hillclimb
    surface = [f for d in ("examples", "scripts", "experiments")
               for f in sorted((ROOT / d / "torch").rglob("*.py"))]
    assert len(surface) == 9
    files += surface
    bad = [(f.relative_to(ROOT), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_need_a_card_unless_cpu(models, monkeypatch):
    _, _, m, params = models
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    shape = ShapeSpec("serve", 64, 3, "decode")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, RunConfig(**F32), shape)
    for kw in (dict(chunk_tokens=16), dict(chunk_tokens=16, spec_tokens=2),
               dict(prefix_cache=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(m, params, max_slots=3, **kw)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])
    for kw in (dict(chunk_tokens=16), dict(spec_tokens=2),
               dict(chunk_tokens=16, spec_tokens=2, prefix_cache=True)):
        eng = Engine(m, params, device="cpu", max_slots=3, **kw)
        eng.add_request(np.arange(5), 3, temperature=0.5)
        [req] = eng.drain(greedy=False, seed=1)
        assert len(req.out_tokens) == 3 and eng.pool.num_used == 0
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.speculative import DraftModelDrafter
    drafts = DraftModelDrafter(m, params).propose(
        Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new=4), 2)
    assert len(drafts) == 2 and all(0 <= t < cfg.vocab for t in drafts)
    wcfg = reduced_config(get_config("whisper-small"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(wcfg, RunConfig(**F32), shape)
    wm = build_model(wcfg, RunConfig(**F32), shape, device="cpu")
    wparams = wm.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(wm, wparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "whisper-small", "--reduced"])
    batch = {"tokens": np.arange(8, dtype=np.int32).reshape(2, 4),
             "frames": np.zeros((2, wm.enc_len, wcfg.d_model), np.float32)}
    assert Engine(wm, wparams, device="cpu").generate(batch, 3).shape == (2, 3)
    with pytest.raises(ValueError, match="flat=True needs chunk_tokens"):
        Engine(m, params, device="cpu", max_slots=3, flat=True)
    # the port's examples and gate scripts: the card by default
    for rel in ("examples/torch/quickstart.py", "examples/torch/vl_portability.py",
                "examples/torch/serve_decode.py", "examples/torch/train_smollm.py",
                "scripts/torch/analyze.py", "scripts/torch/chaos_smoke.py",
                "scripts/torch/report_smoke.py", "experiments/torch/hillclimb.py"):
        spec = importlib.util.spec_from_file_location(
            "_card_" + pathlib.Path(rel).stem, ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--steps", "1"] if "train" in rel else [])


def test_nan_guard_retires_only_the_bad_row(models):
    """Non-finite logits in one row retire that request alone as "error"
    (slot and pages returned); the other row decodes as it would alone."""
    _, _, m, params = models
    kw = dict(device="cpu", max_slots=3, page_tokens=8, chunk_tokens=16)
    (p_ok, _), (p_bad, _) = _trace([5, 7], [4, 4], seed=5)
    alone = _drain(Engine(m, params, **kw), [(p_ok, 4)])
    eng = Engine(m, params, **kw)
    run_flat = eng._run_flat

    def poisoned(*a):
        rows = run_flat(*a)
        rows[1] = np.nan                 # the second admission takes slot 1
        return rows

    eng._run_flat = poisoned
    assert _drain(eng, [(p_ok, 4), (p_bad, 4)]) == alone + [([], "error")]
    assert eng.pool.num_used == 0 and not eng.scheduler.has_work


def test_warmup_leaves_the_engine_idle(models):
    _, _, m, params = models
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                 chunk_tokens=16, token_budget=24)
    eng.warmup()
    assert eng.pool.num_used == 0 and not eng.scheduler.has_work
    out = eng.generate({"tokens": np.arange(12).reshape(2, 6)}, 4)
    assert out.shape == (2, 4)
