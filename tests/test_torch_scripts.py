"""The port's gate scripts (``scripts/torch/``) and hillclimb
(``experiments/torch/hillclimb.py``) on the CPU, and the host draws that
stand in for ``jax.random`` in the port's examples.

- ``analyze.py --static`` and ``--no-traffic`` (the reduced model's
  engine matrix), ``lint_invariants.py``, ``chaos_smoke.py`` and
  ``report_smoke.py`` return 0 with ``--device cpu``; ``tier1.sh`` runs
  one test file and the report smoke.
- ``lint_invariants.py`` returns 1 on a planted violation: unseeded
  randomness in a copy of a serving module.
- ``chaos_smoke.py`` and ``report_smoke.py`` carry the JAX scripts'
  configurations, plans and request mixes, and print a line per
  configuration (and plan) as they do.
- ``hillclimb.py --cell decode`` writes one JSON per variant with the JAX
  hillclimb's fields.
- Each script raises without a card unless given ``--device cpu``.
- ``sampling.randint`` equals ``jax.random.randint`` bit for bit, and
  ``sampling.normal`` equals ``jax.random.normal`` within an ulp of the
  draws' largest magnitude.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serving import sampling

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel: str):
    path = ROOT / rel
    name = "_sc_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(rel: str, argv: list) -> tuple:
    """(exit code, stdout lines) of the script's ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = load(rel).main(argv)
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("argv", [["--static"], ["--no-traffic"]],
                         ids=["static", "no-traffic"])
def test_analyze_is_clean(argv):
    rc, lines = run_main("scripts/torch/analyze.py", argv + ["--device", "cpu"])
    assert rc == 0 and lines[-1] == "OK: no findings", lines[-5:]


def test_lint_invariants_clean_then_planted(tmp_path):
    rc, lines = run_main("scripts/torch/lint_invariants.py", [])
    assert rc == 0 and lines[-1] == "OK — no findings"
    bad = tmp_path / "serving" / "scheduler.py"
    bad.parent.mkdir()
    src = (ROOT / "src/repro_torch/serving/scheduler.py").read_text()
    bad.write_text(src + "\n\ndef jitter():\n    return np.random.rand()\n")
    rc, lines = run_main("scripts/torch/lint_invariants.py",
                         ["--no-oracles", str(bad)])
    assert rc == 1 and lines[-1] == "1 finding(s)"
    assert "unseeded-randomness" in lines[0] and "np.random.rand" in lines[0]


def test_chaos_smoke_holds_identity():
    port, ref = load("scripts/torch/chaos_smoke.py"), load("scripts/chaos_smoke.py")
    assert port.CONFIGS == ref.CONFIGS and port.PLANS == ref.PLANS
    assert [(p.tolist(), n) for p, n in port._requests(512)] == \
        [(p.tolist(), n) for p, n in ref._requests(512)]
    rc, lines = run_main("scripts/torch/chaos_smoke.py", ["--device", "cpu"])
    assert rc == 0, lines
    ok = [line.split(":")[0] for line in lines if line.startswith("ok   ")]
    assert ok == [f"ok   {c} / {p}" for c in ref.CONFIGS for p in ref.PLANS]
    assert lines[-1].startswith("chaos smoke: identity under chaos holds")


def test_report_smoke_is_clean():
    port, ref = load("scripts/torch/report_smoke.py"), load("scripts/report_smoke.py")
    assert port.CONFIGS == ref.CONFIGS
    assert [(p.tolist(), n) for p, n in port._requests(512)] == \
        [(p.tolist(), n) for p, n in ref._requests(512)]
    rc, lines = run_main("scripts/torch/report_smoke.py", ["--device", "cpu"])
    assert rc == 0, lines
    ok = [line.split(":")[0] for line in lines if line.startswith("  ok    ")]
    assert ok == [f"  ok    {c}" for c in ref.CONFIGS]
    assert lines[-1] == "report_smoke: OK"


def test_tier1_runs_tests_and_a_gate():
    proc = subprocess.run(
        ["bash", "scripts/torch/tier1.sh", "--device", "cpu", "--report",
         "tests/test_torch_hardware.py", "-k", "presets or query", "-p",
         "no:cacheprovider"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert " passed" in proc.stdout and "report_smoke: OK" in proc.stdout


FIELDS = ("compute_s", "memory_s", "collective_s", "bottleneck",
          "memory_per_device")


def test_hillclimb_writes_a_record_per_variant(tmp_path):
    port, ref = load("experiments/torch/hillclimb.py"), _jax_hillclimb()
    assert port.CELLS == ref["CELLS"]
    assert set(port.VARIANTS) == set(ref["VARIANTS"])
    rc, lines = run_main("experiments/torch/hillclimb.py",
                         ["--cell", "decode", "--device", "cpu",
                          "--out", str(tmp_path)])
    assert rc == 0, lines
    variants = port.CELLS["decode"][2]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(f"decode_{v}.json" for v in variants)
    for v in variants:
        rec = json.loads((tmp_path / f"decode_{v}.json").read_text())
        assert rec["variant"] == v and all(k in rec for k in FIELDS), v
        mem = rec["memory_per_device"]
        assert mem["temp_size_in_bytes"] == mem["peak_bytes"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert len(lines) == len(variants) and all("bound=" in l for l in lines)


def _jax_hillclimb() -> dict:
    """The JAX hillclimb's CELLS and its VARIANTS' names, read from its source
    (importing it would set XLA_FLAGS for this process)."""
    import ast
    tree = ast.parse((ROOT / "experiments/hillclimb.py").read_text())
    out = {}
    for node in tree.body:
        name = getattr(node.targets[0], "id", None) if isinstance(node, ast.Assign) else None
        if name == "CELLS":
            out["CELLS"] = ast.literal_eval(node.value)
        elif name == "VARIANTS":
            out["VARIANTS"] = [k.value for k in node.value.keys]
    return out


@pytest.mark.parametrize("rel", [
    "scripts/torch/analyze.py", "scripts/torch/chaos_smoke.py",
    "scripts/torch/report_smoke.py", "experiments/torch/hillclimb.py"])
def test_scripts_need_a_card_unless_cpu(rel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(rel).main([])


# --------------------------------------------------------------------------
# the host's jax.random draws
# --------------------------------------------------------------------------

KEYS = {"plain": sampling.prng_key(1),
        "fold_in": sampling.fold_in(sampling.prng_key(1), 5)}


@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("shape", [(37,), (2, 32)], ids=["n", "2x32"])
@pytest.mark.parametrize("span", [7, 33, 100, 49152, 151936])
def test_randint_equals_jax(span, shape, key):
    k = KEYS[key]
    want = np.asarray(jax.random.randint(jnp.asarray(k), shape, 0, span))
    got = sampling.randint(k, shape, 0, span)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    lo = 3
    assert np.array_equal(sampling.randint(k, shape, lo, lo + span),
                          np.asarray(jax.random.randint(jnp.asarray(k), shape,
                                                        lo, lo + span)))


@pytest.mark.parametrize("shape", [(1000, 333), (4, 32, 576), (7,)])
@pytest.mark.parametrize("key", list(KEYS))
def test_normal_within_an_ulp_of_jax(shape, key):
    k = KEYS[key]
    want = np.asarray(jax.random.normal(jnp.asarray(k), shape))
    got = sampling.normal(k, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= 2 * ulp
