"""The port's examples (``examples/torch/``) against the JAX package's
(``examples/``), each run in this process at the JAX example's reduced size,
and the port's public names against the reference's.

- quickstart: the same descriptor and tile lines; the port's products pass
  the JAX example's tolerances (the example raises otherwise).
- vl_portability: the same table of tiles, and the port's logits equal the
  JAX example's within 1e-5 under every descriptor, over the JAX example's
  own weights (recorded from its ``init``, carried by ``from_jax_params``).
- serve_decode: the same per-request lines (rid, arrival, prompt length,
  tokens) plain, with an undersized pool, with ``--chunk-tokens 16``, with
  ``--spec-tokens 3`` and with ``--prefix-cache``; ``--sample`` under the
  1e-5 perturbed-margin rule; whisper through the static batch loop; the
  port's Prometheus text passes the JAX package's ``lint_prometheus``, and
  its tokens are unchanged by telemetry.
- train_smollm: 4 steps of loss history within 1e-5 relative of the JAX
  example's, from the JAX example's initial parameters.
- Every public name of a module of the JAX package exists in its port
  counterpart, but for an allow-list whose entries say why each is not
  carried over.

The JAX examples run through their own ``main`` with a patched
``sys.argv`` and captured stdout; their weights and results are recorded
by wrapping the JAX package's methods the examples call.
"""

import ast
import contextlib
import importlib.util
import io
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models.model import ReproModel as JReproModel
from repro.obs.export import lint_prometheus as jlint_prometheus
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs import get_config, reduced_config
from repro_torch.serving import sampling
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MARGIN = 1e-5       # the sampled-pick rule of tests/test_torch_sampling.py


def load(rel: str):
    """A script of the repo as a module (the examples are no package)."""
    path = ROOT / rel
    name = "_ex_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(rel: str, argv: list, monkeypatch) -> list:
    """The JAX example's ``main`` under ``argv``; its stdout lines."""
    mod = load(rel)
    monkeypatch.setattr(sys, "argv", [rel, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue().splitlines()


def record(monkeypatch, cls, name: str, into: list, convert=np.asarray):
    """Wrap ``cls.name`` so each call's result is appended to ``into``
    (through ``convert``)."""
    orig = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        into.append(convert(out))
        return out
    monkeypatch.setattr(cls, name, wrapped)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# quickstart and vl_portability
# --------------------------------------------------------------------------

def test_quickstart_tiles_equal_jax(monkeypatch):
    want = run_jax("examples/quickstart.py", [], monkeypatch)
    got = []
    res = load("examples/torch/quickstart.py").run("cpu", log=got.append)
    assert got[:4] == want[:4]          # the descriptor and the tile lines
    assert got[4].endswith("OK") and got[-1].endswith("OK")
    assert [line.split("->")[0] for line in got[5:8]] == \
        [line.split("->")[0] for line in want[5:8]]
    assert res["hw"] == "tpu_v5e" and res["errs"]["unpacked"] == 0.0


def test_vl_portability_tiles_and_logits_equal_jax(monkeypatch):
    params, logits = [], []
    record(monkeypatch, JReproModel, "init", params, to_numpy)
    record(monkeypatch, JReproModel, "forward", logits,
           lambda out: np.asarray(out[0]))
    want = run_jax("examples/vl_portability.py", [], monkeypatch)
    got = []
    res = load("examples/torch/vl_portability.py").run(
        params=from_jax_params(params[0]), device="cpu", log=got.append)
    # header, three rows of (hardware, scalable tiles, fixed tiles), note
    assert got[0] == want[0] and got[-1] == want[-1]
    assert [row.split()[:3] for row in got[1:4]] == \
        [row.split()[:3] for row in want[1:4]]
    assert len(res["rows"]) == len(logits) == 3
    for row, ref in zip(res["rows"], logits):
        np.testing.assert_allclose(row["logits"], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=row["hw"])


# --------------------------------------------------------------------------
# serve_decode
# --------------------------------------------------------------------------

SMALL = ["--requests", "4", "--new-tokens", "16"]
SERVE_MODES = {
    "plain": SMALL,
    "tight-pool": ["--requests", "8", "--pool-pages", "6", "--new-tokens", "24"],
    "chunked": SMALL + ["--chunk-tokens", "16"],
    "spec": SMALL + ["--spec-tokens", "3"],
    "prefix-cache": SMALL + ["--prefix-cache"],
}


@pytest.fixture(scope="module")
def serve_params():
    """The JAX example's weights: its model's ``init(PRNGKey(0))``."""
    from repro.configs import RunConfig as JRun
    from repro.configs import ShapeSpec as JShape
    from repro.configs import get_config as jget_config
    from repro.configs import reduced_config as jreduced
    from repro.models.model import build_model as jbuild_model
    jm = jbuild_model(jreduced(jget_config("smollm2-135m")),
                      JRun(param_dtype="float32", compute_dtype="float32",
                           remat=False), JShape("serve", 128, 4, "decode"))
    return from_jax_params(to_numpy(jm.init(jax.random.PRNGKey(0))))


def serve_port(argv, params):
    ex = load("examples/torch/serve_decode.py")
    args = ex.parse_args(argv + ["--device", "cpu"])
    lines = []
    res = ex.serve(reduced_config(get_config(args.arch)), args, params=params,
                   device="cpu", log=lambda m: lines.extend(str(m).splitlines()))
    return lines, res


def request_lines(lines) -> list:
    return [line for line in lines if line.startswith("  rid=")]


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_decode_requests_equal_jax(mode, serve_params, monkeypatch, tmp_path):
    argv = SERVE_MODES[mode]
    want = request_lines(run_jax("examples/serve_decode.py", argv, monkeypatch))
    extra = (["--report", str(tmp_path / "drain")] if mode == "plain" else [])
    lines, res = serve_port(argv + extra, serve_params)
    got = request_lines(lines)
    assert len(want) == int(argv[1]) and got == want
    if mode == "tight-pool":
        assert res["engine"].num_preemptions > 0
    if mode == "plain":   # telemetry on: the tokens above are unchanged
        prom = (tmp_path / "drain.prom").read_text()
        assert jlint_prometheus(prom) == []
        assert (tmp_path / "drain.html").stat().st_size > 0


def test_serve_decode_static_whisper_equals_jax(monkeypatch):
    """encdec takes the static batch loop: the JAX example's weights and
    batch (its frames ``jax.random.normal``, drawn on the host within an
    ulp), the same generated tokens."""
    argv = ["--arch", "whisper-small", "--slots", "2", "--max-prompt", "8",
            "--new-tokens", "4"]
    params = []
    record(monkeypatch, JReproModel, "init", params, to_numpy)
    want = run_jax("examples/serve_decode.py", argv, monkeypatch)
    lines, res = serve_port(argv, from_jax_params(params[0]))
    assert lines[0] == want[0]
    assert res["static"].tolist() == \
        [[int(t) for t in row.strip(" []").split()] for row in want[1:]]


def _tokens(line: str) -> list:
    return [int(t) for t in line.split(": [")[1].rstrip("]").split(", ") if t]


def test_serve_decode_sampled_under_the_margin_rule(serve_params, monkeypatch):
    """``--sample``: each request's printed tokens equal the JAX example's,
    or part from them first at a pick whose perturbed top-2 margin is
    below MARGIN (the host's noise is within 2 ulp of XLA's)."""
    argv = SMALL + ["--sample"]
    want = request_lines(run_jax("examples/serve_decode.py", argv, monkeypatch))
    margins, pick = {}, Engine._pick

    def recording(self, row, req, greedy, seed):
        if not greedy and req.temperature > 0:
            s = seed if req.seed is None else req.seed
            z = row / np.float32(req.temperature) if req.temperature != 1.0 else row
            z = z + sampling.gumbel(
                sampling.pick_key(s, req.rid, len(req.out_tokens)), row.shape[0])
            top2 = np.sort(z)[-2:]
            margins[(req.rid, len(req.out_tokens))] = float(top2[1] - top2[0])
        return pick(self, row, req, greedy, seed)
    monkeypatch.setattr(Engine, "_pick", recording)
    got = request_lines(serve_port(argv, serve_params)[0])
    assert margins and len(got) == len(want)
    for rid, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        assert a.split(":")[0] == b.split(":")[0], (a, b)
        pos = next(i for i, (x, y) in enumerate(zip(_tokens(a), _tokens(b)))
                   if x != y)
        assert margins.get((rid, pos), np.inf) < MARGIN, (rid, pos)


# --------------------------------------------------------------------------
# train_smollm
# --------------------------------------------------------------------------

def test_train_smollm_losses_equal_jax(monkeypatch, tmp_path):
    argv = ["--steps", "4", "--seq", "32", "--batch", "4", "--microbatch", "2"]
    states, fits = [], []
    record(monkeypatch, JTrainer, "init_state", states,
           lambda st: to_numpy(st.params))
    record(monkeypatch, JTrainer, "fit", fits, lambda out: list(out[1]))
    want = run_jax("examples/train_smollm.py",
                   argv + ["--ckpt-dir", str(tmp_path / "jax")], monkeypatch)
    ex = load("examples/torch/train_smollm.py")
    args = ex.parse_args(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = []
    res = ex.train(ex.config(args), args, params=from_jax_params(states[0]),
                   device="cpu", log=got.append)
    assert len(res["history"]) == len(fits[0]) == 4
    np.testing.assert_allclose(res["history"], fits[0], rtol=1e-5)
    assert got[-1].split(" loss")[0] == want[-1].split(" loss")[0]


# --------------------------------------------------------------------------
# public names
# --------------------------------------------------------------------------

# reference module -> the port module that holds its names, where the file
# differs
MOVED = {
    "analysis/jaxpr_tools.py": "analysis/graph_tools.py",
    "roofline/hlo_cost.py": "roofline/graph_cost.py",
    "roofline/hlo_parse.py": "roofline/graph_cost.py",
    "kernels/mmt4d/kernel.py": None, "kernels/pack/kernel.py": None,
    "kernels/unpack/kernel.py": None, "kernels/ragged_attn/kernel.py": None,
}

# public names of the JAX package with no counterpart of that name in the
# port, and why
ALLOWED = {
    # JAX's own machinery
    "models/model.py:ReproModel.jit_step":
        "jax.jit of a step; the port's steps are CompiledStep (CUDA graphs)",
    "core/propagation.py:PackedArray.tree_flatten": "a JAX pytree hook",
    "core/propagation.py:PackedArray.tree_unflatten": "a JAX pytree hook",
    "training/train_state.py:TrainState.tree_flatten": "a JAX pytree hook",
    "training/train_state.py:TrainState.tree_unflatten": "a JAX pytree hook",
    "launch/dryrun.py:build_lowerable":
        "builds a jit for XLA to lower; the port's dry-run reckons costs "
        "from meta trees (build_cell, cell_counts)",
    "models/moe.py:constrain_blocks":
        "a GSPMD sharding constraint; the port has no partitioner to steer",
    "core/linear.py:MatmulContext.constrain":
        "a GSPMD sharding constraint; across ranks the port computes each "
        "rank's shard eagerly and linear_apply(tp=) makes its collectives "
        "itself (distributed/comm.py)",
    "models/common.py:constrain_stream":
        "a GSPMD constraint of the stream's batch dim to the data axes; the "
        "port has no partitioner to steer",
    **{f"models/{m}.py:Array": "the jnp.ndarray type alias; the port "
       "annotates torch.Tensor" for m in ("attention", "common", "encdec",
                                          "mamba", "model", "moe", "rwkv6",
                                          "transformer")},
    # the Pallas kernels, whose places the CUDA sources and ref.py take
    "kernels/mmt4d/kernel.py": "a Pallas kernel: csrc/mmt4d.cu",
    "kernels/pack/kernel.py": "a Pallas kernel: csrc/pack.cu",
    "kernels/unpack/kernel.py": "a Pallas kernel: csrc/unpack.cu",
    "kernels/ragged_attn/kernel.py": "a Pallas kernel: csrc/ragged_attn.cu",
    "kernels/mmt4d/ops.py:pick_blocks":
        "the Pallas grid's VMEM blocks; the CUDA kernel's decomposition is "
        "pick_split",
    "kernels/mmt4d/ops.py:mmt4d_reference": "became kernels/mmt4d/ref.py:mmt4d_ref",
    "kernels/pack/ops.py:pack_reference": "became kernels/pack/ref.py:pack_ref",
    "kernels/unpack/ops.py:unpack_reference":
        "became kernels/unpack/ref.py:unpack_ref",
    "kernels/ragged_attn/ops.py:ragged_attention_reference":
        "became kernels/ragged_attn/ref.py:ragged_attention_ref",
    # the XLA program readers, whose place the aten graph's take
    "analysis/jaxpr_tools.py:*": "jaxpr walking became analysis/graph_tools.py "
                                 "(aten graphs of make_fx)",
    "roofline/hlo_cost.py:*": "HloCost became roofline/graph_cost.py:GraphCost",
    "roofline/hlo_parse.py:*": "parse_hlo became roofline/graph_cost.py "
                               "(the traced graph, no HLO text)",
    # the epilogue carries an activation name into the kernel, not a
    # callable applied in the packed domain
    "core/mmt4d.py:Epilogue.apply_packed":
        "the mmt4d kernel applies the bias and activation itself "
        "(Epilogue.bias_pack packs the bias for it)",
    "core/mmt4d.py:Epilogue.has_bias":
        "the bias travels as an argument (None: no bias)",
}


def public_names(path: pathlib.Path) -> set:
    """Module-level functions, classes and assignments, each class's
    methods and fields, and ``__all__``; no imported name unless exported;
    no name with a leading underscore."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(f"{node.name}.{sub.name}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    names.add(f"{node.name}.{sub.target.id}")
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not any(p.startswith("_") for p in n.split("."))}


def test_public_names_of_the_reference_exist_in_the_port():
    ref_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing, pairs = [], 0
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        target = MOVED.get(rel, rel)
        if target is None:
            if rel not in ALLOWED:
                missing.append(rel)
            continue
        pairs += 1
        have = public_names(port_root / target)
        for name in sorted(public_names(ref) - have):
            if f"{rel}:{name}" not in ALLOWED and f"{rel}:*" not in ALLOWED:
                missing.append(f"{rel}:{name}")
    assert pairs > 50
    assert not missing, missing
    # every allow-list entry still names something the reference has
    for key in ALLOWED:
        rel, _, name = key.partition(":")
        assert (ref_root / rel).exists(), key
        if name and name != "*":
            assert name in public_names(ref_root / rel), key


def test_core_exports_the_reference_surface():
    import repro.core as jcore
    import repro_torch.core as core
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert hasattr(core, name), name
