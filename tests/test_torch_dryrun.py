"""The port's dry-run (``repro_torch/launch/dryrun.py``) and roofline
(``repro_torch/roofline/``), the counterpart of ``tests/test_dryrun.py``
and ``tests/test_roofline.py``, on the CPU:

- the cell matrix as the reference's: 40 cells, 8 skipped, all
  ``long_500k``, the same architectures;
- every one of the 32 runnable cells on both production meshes priced
  ``ok`` from meta trees, with every tree leaf on the meta device and
  under 4 MB of tensors made anywhere else (counted by a dispatch mode
  over every op the cell runs);
- ``model_flops`` equal to the reference's for every cell, exactly, and
  ``test_model_flops_kinds`` ported;
- ``serving_cell`` on reduced SmolLM2 against the reference's record
  (run in a subprocess: importing the reference's dry-run sets
  ``XLA_FLAGS``): pages, page tokens, chunk and token budget, KV bytes
  per token, the block table's gather bytes, and the cost model's family
  labels, widths, FLOPs (relative 1e-9: SmolLM2 under the scalable tiles
  has none of the C7/C8 terms ``tests/test_torch_attrib.py`` adds back),
  KV-gather bytes, peak and bandwidth;
- the launcher's CLI writing records that ``roofline.report`` renders;
- a meta tensor reaching a kernel wrapper, or a model step on meta
  weights, raises (no plain version takes it);
- the bytes a one-rank mesh's device holds equal the trees' bytes;
- on one device the products read off the parameter leaves are the cost
  model's product list (``obs/attrib.py``) for every architecture, train
  and decode; on a mesh each is split over "model" as its weight's spec
  says (SmolLM2's tied head by its vocab, K and V whole below the KV
  heads' count, attention whole where the heads do not divide the axis);
- microbatches leave the FLOPs and cut the transients and add weight
  reads.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.roofline.analysis import model_flops as jmodel_flops
from repro_torch.configs import (SHAPES, RunConfig, ShapeSpec, cell_status, cells,
                                 get_config, reduced_config)
from repro_torch.core.hardware import presets
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ABSTRACT_MESHES, AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.roofline import report
from repro_torch.roofline.analysis import model_flops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = presets["tpu_v5e"]
RUN = RunConfig(microbatch=8)


def test_cell_matrix_skips():
    all_cells = list(cells(include_skipped=True))
    assert len(all_cells) == 40
    assert [c[:3] for c in all_cells] == [c[:3] for c in jcells(include_skipped=True)]
    skipped = [c for c in all_cells if not c[2]]
    assert len(skipped) == 8
    assert all(s == "long_500k" for _, s, _, _ in skipped)
    assert {a for a, *_ in skipped} == {
        "qwen2-7b", "qwen3-8b", "olmo-1b", "chatglm3-6b", "whisper-small",
        "qwen3-moe-235b-a22b", "arctic-480b", "internvl2-26b"}
    assert {a for a, s, ok, _ in all_cells if s == "long_500k" and ok} == {
        "jamba-v0.1-52b", "rwkv6-1.6b"}
    assert not cell_status(get_config("qwen2-7b"), SHAPES["long_500k"])[0]


class _NonMeta(TorchDispatchMode):
    """Bytes of every tensor an op makes off the meta device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.bytes += t.numel() * t.element_size()
        return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if hasattr(tree, "opt_state"):
        return _leaves(tree.params) + _leaves(tree.opt_state)
    return [tree] if isinstance(tree, torch.Tensor) else []


RUNNABLE = [(a, s) for a, s, ok, _ in cells() if ok]


@pytest.mark.parametrize("arch", sorted({a for a, _ in RUNNABLE}))
def test_every_cell_priced_from_meta_trees(arch):
    for a, shape in RUNNABLE:
        if a != arch:
            continue
        for mesh_name in ABSTRACT_MESHES:
            with _NonMeta() as mode:
                cell = dryrun.build_cell(get_config(arch), SHAPES[shape], RUN,
                                         ABSTRACT_MESHES[mesh_name], HW)
                rec = dryrun.run_cell(arch, shape, mesh_name, RUN, verbose=False,
                                      hw=HW)
            assert mode.bytes < 4 * 2**20, (arch, shape, mesh_name, mode.bytes)
            assert all(t.device.type == "meta"
                       for tree in cell.trees.values() for t in _leaves(tree))
            assert rec["status"] == "ok" and rec["prediction"]
            assert rec["chips"] == (256 if mesh_name == "pod" else 512)
            assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
            assert rec["bottleneck"] in ("compute", "memory", "collective")
            assert rec["step_time_bound_s"] == max(rec["compute_s"], rec["memory_s"],
                                                   rec["collective_s"])
            mem = rec["memory_per_device"]
            assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
            assert rec["model_flops"] == jmodel_flops(jget_config(arch), JSHAPES[shape])
            if mesh_name == "multipod":      # the pod axis shards: collectives
                assert rec["collective_bytes_per_chip"] > 0


def test_model_flops_kinds():
    cfg = get_config("qwen2-7b")
    n = cfg.param_counts()["active"]
    assert model_flops(cfg, SHAPES["train_4k"]) == 6.0 * n * 256 * 4096
    assert model_flops(cfg, SHAPES["prefill_32k"]) == 2.0 * n * 32 * 32768
    assert model_flops(cfg, SHAPES["decode_32k"]) == 2.0 * n * 128
    moe = get_config("qwen3-moe-235b-a22b")
    assert (model_flops(moe, SHAPES["train_4k"])
            == 6.0 * moe.param_counts()["active"] * 256 * 4096)
    for arch, shape, ok, _ in cells(include_skipped=True):
        assert model_flops(get_config(arch), SHAPES[shape]) == \
            jmodel_flops(jget_config(arch), JSHAPES[shape]), (arch, shape)


_SERVING = textwrap.dedent("""
    import json, sys
    from repro.configs import RunConfig, get_config, reduced_config
    from repro.launch import dryrun
    dryrun.get_config = lambda a: reduced_config(get_config(a), layers=2)
    rec = dryrun.serving_cell("smollm2-135m", RunConfig(), slots=4, max_len=256,
                              page_tokens=16, chunk_tokens=64, verbose=False)
    print("RESULT " + json.dumps(rec))
""")


def test_serving_cell_matches_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=1")
    p = subprocess.run([sys.executable, "-c", _SERVING], capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    want = json.loads([l for l in p.stdout.splitlines()
                       if l.startswith("RESULT ")][-1][len("RESULT "):])
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    with _NonMeta() as mode:
        got = dryrun.serving_cell("smollm2-135m", RunConfig(), slots=4, max_len=256,
                                  page_tokens=16, chunk_tokens=64, verbose=False,
                                  hw=HW, cfg=cfg)
    assert mode.bytes < 4 * 2**20
    for k in ("status", "arch", "kind", "slots", "max_len", "page_tokens",
              "num_pages", "chunk_tokens", "token_budget", "spec_tokens",
              "kv_bytes_per_token", "block_table_gather_bytes",
              "block_table_gather_s"):
        assert got[k] == want[k], k
    cm, jcm = got["cost_model"], want["cost_model"]
    for k in ("hw", "dtype", "peak_flops", "hbm_bw", "flops_per_token"):
        assert cm[k] == jcm[k], k
    assert list(cm["families"]) == list(jcm["families"])
    for label, fc in cm["families"].items():
        jfc = jcm["families"][label]
        assert fc["width"] == jfc["width"], label
        assert fc["flops"] == pytest.approx(jfc["flops"], rel=1e-9), label
        assert fc["kv_gather_bytes"] == jfc["kv_gather_bytes"], label


def test_cli_writes_records_the_report_renders(tmp_path, capsys):
    out = str(tmp_path / "dry")
    dryrun.main(["--arch", "smollm2-135m", "--shape", "train_4k", "--mesh", "both",
                 "--device", "cpu", "--out", out])
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh", "pod",
                 "--device", "cpu", "--out", out])
    dryrun.main(["--serving", "--arch", "smollm2-135m", "--device", "cpu",
                 "--out", out])
    recs = report.load(out)
    assert len(recs) == 4
    text = report.render([r for r in recs if "mesh" in r], "pod")
    assert "tpu_v5e descriptor" in text and "predicted" in text
    assert "| smollm2-135m | train_4k |" in text and "| rwkv6-1.6b | long_500k |" in text
    assert "| smollm2-135m | train_4k |" in report.render(
        [r for r in recs if "mesh" in r], "multipod")
    for r in recs:
        if "mesh" in r:
            assert report.one_liner(r)
    assert "all 2 cells priced OK" in capsys.readouterr().out


def test_meta_tensors_reach_no_plain_version():
    from repro_torch.kernels.mmt4d.ops import mmt4d
    from repro_torch.kernels.pack.ops import pack
    from repro_torch.kernels.unpack.ops import unpack
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pack(torch.empty((16, 128), **meta), 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        unpack(torch.empty((2, 1, 8, 128), **meta), 16, 128)
    with pytest.raises(ValueError, match="CUDA"):
        mmt4d(torch.empty((2, 1, 8, 128), **meta), torch.empty((3, 1, 128, 128), **meta))
    for arch, policy in (("smollm2-135m", "scalable"), ("rwkv6-1.6b", "unpacked"),
                         ("jamba-v0.1-52b", "unpacked")):
        cfg = reduced_config(get_config(arch), layers=8 if "jamba" in arch else 2)
        m = build_model(cfg, RunConfig(layout_policy=policy), ShapeSpec("t", 16, 2, "train"),
                        hw=HW, device="meta")
        params = m.init(dryrun.MetaGenerator())
        with pytest.raises(ValueError, match="CUDA"):
            m.forward(params, {"tokens": torch.zeros((2, 16), dtype=torch.int32,
                                                     device="meta")})
    with pytest.raises(ValueError, match="needs hw="):
        build_model(cfg, RunConfig(), ShapeSpec("t", 16, 2, "train"), device="meta")


def test_one_rank_mesh_holds_the_whole_tree():
    cfg = reduced_config(get_config("qwen3-moe-235b-a22b"), layers=2)
    run = RunConfig(remat=False)
    cell = dryrun.build_cell(cfg, ShapeSpec("t", 32, 2, "train"), run,
                             AbstractMesh((1, 1), ("data", "model")), HW)
    state, specs = cell.trees["state"], cell.specs["state"]
    whole = sum(t.numel() * t.element_size() for t in _leaves(state))
    assert sharding.device_bytes(state, specs, cell.mesh) == whole
    rounded = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in _leaves(state))
    assert sharding.device_bytes(state, specs, cell.mesh, block=512) == rounded
    # the meta state has the trees a real init makes
    real = build_model(cfg, run, ShapeSpec("t", 32, 2, "train"), hw=HW, device="cpu")
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_state import TrainState
    rs = TrainState.create(real.init(torch.Generator().manual_seed(0)),
                           make_optimizer(run))
    assert [(t.shape, t.dtype) for t in _leaves(rs)] == \
        [(t.shape, t.dtype) for t in _leaves(state)]


def _closed_form_products(model, kind: str) -> float:
    """The cost model's product list (``obs/attrib.py:_layer_costs``,
    ``_expert_costs``) over the whole batch: the linears, the head, the
    experts and the routers, as the dry-run counted them before it read
    them off the parameter leaves."""
    from repro_torch.core.layout import round_up
    from repro_torch.models.moe import capacity
    from repro_torch.obs.attrib import _expert_costs, _layer_costs
    cfg, shape = model.cfg, model.shape
    lay = model.ctx.layout(model.compute_dtype)
    m_r, n_r, k_r = lay.m_r, lay.n_r, lay.k_r
    lin = lambda mats: sum(round_up(k, k_r) * round_up(n, n_r) for k, n in mats)
    d, b, seq = cfg.d_model, shape.global_batch, shape.seq_len
    q = 1 if kind == "decode" else seq
    m, p = b * round_up(q, m_r), b * q
    total = 2 * m * sum(lin(_layer_costs(cfg, t, 2, cfg.moe_on_layer(i))[0])
                        for i, t in enumerate(cfg.layer_types))
    total += (2 * b * round_up(seq if kind == "train" else 1, m_r)
              * round_up(cfg.vocab, n_r) * round_up(d, k_r))
    n_moe = sum(cfg.moe_on_layer(i) for i in range(cfg.n_layers))
    if n_moe:
        rows = round_up(capacity(p, cfg), m_r)
        total += (2 * rows * n_moe * cfg.n_experts * lin(_expert_costs(cfg))
                  + 2 * p * d * cfg.n_experts * n_moe)
    if cfg.family == "vlm" and kind != "decode":
        total += 2 * b * round_up(cfg.vision_tokens, m_r) * lin([(d, d)])
    if cfg.family == "encdec":
        hd = cfg.n_heads * cfg.d_head
        total += 2 * m * cfg.n_layers * lin([(d, hd), (hd, d)])
        if kind != "decode":
            me = b * round_up(seq // cfg.audio_downsample, m_r)
            enc = cfg.encoder_layers * lin(_layer_costs(cfg, "attn", 0)[0])
            kv = cfg.n_layers * lin([(d, cfg.n_kv_heads * cfg.d_head)] * 2)
            total += 2 * me * (enc + lin([(d, d)]) + kv)
    return total


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", sorted({a for a, _ in RUNNABLE}))
def test_leaf_walk_prices_every_product(arch, kind):
    """On one device the products read off the parameter leaves are the
    cost model's product list, none missed and none twice."""
    one = AbstractMesh((1, 1), ("data", "model"))
    shape = ShapeSpec("t", 256, 2, kind)
    cell = dryrun.build_cell(get_config(arch), shape, RunConfig(), one, HW)
    params = cell.trees["state"].params if kind == "train" else cell.trees["params"]
    p_specs = cell.specs["state"].params if kind == "train" else cell.specs["params"]
    f = dryrun.forward_costs(cell.model, kind, params, p_specs, one)["flops"]
    got = f["linear"] + f["head"] + f["moe"] + f["router"]
    assert got == _closed_form_products(cell.model, kind), arch


def _per_device(arch, mesh, run=RunConfig()):
    cell = dryrun.build_cell(get_config(arch), SHAPES["train_4k"], run, mesh, HW)
    return dryrun.cell_counts(cell)


def test_products_split_as_their_specs():
    """Each product's share over "model" is its weight's: SmolLM2's
    linears split 4 ways but K and V (3 KV heads, the reference's rule),
    and its tied head's vocab too (the embedding gathered over "data");
    its 9 heads do not divide the axis, so its attention is whole on each
    device and the collectives gather q; whisper's tied vocab of 51865
    stays whole on a 16-way axis; Qwen2-7B's 28 heads split 4 ways with no
    gather, not 16."""
    one = _per_device("smollm2-135m", AbstractMesh((4, 1), ("data", "model")))
    four = _per_device("smollm2-135m", AbstractMesh((4, 4), ("data", "model")))
    a, b = one["flops_parts"], four["flops_parts"]
    lay = build_model(get_config("smollm2-135m"), RunConfig(), SHAPES["train_4k"],
                      hw=HW, device="meta").ctx.layout(torch.bfloat16)
    ru = lambda n, t: -(-n // t) * t
    # K and V: 4 passes, a data shard's 256 * 4096 / 4 rows, 30 layers
    kv = 4 * 2 * (256 * 4096 // 4) * 30 * ru(576, lay.k_r) * ru(192, lay.n_r) * 2
    assert a["linear"] - kv == pytest.approx(4 * (b["linear"] - kv), rel=1e-12)
    assert a["head"] == 4 * b["head"] and a["attention"] == b["attention"]
    assert one["collective"]["attention_all_gather"] == 0
    assert four["collective"]["attention_all_gather"] > 0
    w1 = _per_device("whisper-small", AbstractMesh((16, 1), ("data", "model")))
    w16 = _per_device("whisper-small", AbstractMesh((16, 16), ("data", "model")))
    assert w1["flops_parts"]["head"] == w16["flops_parts"]["head"]
    q1 = _per_device("qwen2-7b", AbstractMesh((1, 1), ("data", "model")))
    q4 = _per_device("qwen2-7b", AbstractMesh((1, 4), ("data", "model")))
    q16 = _per_device("qwen2-7b", AbstractMesh((1, 16), ("data", "model")))
    assert q1["flops_parts"]["attention"] == 4 * q4["flops_parts"]["attention"]
    assert q1["flops_parts"]["attention"] == q16["flops_parts"]["attention"]
    assert q4["collective"]["attention_all_gather"] == 0
    assert q16["collective"]["attention_all_gather"] > 0


def test_microbatches_price_the_train_step():
    """Microbatches leave the FLOPs as they are, cut the transients (a
    microbatch's saved activations and logits, less the float32
    accumulator they add) and add weight reads."""
    mesh = ABSTRACT_MESHES["pod"]
    one = _per_device("smollm2-135m", mesh, RunConfig(microbatch=1))
    eight = _per_device("smollm2-135m", mesh, RunConfig(microbatch=8))
    assert one["flops"] == eight["flops"]
    assert eight["memory"]["temp_bytes"] < one["memory"]["temp_bytes"]
    assert eight["hbm_bytes"] > one["hbm_bytes"]
    assert one == _per_device("smollm2-135m", mesh, RunConfig(microbatch=0))


_COMPILED = textwrap.dedent(r"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import collections, json, re, jax
    from repro.configs import RunConfig
    from repro.launch import dryrun
    from repro.roofline import hlo_cost as hc
    # Auto axes: this jax's make_mesh defaults to Explicit ones, which the
    # reference's with_sharding_constraint calls refuse
    auto = (jax.sharding.AxisType.Auto,) * 2
    dryrun.MESHES = {"pod": lambda: jax.make_mesh((4, 4), ("data", "model"),
                                                  axis_types=auto)}
    texts, parse = [], hc.parse_hlo
    hc.parse_hlo = lambda t: (texts.append(t), parse(t))[1]
    rec = dryrun.run_cell("smollm2-135m", "train_4k", "pod", RunConfig(microbatch=4),
                          out_dir=None, verbose=False)

    def groups(text):
        # the collectives by (kind, operand type, first replica group), with
        # the executions and operand bytes the reference's parse_hlo counts
        comps = hc._split_computations(text)
        by = {c.name: c for c in comps}
        runs, stack, seen = collections.defaultdict(float), [], set()
        stack = [(c.name, 1.0) for c in comps if c.entry]
        while stack:
            name, n = stack.pop()
            runs[name] += n
            for ins in by[name].instrs if name in by else ():
                body = re.search(r"body=%?([\w\.\-]+)", ins.rest)
                if ins.opcode == "while" and body and (name, body.group(1)) not in seen:
                    seen.add((name, body.group(1)))
                    t = re.search(r"known_trip_count[^0-9]*?(\d+)", ins.rest)
                    stack.append((body.group(1), n * int(t.group(1)) if t else n))
                elif ins.opcode == "call":
                    m = re.search(r"to_apply=%?([\w\.\-]+)", ins.rest)
                    stack.append((m.group(1), n)) if m else None
        out = collections.defaultdict(lambda: [0.0, 0.0])
        shapes = {i.name: i.type_str for cc in comps for i in cc.instrs}
        for c in comps:
            if c.fused or not runs.get(c.name):
                continue
            for ins in c.instrs:
                if ins.opcode == "dot":
                    key = ("dot", ins.type_str.split("{")[0], "")
                    out[key][0] += runs[c.name]
                    out[key][1] += hc._dot_flops(ins, shapes) * runs[c.name]
                    continue
                kind = next((k for k in hc._COLLECTIVES if ins.opcode.startswith(k)), None)
                if kind is None or ins.opcode.endswith("-done"):
                    continue
                ops = hc._operands_region(ins.rest)
                nbytes = hc._type_bytes(ops) or sum(
                    hc._type_bytes(shapes.get(nm, "")) for nm in hc._OPERAND.findall(ops))
                rg = re.search(r"replica_groups=([^ ]+?)(?:, [a-z_]+=|$)", ins.rest)
                key = (kind, ins.type_str.split("{")[0], rg.group(1) if rg else "")
                out[key][0] += runs[c.name]
                out[key][1] += nbytes * runs[c.name]
        return sorted(([*k, *v] for k, v in out.items()), key=lambda r: -r[4])

    g = groups(texts[-1])
    rec["collective_groups"] = [r for r in g if r[0] != "dot"][:16]
    rec["dot_groups"] = [r for r in g if r[0] == "dot"][:16]
    print("RESULT " + json.dumps({k: rec[k] for k in (
        "status", "chips", "hlo_flops_per_chip", "hlo_bytes_per_chip",
        "collective_bytes_per_chip", "compute_s", "memory_s", "collective_s",
        "collective_detail", "op_counts", "collective_groups", "dot_groups")}))
""")


@pytest.mark.slow
def test_terms_beside_the_compiled_reference_cell():
    """SmolLM2-135M x train_4k on a 16-device (4, 4) mesh: the reference's
    compiled per-device terms (its HLO, 16 forced host devices) printed
    beside the port's analytic ones, both priced on tpu_v5e, with the
    reference's collectives and dots grouped by result type (executions
    over its loops' trip counts, as its ``parse_hlo`` counts them) and the
    port's FLOPs by part.  A gap is a finding to explain in PERF.md, not a
    bound to hold."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _COMPILED], capture_output=True,
                       text=True, timeout=1800, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    want = json.loads([l for l in p.stdout.splitlines()
                       if l.startswith("RESULT ")][-1][len("RESULT "):])
    got = dryrun.run_cell("smollm2-135m", "train_4k", "pod", RunConfig(microbatch=4),
                          verbose=False, hw=HW,
                          mesh=AbstractMesh((4, 4), ("data", "model")))
    assert want["status"] == got["status"] == "ok"
    assert want["chips"] == got["chips"] == 16
    for k in ("hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes_per_chip",
              "compute_s", "memory_s", "collective_s"):
        print(f"{k}: reference (compiled) {want[k]:.6g}  port (analytic) {got[k]:.6g}"
              f"  port / reference {got[k] / max(want[k], 1e-30):.4f}")
        assert got[k] > 0 and want[k] > 0, k
    print("reference collectives:", json.dumps(want["collective_detail"]))
    print("reference op counts:", json.dumps(want["op_counts"]))
    print("reference collectives by (kind, result type, first replica group): "
          "executions, operand bytes")
    for kind, typ, group, runs, nbytes in want["collective_groups"]:
        print(f"  {kind:>18} {typ:<28} {group:<22} {runs:8.0f} {nbytes:.4g}")
    print("reference dots by result type: executions, FLOPs")
    for _, typ, _, runs, flops in want["dot_groups"]:
        print(f"  {typ:<32} {runs:8.0f} {flops:.4g}")
    print("port collectives:", json.dumps(got["collective_detail"]["bytes"]))
    print("port op counts:", json.dumps(got["op_counts"]))
    print("port FLOPs by part:", json.dumps(got["flops_parts"]))
