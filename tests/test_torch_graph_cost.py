"""Costs read off the traced step (``repro_torch.roofline.graph_cost``)
against the JAX package's HLO parser and against the port's closed forms,
on the CPU:

- the reference's ``tests/test_roofline.py`` dot cases at the same shapes:
  the port's count of the traced product equals ``parse_hlo``'s of the
  compiled one, and the unfused byte count of ``tanh(a @ b)`` sits in the
  reference's bounds;
- ``build_cost_model``'s FLOPs equal the traced step's ``dot_flops``
  exactly, for every step family of every ``CONFIG_MATRIX`` configuration
  and of reduced RWKV-6, jamba (mamba), Qwen3-MoE, Arctic and Qwen3-8B,
  which with ``test_torch_attrib.py``'s identity ties the graph to the
  reference's XLA count plus ROADMAP C7's and C8's terms;
- ``launch/dryrun.py``'s closed-form FLOPs of a train cell at one device
  equal the traced train step's (loss and every gradient), for every
  config, with and without ``remat``, past 512 positions (chunked
  attention); at 256 positions for reduced SmolLM2 too;
- the ``repro_torch`` op counts of a traced flat step equal the ops an
  eager step dispatches;
- ``torch.library.opcheck`` of each op's CPU and fake impls.
"""

import collections

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_op_samples import op_samples
from repro.roofline.hlo_cost import parse_hlo
from repro_torch import kernels
from repro_torch.analysis import runner
from repro_torch.analysis.graph_tools import trace_step
from repro_torch.analysis.shapes import step_families
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import query
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.obs.attrib import build_cost_model
from repro_torch.roofline.graph_cost import graph_cost, step_cost
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)


def _compile(f, *specs):
    return jax.jit(f).lower(*specs).compile()


def test_dot_flops_exact():
    c = _compile(lambda a, b: a @ b, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                 jax.ShapeDtypeStruct((128, 32), jnp.float32))
    gc = graph_cost(trace_step(lambda a, b: a @ b,
                               (torch.zeros(64, 128), torch.zeros(128, 32))))
    assert gc.dot_flops == parse_hlo(c.as_text()).dot_flops == 2 * 64 * 128 * 32
    assert gc.op_counts == {"aten.mm": 1}


def test_batched_dot_flops():
    c = _compile(lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k),
                 jax.ShapeDtypeStruct((2, 64, 4, 32), jnp.float32),
                 jax.ShapeDtypeStruct((2, 128, 4, 32), jnp.float32))
    gc = graph_cost(trace_step(lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k),
                               (torch.zeros(2, 64, 4, 32), torch.zeros(2, 128, 4, 32))))
    assert gc.dot_flops == parse_hlo(c.as_text()).dot_flops == 2 * 2 * 4 * 64 * 128 * 32
    assert gc.op_counts["aten.bmm"] == 1


def test_hbm_bytes_reasonable():
    gc = graph_cost(trace_step(lambda a, b: torch.tanh(a @ b),
                               (torch.zeros(256, 256), torch.zeros(256, 256))))
    lo = 3 * 256 * 256 * 4          # read a, b; write out
    assert lo <= gc.hbm_bytes <= 6 * lo
    assert gc.hbm_bytes == 5 * 256 * 256 * 4     # mm: a, b, out; tanh: in, out
    assert gc.collective_bytes == {} and gc.collective_counts == {}


def test_collective_bytes_are_operand_bytes():
    """The reference's convention (``hlo_parse.collective_bytes``): each
    collective's operand bytes, an async one counted once (not its wait)."""
    c10d = torch.ops._c10d_functional

    def step(x, y):
        a = c10d.wait_tensor.default(c10d.all_reduce.default(x, "sum", "g0"))
        b = c10d.wait_tensor.default(c10d.all_gather_into_tensor.default(y, 4, "g0"))
        c = c10d.reduce_scatter_tensor.default(b, "sum", 4, "g0")
        return a, c10d.wait_tensor.default(c)

    gc = graph_cost(trace_step(step, (torch.zeros(64, 32), torch.zeros(8, 16,
                                                                       dtype=torch.bfloat16))))
    assert gc.collective_bytes == {"_c10d_functional.all_reduce": 64 * 32 * 4,
                                   "_c10d_functional.all_gather_into_tensor": 8 * 16 * 2,
                                   "_c10d_functional.reduce_scatter_tensor": 32 * 16 * 2}
    assert set(gc.collective_counts.values()) == {1}
    assert gc.dot_flops == 0


# ---------------------------------------------------------------------------
# the cost model's closed form = the traced step, family by family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smollm():
    return runner.build_model(device="cpu")


def _reduced(arch, dtype="float32"):
    cfg = reduced_config(get_config(arch), layers=8 if arch.startswith("jamba") else 2)
    run = RunConfig(**dict(F32, param_dtype=dtype, compute_dtype=dtype))
    m = build_model(cfg, run, ShapeSpec("serve", 64, 3, "decode"), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


ENGINES = [(label, None, kw) for label, kw in runner.CONFIG_MATRIX] + [
    ("rwkv6-1.6b", "rwkv6-1.6b", {}), ("jamba-v0.1-52b", "jamba-v0.1-52b", {}),
    ("qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b", {}),
    ("arctic-480b", "arctic-480b", {}), ("qwen3-8b-flat", "qwen3-8b",
                                         dict(chunk_tokens=16)),
    ("smollm2-bf16-flat", "smollm2-135m-bf16", dict(chunk_tokens=16))]


@pytest.mark.parametrize("label,arch,kw", ENGINES, ids=[e[0] for e in ENGINES])
def test_cost_model_equals_traced_graph(smollm, label, arch, kw):
    if arch is None:
        m, params = smollm
    elif arch.endswith("-bf16"):
        m, params = _reduced(arch[:-5], "bfloat16")
    else:
        m, params = _reduced(arch)
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8, **kw)
    before = dict(m.trace_counts)
    cm = build_cost_model(eng)
    fams = step_families(eng)
    assert fams
    for fam, _ in fams:
        gc = step_cost(eng, fam)
        assert gc.dot_flops == cm.families[fam].flops, (label, fam)
        assert gc.hbm_bytes > 0 and gc.kernel_counts()["mmt4d"] > 0
    assert dict(m.trace_counts) == before        # tracing runs no step


def test_trace_widest_on_a_fake_engine(smollm):
    """An engine over fake tensors (nothing allocated) traces as the real
    one does: the same families, no finding, the same graph cost."""
    m, params = smollm
    kw = dict(max_slots=3, page_tokens=8, chunk_tokens=16)
    real, fake = Engine(m, params, device="cpu", **kw), runner.fake_engine(m, **kw)
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in pytree.tree_leaves((fake.params, fake.caches))
               if isinstance(t, torch.Tensor))
    r = runner.trace_widest(fake, "fake")
    assert (r["static_dims"], r["aliasing"]) == ([], [])
    assert r["family"] == step_families(real)[0][0]
    assert r["cost"].dot_flops == r["closed_flops"] == \
        step_cost(real, r["family"]).dot_flops
    assert r["cost"].op_counts == step_cost(real, r["family"]).op_counts


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.counts[func._schema.name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


def test_traced_op_counts_equal_eager_dispatches(smollm):
    """Each kernel call of an eager flat step is one node of its trace."""
    m, params = smollm
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                 chunk_tokens=16)
    fam = step_families(eng)[0][0]
    w = eng._flat_shapes()[0]
    i32 = torch.int32
    args = (eng.params, eng.caches, torch.zeros((1, w), dtype=i32),
            torch.zeros((3, eng.max_pages), dtype=i32), torch.full((w,), -1, dtype=i32),
            torch.zeros((w,), dtype=i32), torch.zeros((3,), dtype=i32))
    with _CountOps() as c:
        m.flat_decode_step(*args)
    assert step_cost(eng, fam).kernel_counts() == dict(c.counts)
    assert set(c.counts) == {"mmt4d", "pack", "unpack", "ragged_attn"}


# ---------------------------------------------------------------------------
# the dry-run's closed form of a train cell = the traced train step
# ---------------------------------------------------------------------------

HW = query(torch.device("cpu"))
ONE = AbstractMesh((1, 1), ("data", "model"))
ARCHS = ["smollm2-135m", "qwen2-7b", "qwen3-8b", "chatglm3-6b", "olmo-1b",
         "internvl2-26b", "whisper-small", "rwkv6-1.6b", "jamba-v0.1-52b",
         "qwen3-moe-235b-a22b", "arctic-480b"]
TRAIN = ([(a, r, 1024) for a in ARCHS for r in (False, True)]
         + [("smollm2-135m", r, 256) for r in (False, True)])


def _grad_step(m):
    def step(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
        loss, _ = m.loss(pytree.tree_unflatten(leaves, spec), batch)
        return torch.autograd.grad(loss, [t for t in leaves if t.requires_grad])
    return step


@pytest.mark.parametrize("arch,remat,seq", TRAIN,
                         ids=[f"{a}-{'remat' if r else 'plain'}-{s}" for a, r, s in TRAIN])
def test_dryrun_train_flops_equal_traced_step(arch, remat, seq):
    cfg = reduced_config(get_config(arch))
    run, shape = RunConfig(remat=remat), ShapeSpec("t", seq, 2, "train")
    cell = dryrun.build_cell(cfg, shape, run, ONE, HW)
    want = dryrun.cell_counts(cell)
    m = build_model(cfg, run, shape, hw=HW, device="cpu")
    gc = graph_cost(trace_step(_grad_step(m), (cell.trees["state"].params,
                                               m.input_specs("train")),
                               device="cpu"))
    assert gc.dot_flops == want["flops"], want["flops_parts"]
    kc = gc.kernel_counts()
    assert kc["mmt4d_dgrad"] > 0 and kc["mmt4d_wgrad"] >= kc["mmt4d_dgrad"]


# ---------------------------------------------------------------------------
# opcheck: the CPU and fake impls of every op
# ---------------------------------------------------------------------------

kernels.wrappers()                       # imports every op's registration
SAMPLES = op_samples("cpu")


def test_every_kernel_is_an_op_with_a_sample():
    assert sorted(kernels.wrappers()) == sorted({name for name, _, _ in SAMPLES})
    for name in kernels.wrappers():
        assert hasattr(torch.ops.repro_torch, name)


@pytest.mark.parametrize("name,case,args", SAMPLES,
                         ids=[f"{n}-{c}" for n, c, _ in SAMPLES])
def test_opcheck_cpu_and_fake(name, case, args):
    torch.library.opcheck(getattr(torch.ops.repro_torch, name).default, args)
