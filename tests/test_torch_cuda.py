"""The port's CUDA kernels against their plain versions on the card, at
small shapes (chip_smoke.py repeats this at the full SmolLM2 widths), and
the CUDA graphs of the three serving step families on SmolLM2 cut to 2
layers:
replay bit for bit the eager step, with the same launch counts, and no
capture during a drain after warmup.
A CUDA kernel has no interpret mode, so without a card these tests skip.
Run them on the card with (``--noconftest``: tests/conftest.py imports JAX,
which a machine with only the port need not have):
    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.hardware import query
from repro_torch.core.layout import make_layout
from repro_torch.kernels import build
from repro_torch.kernels.mmt4d.ops import mmt4d
from repro_torch.kernels.mmt4d.ref import mmt4d_ref
from repro_torch.kernels.pack.ops import pack
from repro_torch.kernels.pack.ref import pack_ref
from repro_torch.kernels.ragged_attn.ops import plan_ragged, ragged_attention
from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref
from repro_torch.core.mmt4d import Epilogue
from repro_torch.kernels.unpack.ops import unpack, vector_path
from repro_torch.kernels.unpack.ref import unpack_ref

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, tol):
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_pack_unpack_kernels_exact(gen, dtype, tol):
    a = _rand(gen, (2, 37, 200), dtype)
    assert torch.equal(pack(a, 8, 128), pack_ref(a, 8, 128))
    t = a[0].T                                         # strided input
    assert torch.equal(pack(t, 16, 128), pack_ref(t, 16, 128))
    p = pack(a, 16, 128)
    assert torch.equal(unpack(p, 37, 200), unpack_ref(p, 37, 200))
    assert torch.equal(unpack(p, 37, 200), a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["contiguous", "k_not_vector", "transposed",
                                  "storage_offset", "batch_dims", "partial_tiles"])
def test_pack_kernel_exact(gen, case, dtype):
    """Each read path of the pack kernel (16-byte vectors, staged transpose,
    scalar), bit-exact against the plain version."""
    if case == "contiguous":             # aligned, whole tiles
        a, t = _rand(gen, (256, 384), dtype), (128, 128)
    elif case == "k_not_vector":         # K % 8 != 0: the scalar branch
        a, t = _rand(gen, (40, 203), dtype), (16, 128)
    elif case == "transposed":           # W^T as prepack_params packs it
        a, t = _rand(gen, (200, 300), dtype).T, (128, 128)
    elif case == "storage_offset":       # rows start off the 16-byte grid
        a, t = _rand(gen, (3 * 37 * 200 + 1,), dtype)[1:].view(3, 37, 200), (8, 128)
    elif case == "batch_dims":
        a, t = _rand(gen, (2, 3, 21, 256), dtype), (16, 128)
    else:                                # ragged in both dims
        a, t = _rand(gen, (130, 129), dtype), (128, 128)
    assert torch.equal(pack(a, *t), pack_ref(a, *t))


_M_O, _K_O, _N_O, _M_R = (1, 5, 32), (1, 5, 12), (1, 3, 384), (8, 16, 32)


@pytest.mark.parametrize("m_r", _M_R)
@pytest.mark.parametrize("n_o", _N_O)
@pytest.mark.parametrize("k_o", _K_O)
@pytest.mark.parametrize("m_o", _M_O)
def test_mmt4d_bf16_kernel_matches_plain(gen, m_o, k_o, n_o, m_r):
    """The tensor-core kernel over ragged mo groups, every split count, one
    to many output tiles, the FIXED (8), scalable (16) and _2x (32) tiles,
    with and without bias, every activation: within 2e-2 of the plain
    version (float32 sums in another order, one bf16 rounding)."""
    bf = torch.bfloat16
    ap = _rand(gen, (m_o, k_o, m_r, 128), bf)
    bp = (_rand(gen, (n_o, k_o, 128, 128), bf).float() * (k_o * 128) ** -0.5).to(bf)
    bias = _rand(gen, (n_o, 128), bf)
    for b in (None, bias):
        for act in [None, "gelu", "silu", "relu", "tanh"]:
            got = mmt4d(ap, bp, b, activation=act)
            want = mmt4d_ref(ap, bp, b, activation=act)
            assert got.shape == want.shape and _close(got, want, 2e-2), \
                (b is not None, act)


def test_mmt4d_bf16_one_launch_and_bit_identical(gen):
    """One launch per call, and split-K reduced in a fixed order: repeated
    calls give the same bits (down decode: 8 splits per cluster)."""
    bf = torch.bfloat16
    ap, bp = _rand(gen, (1, 12, 16, 128), bf), _rand(gen, (5, 12, 128, 128), bf)
    before = mmt4d.launches
    first = mmt4d(ap, bp, activation="silu")
    assert mmt4d.launches == before + 1
    for _ in range(3):
        assert torch.equal(mmt4d(ap, bp, activation="silu"), first)


def _sass_by_function() -> dict:
    """Disassembly of the built kernel library, by (mangled) function name."""
    lib = build.load_library()._name
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def test_mmt4d_bf16_runs_on_tensor_cores_f32_does_not(gen):
    funcs = _sass_by_function()
    bf16 = [v for k, v in funcs.items() if "mmt4d_bf16_kernel" in k]
    f32 = [v for k, v in funcs.items() if "mmt4d_f32_kernel" in k]
    assert bf16 and len(f32) == 1, sorted(funcs)     # one bf16 kernel per NT
    assert all("HMMA.16816.F32.BF16" in v for v in bf16)
    assert "HMMA" not in f32[0]


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "tanh"])
def test_mmt4d_kernel_matches_plain(gen, act, dtype, tol):
    lay = make_layout("scalable", query("cuda"), dtype)
    ap = packing.pack_lhs(_rand(gen, (40, 200), dtype), lay)
    bp = packing.pack_rhs(_rand(gen, (200, 136), dtype), lay)
    bias = _rand(gen, (bp.shape[0], lay.n_r), dtype)
    got = mmt4d(ap, bp, bias, activation=act).float()
    want = mmt4d_ref(ap, bp, bias, activation=act).float()
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


_ACTS = [None, "gelu", "silu", "relu", "tanh"]


@pytest.mark.parametrize("lead", [(1,), (2,)], ids=["lead1", "lead2"])
@pytest.mark.parametrize("k_o", [1, 5, 12])
@pytest.mark.parametrize("n", [64, 192, 576, 1000, 49152, 70, 130])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mmt4d_unpacked_store_is_packed_then_unpack(gen, dtype, m, n, k_o, lead):
    """mmt4d's unpacked store (``unpack_to``) equals the packed store
    followed by the unpack kernel, bit for bit: every split (K_o = 12 splits
    K in a cluster at decode), tm > 1 (m = 512), a last tile with 64 of 128
    columns valid (N = 192, 576), N not a multiple of 4 (70, 130: the
    kernel's scalar stores), two batch elements, every activation, with
    and without bias; one launch, counted as an unpacked store."""
    lay = make_layout("scalable", query("cuda"), dtype)
    k = k_o * lay.k_r
    ap = packing.pack_lhs(_rand(gen, (*lead, m, k), dtype), lay)
    bp = packing.pack_rhs((_rand(gen, (k, n), dtype).float() * k ** -0.5).to(dtype), lay)
    bias = Epilogue().bias_pack(_rand(gen, (n,), dtype), lay)
    for b, act in [(None, None)] + [(bias, a) for a in _ACTS]:
        want = unpack(mmt4d(ap, bp, b, activation=act), m, n)
        before = (mmt4d.launches, mmt4d.unpacked_stores, unpack.launches)
        got = mmt4d(ap, bp, b, activation=act, unpack_to=(m, n))
        assert (mmt4d.launches, mmt4d.unpacked_stores, unpack.launches) == \
            (before[0] + 1, before[1] + 1, before[2])
        assert got.shape == (*lead, m, n) and got.is_contiguous()
        assert torch.equal(got, want), (b is not None, act)


_UNPACK_CASES = {   # (shape of A, t0, t1, the 16-byte path)
    "vector": ((1, 37, 576), 16, None, True),
    "k_not_vector": ((1, 40, 203), 16, None, False),
    "batch_dims": ((2, 3, 21, 256), 8, None, True),
    "decode_stream": ((1, 16, 576), 16, None, True),
    "prefill_stream": ((1, 512, 576), 16, None, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t1", [64, 128])
@pytest.mark.parametrize("case", sorted(_UNPACK_CASES) + ["storage_offset"])
def test_unpack_kernel_exact(gen, case, t1, dtype):
    """The unpack kernel's 16-byte and scalar paths, bit-exact against the
    plain version, one launch per call."""
    if case == "storage_offset":          # a packed input off the 16-byte grid
        p = pack(_rand(gen, (1, 37, 576), dtype), 16, t1)
        buf = torch.empty(p.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = p.reshape(-1)
        p, (m, k), vector = buf[1:].view(p.shape), (37, 576), False
    else:
        shape, t0, _, vector = _UNPACK_CASES[case]
        p = pack(_rand(gen, shape, dtype), t0, t1)
        m, k = shape[-2:]
    assert vector_path(p, torch.empty(1, dtype=dtype, device="cuda"), k) == vector
    before = unpack.launches
    got = unpack(p, m, k)
    assert unpack.launches == before + 1
    assert got.is_contiguous() and torch.equal(got, unpack_ref(p, m, k))


def test_unpack_bf16_vector_path_moves_16_bytes(gen):
    funcs = _sass_by_function()
    vec = [v for k, v in funcs.items()
           if "unpack_kernel" in k and "bfloat16" in k and "uint4" in k]
    assert len(vec) == 1, sorted(funcs)
    assert "LDG.E.128" in vec[0] and "STG.E.128" in vec[0]


# ragged attention at SmolLM2's heads (9 over 3, d_head 64), pages of 16,
# MP = 64 (1024 tokens): segments (row, first q_pos, length) laid out back
# to back from flat position 0, the rest of the width padding
_RAGGED_CASES = {
    "page_edges": ([(0, 0, 1), (1, 15, 1), (2, 16, 1), (3, 17, 1),
                    (4, 64 * 16 - 1, 1)], 16),
    "long_row": ([(0, 1000, 1)], 16),
    "mid_page_segments": ([(0, 5, 1), (1, 21, 15), (2, 37, 16), (3, 100, 17),
                           (4, 203, 40)], 96),
    "decode_rows_one_tile_width": ([(0, 300, 1), (1, 511, 1), (2, 95, 1),
                                    (3, 1000, 1)], 16),
    "trailing_padding": ([(0, 600, 1), (1, 64, 1), (2, 0, 30)], 64),
    "decode_chunk_fresh_prefill": ([(0, 60, 1), (1, 17, 8), (2, 0, 5)], 32),
}


def _ragged_case(gen, dtype, segments, width, pages=400, mp=64, hq=9, hkv=3):
    rng = np.random.default_rng(width + len(segments))
    rows = 1 + max(r for r, _, _ in segments)
    bt = (rng.permutation(pages - 1)[:rows * mp] + 1).astype(np.int32).reshape(rows, mp)
    row_ids = np.full(width, -1, np.int32)
    q_pos = np.zeros(width, np.int32)
    pos = 0
    for row, first, n in segments:
        row_ids[pos:pos + n] = row
        q_pos[pos:pos + n] = first + np.arange(n)
        pos += n
    args = dict(block_tables=torch.from_numpy(bt).cuda(),
                row_ids=torch.from_numpy(row_ids).cuda(),
                q_pos=torch.from_numpy(q_pos).cuda())
    q = _rand(gen, (width, hq, 64), dtype)
    kp = _rand(gen, (pages, 16, hkv, 64), dtype)
    vp = _rand(gen, (pages, 16, hkv, 64), dtype)
    return q, kp, vp, args, row_ids, q_pos


def _ragged_plan(row_ids, q_pos, splits=None, hkv=3, hq=9):
    return plan_ragged(row_ids, q_pos, 16, 64, hkv, 132, group=hq // hkv,
                       splits=splits).to("cuda")


@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_kernel_matches_plain(gen, dtype, tol, case):
    """Valid positions within tol (absolute) of the plain version (float32
    sums in another order; bf16 also rounds P to bf16 for P V); padding
    positions exactly zero; one launch per call; repeated calls
    bit-identical."""
    segments, width = _RAGGED_CASES[case]
    q, kp, vp, args, row_ids, q_pos = _ragged_case(gen, dtype, segments, width)
    plan = _ragged_plan(row_ids, q_pos)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    before = ragged_attention.launches
    out = ragged_attention(q, kp, vp, plan=plan, **args)
    assert ragged_attention.launches == before + 1
    want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
    assert (out[valid].float() - want).abs().max().item() <= tol
    assert torch.isfinite(out.float()).all()
    assert not out[~valid].any()
    for _ in range(3):
        assert torch.equal(ragged_attention(q, kp, vp, plan=plan, **args), out)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_kernel_every_split(gen, dtype, tol, splits):
    """Every cluster size: a long decode row, a prefill chunk whose first
    rows see fewer pages than the split count (all-masked partials) and a
    row shorter than the split count (empty ranges)."""
    segments = [(0, 1000, 1), (1, 200, 40), (2, 20, 3)]
    q, kp, vp, args, row_ids, q_pos = _ragged_case(gen, dtype, segments, 48)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    got = ragged_attention(q, kp, vp, plan=_ragged_plan(row_ids, q_pos, splits),
                           **args)[valid].float()
    want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
    assert (got - want).abs().max().item() <= tol


def test_ragged_kernel_needs_a_plan(gen):
    q, kp, vp, args, _, _ = _ragged_case(gen, torch.bfloat16, [(0, 10, 1)], 16)
    with pytest.raises(ValueError, match="plan"):
        ragged_attention(q, kp, vp, **args)


def test_ragged_bf16_runs_on_tensor_cores_f32_does_not(gen):
    funcs = _sass_by_function()
    bf16 = [v for k, v in funcs.items() if "ragged_attn_kernel" in k and "bfloat16" in k]
    f32 = [v for k, v in funcs.items() if "ragged_attn_kernel" in k and "bfloat16" not in k]
    assert len(bf16) == 1 and len(f32) == 1, sorted(funcs)
    assert "HMMA.16816.F32.BF16" in bf16[0]
    assert "HMMA" not in f32[0]


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    a = _rand(gen, (16, 128), torch.float16)
    with pytest.raises(TypeError):
        pack(a, 8, 128)
    with pytest.raises(ValueError):
        unpack(pack(_rand(gen, (16, 256), torch.float32), 8, 128)
               .transpose(1, 2), 16, 256)


@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_fixed_plan_matches_per_step_plan(gen, dtype, tol, case):
    """The fixed-size plan a served step replays (``slots=``: the width's
    most tiles, its split count) gives the per-step plan's output: bit for
    bit at the same split count (its empty tiles write nothing), within
    tol at the per-step pick; padding positions stay zeros."""
    segments, width = _RAGGED_CASES[case]
    q, kp, vp, args, row_ids, q_pos = _ragged_case(gen, dtype, segments, width)
    rows = 1 + max(r for r, _, _ in segments)
    fixed = plan_ragged(row_ids, q_pos, 16, 64, 3, 132, group=3, slots=rows)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    got = ragged_attention(q, kp, vp, plan=fixed.to("cuda"), **args)
    same = ragged_attention(q, kp, vp, plan=_ragged_plan(row_ids, q_pos,
                                                         fixed.splits), **args)
    step = ragged_attention(q, kp, vp, plan=_ragged_plan(row_ids, q_pos), **args)
    assert fixed.tiles >= _ragged_plan(row_ids, q_pos, fixed.splits).tiles
    assert torch.equal(got, same)
    assert (got[valid].float() - step[valid].float()).abs().max().item() <= tol
    assert not got[~valid].any()


# ---------------------------------------------------------------- CUDA graphs

_FAMILY = {"flat": dict(chunk_tokens=64), "dense": dict(chunk_tokens=32, flat=False),
           "monolithic": {}}
# (family, rows as (lens, new tokens), step width): two step shapes each
_GRAPH_CASES = {
    "flat-decode": ("flat", [(70, 1), (15, 1), (33, 1), (100, 1)], 16),
    "flat-mixed": ("flat", [(40, 1), (0, 37), (64, 1)], 64),
    "dense-mixed": ("dense", [(50, 1), (16, 32), (0, 9)], 32),
    "dense-decode": ("dense", [(9, 1), (90, 1), (31, 1), (16, 1)], 1),
    "monolithic-prefill": ("monolithic", [(0, 27)], 32),
    "monolithic-decode": ("monolithic", [(27, 1), (5, 1), (0, 0), (111, 1)], 1),
}


def _small_engine(family, dtype, **kw):
    """SmolLM2-135M's widths (ragged attention takes its d_head of 64 only)
    cut to 2 layers and a 512-token vocabulary."""
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(get_config("smollm2-135m"), n_layers=2, vocab=512)
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", 128, 4, "decode"), device="cuda")
    return Engine(model, model.init(torch.Generator().manual_seed(0)),
                  device="cuda", max_slots=4, page_tokens=16, **_FAMILY[family],
                  **kw)


def _step_inputs(eng, rows, width):
    """Host inputs of one step of ``eng``'s family: each row's pages drawn
    from the pool, its new tokens at positions lens.. (as the engine lays
    them out)."""
    rng = np.random.default_rng(width)
    mp = eng.max_pages
    pages = list(rng.permutation(eng.pool.num_pages - 1) + 1)
    b = 1 if not eng.chunked and width > 1 else eng.slots   # a prefill: [1, b]
    bt = np.zeros((b if not eng.flat else eng.slots, mp), np.int32)
    for r, (l, n) in enumerate(rows):
        need = -(-(l + n) // 16)
        bt[r, :need] = [pages.pop() for _ in range(need)]
    if eng.flat:
        token = np.zeros((1, width), np.int32)
        row_ids = np.full(width, -1, np.int32)
        q_pos = np.zeros(width, np.int32)
        idx = np.zeros(eng.slots, np.int32)
        pos = 0
        for r, (l, n) in enumerate(rows):
            token[0, pos:pos + n] = rng.integers(0, 512, n)
            row_ids[pos:pos + n] = r
            q_pos[pos:pos + n] = l + np.arange(n)
            idx[r] = pos + n - 1
            pos += n
        plan = plan_ragged(row_ids, q_pos, 16, mp, 3, 132, group=3, slots=eng.slots)
        return (token, bt, row_ids, q_pos, idx), plan, np.ones(1, bool)
    token = np.zeros((b, width), np.int32)
    lens = np.zeros(b, np.int32)
    counts = np.zeros(b, np.int32)
    for r, (l, n) in enumerate(rows):
        token[r, :n] = rng.integers(0, 512, n)
        lens[r], counts[r] = l, n
    return (token, bt, lens, counts, None), None, counts > 0


@pytest.mark.parametrize("case", sorted(_GRAPH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_graph_replay_equals_eager_step(gen, dtype, case):
    """After warmup, a step of each family replays its graph: no capture,
    logits bit for bit those of the model's eager step method on the same
    inputs and state (valid rows: an inert row attends over nothing), and
    the replay adds to every wrapper count what the eager call adds."""
    from repro_torch import kernels
    family, rows, width = _GRAPH_CASES[case]
    eng = _small_engine(family, dtype)
    eng.warmup()
    for t in (eng.caches["p0"]["kv"]["k_pages"], eng.caches["p0"]["kv"]["v_pages"]):
        t.copy_(_rand(gen, t.shape, dtype))
    host, plan, valid = _step_inputs(eng, rows, width)
    step = eng._flat_step if eng.flat else eng._paged_step
    graphs = dict(eng.model.trace_counts)
    c0 = kernels.counters()
    args = [None if a is None else torch.from_numpy(a) for a in host]
    got, _ = step(eng.params, eng.caches, *args, plan=plan, graphs=eng._graphs)
    got = got.clone()
    c1 = kernels.counters()
    extra = {} if plan is None else {"plan": plan.to("cuda")}
    want, _ = step.fn(eng.params, eng.caches,
                      *(None if a is None else a.cuda() for a in args), **extra)
    c2 = kernels.counters()
    torch.cuda.synchronize()
    assert dict(eng.model.trace_counts) == graphs
    assert eng.stats()["captures"] == graphs
    mask = torch.from_numpy(valid).cuda()
    assert torch.equal(got[mask], want[mask])
    assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
    assert c1["mmt4d"] - c0["mmt4d"] == 2 * 7 + 1


@pytest.mark.parametrize("family", sorted(_FAMILY))
def test_warmed_engine_captures_nothing_during_a_drain(gen, family):
    """A drain with admissions, chunks, growth and a pool small enough to
    preempt: every step replays a graph captured at warmup, and the counts
    give the expected launches per model call."""
    from repro_torch import kernels
    eng = _small_engine(family, torch.float32, num_pages=1 + 6)
    eng.warmup()
    graphs = eng.stats()["compiles"]
    assert sum(graphs.values()) > 0 and eng.stats()["captures"] == graphs
    calls = []
    name = "_run_flat" if eng.flat else "_run_paged"
    run = getattr(eng, name)
    setattr(eng, name, lambda *a, **k: calls.append(1) or run(*a, **k))
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 512, n), k) for n, k in ((4, 16), (25, 10), (6, 16), (30, 8))]
    kernels.reset_launch_counts()
    for p, k in reqs:
        eng.add_request(p, k)
    fin = eng.drain()
    assert len(fin) == 4 and eng.pool.num_used == 0
    assert eng.num_preemptions + eng.num_pauses >= 1
    assert eng.stats()["compiles"] == graphs
    assert eng.stats()["captures"] == graphs
    n = len(calls)
    want = {"mmt4d": 15 * n, "pack": 5 * n, "unpack": n,
            "ragged_attn": 2 * n if eng.flat else 0}
    assert kernels.launch_counts() == want


@pytest.mark.parametrize("family", sorted(_FAMILY))
def test_engines_share_signatures_and_own_their_graphs(gen, family):
    """Two warmed engines over one model: the second warmup leaves the
    model's trace_counts (signatures per model) where the first left them,
    each engine counts its own captures, and dropping an engine gives back
    its graphs, their static buffers and its pools."""
    import gc

    from repro_torch.serving.engine import Engine
    first = _small_engine(family, torch.float32)
    first.warmup()
    counts = dict(first.model.trace_counts)
    assert first.stats()["captures"] == counts and sum(counts.values()) > 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    second = Engine(first.model, first.model.init(torch.Generator().manual_seed(1)),
                    device="cuda", max_slots=4, page_tokens=16, **_FAMILY[family])
    second.warmup()
    assert dict(first.model.trace_counts) == counts
    assert second.stats()["captures"] == counts == first.stats()["captures"]
    assert not set(map(id, second._graphs.graphs.values())) \
        & set(map(id, first._graphs.graphs.values()))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() > allocated
    del second
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == allocated
    assert torch.cuda.memory_reserved() == reserved
    rng = np.random.default_rng(5)
    for n in (9, 20):
        first.add_request(rng.integers(0, 512, n), 4)
    assert len(first.drain()) == 2
    assert first.stats()["captures"] == counts == dict(first.model.trace_counts)


# ---------------------------------------------------------------------------
# resilience under chaos on the card (f32: survivors exact)
# ---------------------------------------------------------------------------

_CHAOS_PLANS = {"oom-spike": [(0, "oom"), (1, "oom"), (2, "oom")],
                "drafter-burst": [(s, "drafter") for s in (1, 2, 3, 5, 7)],
                "nan-logits": [(3, "nan")],
                "copier-failure": [(1, "copier"), (3, "copier")]}


def _pools(caches):
    """The KV page pools of a cache tree (the ``*_pages`` leaves)."""
    return [t for k, v in caches.items()
            for t in (_pools(v) if isinstance(v, dict) else
                      [v] if k.endswith("_pages") else [])]


def _chaos_drain(eng, events=None):
    """A 48-token prompt A, a 23-token one, A again at 1 and at 3 (its
    three pages cached by then: the prefill restarts inside the last,
    which is copied first) and a 57-token one at 4, on a clock that
    advances one per step, under a plan of ``events``.  Returns each
    request's (tokens, reason) and the faults fired."""
    import contextlib

    from repro_torch.serving.faults import FaultEvent, FaultPlan
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 512, n) for n in (48, 23, 57))
    rids = [eng.add_request(p, n, arrival=t) for p, n, t in
            ((a, 12, 0.0), (b, 16, 0.0), (a, 8, 1.0), (a, 10, 3.0), (c, 10, 4.0))]
    plan = None if events is None else FaultPlan([FaultEvent(s, k) for s, k in events])
    fin, clock = [], 0
    with plan.on(eng) if plan is not None else contextlib.nullcontext():
        while eng.scheduler.has_work or eng._finished_oob:
            fin += eng.step(now=float(clock))
            clock += 1
    eng.drain()
    by = {r.rid: (r.out_tokens, r.finish_reason) for r in fin}
    return [by[r] for r in rids], (None if plan is None else plan.fired)


@pytest.mark.parametrize("family", sorted(_FAMILY))
def test_f32_chaos_identity_and_no_capture(gen, family):
    """Under each plan (every fault kind applies: n-gram speculation and
    the prefix cache are on), every survivor gives the clean drain's
    tokens exactly, the allocator audits clean, the pools never move, and
    the model traces and the engine captures nothing after warmup."""
    from repro_torch.analysis.aliasing import check_pool_consistency
    from repro_torch.analysis.sanitize import install
    eng = _small_engine(family, torch.float32, spec_tokens=2, prefix_cache=True)
    san = install(eng)
    eng.warmup()
    traces, captures = dict(eng.model.trace_counts), eng.stats()["captures"]
    pools = [t.data_ptr() for t in _pools(eng.caches)]
    clean, _ = _chaos_drain(eng)
    assert all(r == "length" for _, r in clean)
    for name, events in sorted(_CHAOS_PLANS.items()):
        eng.prefix_cache.clear()
        out, fired = _chaos_drain(eng, events)
        assert sum(fired.values()) > 0, name
        for got, want in zip(out, clean):
            if got[1] != "error":
                assert got == want, name
        assert not check_pool_consistency(eng, name)
        assert eng.pool.num_used == len(set(eng.prefix_cache.pages()))
        assert dict(eng.model.trace_counts) == traces, name
        assert eng.stats()["captures"] == captures, name
    assert [t.data_ptr() for t in _pools(eng.caches)] == pools
    assert eng.stats()["resilience"]["quarantines"] == 1 and san.checks > 0


def test_copier_fault_leaves_pools_and_refcounts(gen):
    """An injected copier failure raises before the device copy is
    launched: the failed copy-on-write leaves the refcounts, the free
    list, every pool's storage and its contents as they were, and the
    request re-prefills the page instead."""
    from repro_torch.serving.kv_cache import PoolError
    eng = _small_engine("flat", torch.float32, prefix_cache=True)
    eng.warmup()
    pools = _pools(eng.caches)
    cow, seen = eng.pool.cow, []

    def watched(seq, idx):
        ledger = eng.pool.ledger()
        ptrs = [t.data_ptr() for t in pools]
        torch.cuda.synchronize()
        contents = [t.clone() for t in pools]
        try:
            return cow(seq, idx)
        except PoolError as e:
            torch.cuda.synchronize()
            assert eng.pool.ledger() == ledger
            assert [t.data_ptr() for t in pools] == ptrs
            assert all(torch.equal(t, c) for t, c in zip(pools, contents))
            seen.append(str(e))
            raise

    eng.pool.cow = watched
    out, fired = _chaos_drain(eng, _CHAOS_PLANS["copier-failure"])
    assert fired["copier"] == 2 and len(seen) == 2
    assert all("injected page_copier failure" in m for m in seen)
    del eng.pool.cow
    eng.prefix_cache.clear()
    clean, _ = _chaos_drain(eng)
    assert out == clean
    assert eng.pool.cow_copies == 2

