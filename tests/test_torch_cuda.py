"""The port's CUDA kernels against their plain versions on the card, at
small shapes (chip_smoke.py repeats this at the full SmolLM2 widths;
ragged attention also at d_head 128 for the groups of the served configs,
1, 4, 7 and 16, at every split count), and
the CUDA graphs of the three serving step families on SmolLM2 cut to 2
layers (and of the flat step at Qwen3-8B's widths, cut to 2 layers):
replay bit for bit the eager step, with the same launch counts, and no
capture during a drain after warmup; the static batch loop's ``"decode"``
step (SmolLM2's and whisper-small's widths, cut in depth) likewise, with
whisper's biased tanh-GELU mmt4d at its full widths.  Training: mmt4d's
gradient kernels
(dgrad, wgrad with the fused bias gradient and activation) against their
plain versions, the autograd Functions (mmt4d, pack, unpack, linear) on the
card against the CPU, one float32 train step of reduced SmolLM2, card
against CPU, and the compiled train step (SmolLM2's widths cut to 2 layers,
f32 and bf16): replay = eager bit for bit, one capture, another state
refused, a dropped trainer's memory given back.  The recurrent mixers: the
wkv6 kernel against its plain version (decode rows and prefills, the state
written in place, one launch a call, bit-identical repeats), its
backward kernel against its plain version and autograd through the
forward's (chunk edges, extreme decays, every head width), and an RWKV-6
engine at d_head 64 (2 layers): a
second drain captures no graph and repeats the first's tokens, the prefill
graph's state tree keeps its pointers, and the f32 drain equals the CPU's.
The moe family: the expert-batched mmt4d (B_pack [E, ...], the expert dim
in the grid) against its plain version and the 2-D kernel, the moe layer
on the card against the CPU, and a reduced qwen3-moe engine's drains.
Mamba: the selective_scan kernel against its plain version (decode rows
from a cached state, prefills from zero and from a cached state, N = 8
and 16, strided views of the projections' outputs, the state written in
place, bit-identical repeats, refusals: another N, mixed dtypes), its
backward kernel against its plain version (chunk edges, strided and
unaligned views, f32 and bf16), the expert-batched gradient kernels at 16
and 128 experts, and a reduced jamba engine (moe on) whose second drain captures
nothing and whose f32 drain equals the CPU's.
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
from repro_torch.kernels.mmt4d.ops import mmt4d, mmt4d_dgrad, mmt4d_wgrad
from repro_torch.kernels.mmt4d.ref import (mmt4d_dgrad_ref, mmt4d_ref,
                                           mmt4d_wgrad_ref)
from repro_torch.kernels.pack.ops import pack
from repro_torch.kernels.pack.ref import pack_ref
from repro_torch.kernels.ragged_attn.ops import (plan_ragged, ragged_attention,
                                                 ragged_attention_partial)
from repro_torch.kernels.ragged_attn.ref import (combine_partials,
                                                 ragged_attention_partial_ref,
                                                 ragged_attention_ref)
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


@pytest.mark.parametrize("shape", [(576, 0), (0, 576), (2, 0, 576)])
def test_pack_of_an_empty_tensor_launches_nothing(gen, shape):
    """A rank's empty share of a weight's tiles (2 K/V tiles over 4 model
    ranks): an empty pack of the packed shape, as the plain version's, and
    no launch."""
    a = torch.empty(shape, device="cuda").T if len(shape) == 2 \
        else torch.empty(shape, device="cuda")
    before = pack.launches
    got = pack(a, 128, 128)
    assert got.shape == pack_ref(a.cpu(), 128, 128).shape and got.numel() == 0
    assert pack.launches == before


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


def _expert_case(gen, dtype, e, m, k_o, n):
    """Packed A [E, M_o, K_o, m_r, k_r] from [E, m, K], B [E, N_o, K_o,
    n_r, k_r] from [E, K, N] scaled to unit outputs, a bias [E, N_o, n_r]."""
    lay = make_layout("scalable", query("cuda"), dtype)
    k = k_o * lay.k_r
    ap = packing.pack_lhs(_rand(gen, (e, m, k), dtype), lay)
    bp = packing.pack_rhs((_rand(gen, (e, k, n), dtype).float() * k ** -0.5)
                          .to(dtype), lay)
    bias = Epilogue().bias_pack(_rand(gen, (e, n), dtype), lay)
    return ap, bp, bias


# f32: within 1e-5 of the largest |value| (sums in another order); bf16 as
# the 2-D kernel's cases
_EXPERT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("e,m,k_o,n", [(1, 16, 5, 192), (4, 16, 3, 384),
                                       (128, 16, 4, 256), (8, 40, 2, 130),
                                       (16, 1, 12, 576)],
                         ids=["e1", "e4", "e128", "e8_m40", "e16_down"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mmt4d_expert_batched_matches_plain(gen, dtype, e, m, k_o, n):
    """The expert-batched kernel (B_pack [E, N_o, K_o, n_r, k_r], the expert
    dim in the grid) against its plain version, with and without the
    per-expert bias, silu and no activation, packed and through the
    unpacked store (which equals the packed store then unpack, bit for
    bit): one launch a call, counted as expert-batched; each expert equal
    bit for bit to the same kernel on that expert alone (E = 1, the 2-D
    call), in float32; in bfloat16 where the 2-D call picks the same split."""
    ap, bp, bias = _expert_case(gen, dtype, e, m, k_o, n)
    tol = _EXPERT_TOL[dtype]
    for b, act in ((None, None), (bias, None), (None, "silu"), (bias, "silu")):
        before = (mmt4d.launches, mmt4d.expert_batched, mmt4d.unpacked_stores)
        got = mmt4d(ap, bp, b, activation=act)
        packed_then = unpack(got, m, n)
        flat = mmt4d(ap, bp, b, activation=act, unpack_to=(m, n))
        assert (mmt4d.launches, mmt4d.expert_batched, mmt4d.unpacked_stores) == \
            (before[0] + 2, before[1] + 2, before[2] + 1)
        want = mmt4d_ref(ap, bp, b, activation=act)
        assert got.shape == want.shape == (e, *ap.shape[1:2], bp.shape[1],
                                           ap.shape[3], bp.shape[3])
        assert _close(got, want, tol), (b is not None, act)
        assert flat.shape == (e, m, n) and torch.equal(flat, packed_then)
        assert torch.equal(mmt4d(ap, bp, b, activation=act), got)   # repeatable
        for x in sorted({0, e - 1}):
            one = mmt4d(ap[x:x + 1], bp[x:x + 1],
                        None if b is None else b[x:x + 1], activation=act)
            two_d = mmt4d(ap[x], bp[x], None if b is None else b[x], activation=act)
            assert torch.equal(one[0], two_d)          # E = 1 is the 2-D kernel
            if dtype == torch.float32:
                assert torch.equal(got[x], two_d)


def test_mmt4d_expert_batched_refuses_what_it_does_not_take(gen):
    ap, bp, bias = _expert_case(gen, torch.bfloat16, 4, 16, 2, 256)
    with pytest.raises(ValueError, match="do not contract"):
        mmt4d(ap[:3], bp)                       # experts differ
    with pytest.raises(ValueError, match="do not contract"):
        mmt4d(ap[0], bp)                        # a 2-D A and expert B
    with pytest.raises(ValueError, match="bias"):
        mmt4d(ap, bp, bias[0])


def _moe_pair(dtype, cf=1.25):
    """A reduced qwen3-moe (2 layers) on the card and on the CPU, one set
    of weights."""
    import dataclasses
    from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
    from repro_torch.models.model import build_model
    # heads of 64: the ragged attention kernel's narrowest width
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-moe-235b-a22b"),
                                             layers=2), capacity_factor=cf,
                              d_head=64)
    run = RunConfig(param_dtype=str(dtype)[6:], compute_dtype=str(dtype)[6:])
    shape = ShapeSpec("serve", 64, 3, "decode")
    cpu = build_model(cfg, run, shape, hw=query("cpu", "tpu_v5e"), device="cpu")
    card = build_model(cfg, run, shape, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    return cpu, card, params


def test_moe_layer_card_equals_cpu(gen):
    """moe_apply on the card (router, sort, dispatch, three expert-batched
    mmt4d launches, combine) against the CPU's plain path, float32, at a
    heavy-drop capacity and the default: y within 1e-5, the aux losses
    within 1e-6 and the dropped fraction equal; twice, bit for bit."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    for cf in (1.25, 0.01):
        cpu, card, params = _moe_pair(torch.float32, cf)
        ffn = tfm.tree_map(lambda t: t[0], params["groups"]["p0"]["ffn"])
        x = torch.randn((2, 20, cpu.cfg.d_model), generator=torch.Generator().manual_seed(1))
        want, jaux = moe.moe_apply(ffn, x, cpu.ctx, cpu.cfg)
        cffn = tfm.tree_map(lambda t: t.cuda(), ffn)
        before = mmt4d.expert_batched
        got, aux = moe.moe_apply(cffn, x.cuda(), card.ctx, card.cfg)
        assert mmt4d.expert_batched == before + 3
        assert _close(got.cpu(), want, 1e-5)
        for k in ("load_balance", "router_z"):
            assert abs(float(aux[k]) - float(jaux[k])) <= 1e-6 * max(1.0, abs(float(jaux[k])))
        assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
        again, _ = moe.moe_apply(cffn, x.cuda(), card.ctx, card.cfg)
        assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("family", ["flat", "monolithic"])
def test_moe_drain_replays_and_captures_nothing(gen, family, dtype):
    """A warmed engine of the reduced qwen3-moe: the drain captures no graph
    and every expert product is an expert-batched launch; a second drain
    repeats its tokens; in float32 the tokens are the CPU's."""
    from repro_torch.serving.engine import Engine
    cpu, card, params = _moe_pair(dtype)
    kw = dict(max_slots=3, page_tokens=16,
              **({"chunk_tokens": 32} if family == "flat" else {}))
    eng = Engine(card, params, device="cuda", **kw)
    eng.warmup()
    caps = dict(eng.stats()["captures"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cpu.cfg.vocab, n) for n in (13, 21, 7)]

    def drain(e):
        rids = [e.add_request(p, 6) for p in prompts]
        fin = {r.rid: r.out_tokens for r in e.drain()}
        return [fin[r] for r in rids]

    before = mmt4d.expert_batched
    first = drain(eng)
    assert mmt4d.expert_batched > before
    assert drain(eng) == first
    if family == "flat":        # the monolithic prefills capture per length
        assert dict(eng.stats()["captures"]) == caps
    if dtype == torch.float32:
        assert first == drain(Engine(cpu, params, device="cpu", **kw))


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


def _ragged_case(gen, dtype, segments, width, pages=400, mp=64, hq=9, hkv=3,
                 dh=64):
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
    q = _rand(gen, (width, hq, dh), dtype)
    kp = _rand(gen, (pages, 16, hkv, dh), dtype)
    vp = _rand(gen, (pages, 16, hkv, dh), dtype)
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


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("group", [1, 4, 7, 16])
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_kernel_d128_every_split_and_group(gen, dtype, tol, group, splits):
    """d_head 128 at the groups of the served configs (OLMo-1B 1, Qwen3-8B
    4, Qwen2-7B 7, ChatGLM3-6B 16: 8-position tiles) over two KV heads, at
    every cluster size: page edges, a long decode row, a prefill chunk
    whose first rows see fewer pages than the split count, a row shorter
    than it and trailing padding.  Valid positions within tol of the plain
    version, padding zeros, one launch, repeats bit-identical."""
    segments = [(0, 1000, 1), (1, 15, 1), (2, 16, 1), (3, 200, 40), (4, 20, 3),
                (5, 17, 9)]
    q, kp, vp, args, row_ids, q_pos = _ragged_case(
        gen, dtype, segments, 64, hq=2 * group, hkv=2, dh=128)
    plan = _ragged_plan(row_ids, q_pos, splits, hkv=2, hq=2 * group)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    before = ragged_attention.launches
    out = ragged_attention(q, kp, vp, plan=plan, **args)
    assert ragged_attention.launches == before + 1
    want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
    assert (out[valid].float() - want).abs().max().item() <= tol
    assert not out[~valid].any()
    for _ in range(2):
        assert torch.equal(ragged_attention(q, kp, vp, plan=plan, **args), out)


@pytest.mark.parametrize("dh", [32, 96, 256])
def test_ragged_kernel_refuses_other_head_widths(gen, dh):
    q, kp, vp, args, row_ids, q_pos = _ragged_case(
        gen, torch.bfloat16, [(0, 10, 1)], 16, dh=dh)
    with pytest.raises(ValueError, match="d_head"):
        ragged_attention(q, kp, vp, plan=_ragged_plan(row_ids, q_pos), **args)


def test_ragged_kernel_needs_a_plan(gen):
    q, kp, vp, args, _, _ = _ragged_case(gen, torch.bfloat16, [(0, 10, 1)], 16)
    with pytest.raises(ValueError, match="plan"):
        ragged_attention(q, kp, vp, **args)


def test_ragged_bf16_runs_on_tensor_cores_f32_does_not(gen):
    funcs = _sass_by_function()
    bf16 = [v for k, v in funcs.items() if "ragged_attn_kernel" in k and "bfloat16" in k]
    f32 = [v for k, v in funcs.items() if "ragged_attn_kernel" in k and "bfloat16" not in k]
    assert len(bf16) == 2 and len(f32) == 2, sorted(funcs)   # d_head 64 and 128
    assert all("HMMA.16816.F32.BF16" in v for v in bf16)
    assert not any("HMMA" in v for v in f32)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("heads", [(9, 3, 64), (32, 8, 128)], ids=["d64", "qwen3"])
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_partial_matches_plain_and_combines_to_whole(gen, dtype, tol,
                                                            heads, splits):
    """The partial form over half the pages each (the pools hold global
    pages [lo, hi) and a trash slot): each rank's output within tol of its
    plain version where the row has a key on the rank, its log-sum-exp
    within 1e-4 (-inf exactly where the plain version's is), padding zeros
    and -inf, one launch, bit-identical repeats; the two halves combined
    (combine_partials) within tol of the whole plain version."""
    hq, hkv, dh = heads
    segments = [(0, 1000, 1), (1, 15, 1), (2, 200, 40), (3, 20, 3), (4, 0, 5)]
    q, kp, vp, args, row_ids, q_pos = _ragged_case(gen, dtype, segments, 64,
                                                   hq=hq, hkv=hkv, dh=dh)
    plan = _ragged_plan(row_ids, q_pos, splits, hkv=hkv, hq=hq)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    outs, lses = [], []
    for lo, hi in ((0, 200), (200, 400)):
        lk = torch.cat([kp[lo:hi], torch.zeros_like(kp[:1])])
        lv = torch.cat([vp[lo:hi], torch.zeros_like(vp[:1])])
        kw = dict(page_lo=lo, page_count=hi - lo, **args)
        before = ragged_attention_partial.launches
        o, lse = ragged_attention_partial(q, lk, lv, plan=plan, **kw)
        assert ragged_attention_partial.launches == before + 1
        wo, wl = ragged_attention_partial_ref(q, lk, lv, **kw)
        held = torch.isfinite(wl)
        assert torch.equal(torch.isfinite(lse), held)
        assert (lse[held] - wl[held]).abs().max().item() <= 1e-4
        rows = held.all(dim=1) & valid
        assert (o[rows].float() - wo[rows].float()).abs().max().item() <= tol
        assert not o[~valid].any() and torch.isinf(lse[~valid]).all()
        for _ in range(2):
            o2, l2 = ragged_attention_partial(q, lk, lv, plan=plan, **kw)
            assert torch.equal(o2, o) and torch.equal(l2, lse)
        outs.append(o)
        lses.append(lse)
    got = combine_partials(outs, lses)[valid]
    want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("unpacked", [False, True], ids=["packed", "unpacked"])
@pytest.mark.parametrize("m_o,k_o,n_o", [(1, 16, 32), (4, 48, 16), (1, 2, 3)])
def test_mmt4d_bf16_partial_is_the_float32_sum(gen, m_o, k_o, n_o, unpacked):
    """The float32 partial of a row-parallel product across ranks (its K
    tiles: Qwen3-8B's O and down projections over half of K at decode):
    the float32 sums within 1e-4 of the plain version's, and rounded to
    bf16 bit for bit the kernel's own bf16 store of the same call (the same
    sums, no epilogue); one launch, counted in ``mmt4d.partials``."""
    bf = torch.bfloat16
    ap = _rand(gen, (m_o, k_o, 16, 128), bf)
    bp = (_rand(gen, (n_o, k_o, 128, 128), bf).float() * (k_o * 128) ** -0.5).to(bf)
    to = (m_o * 16 - 3, n_o * 128 - 64) if unpacked else None
    before = (mmt4d.launches, mmt4d.partials)
    got = mmt4d(ap, bp, unpack_to=to, partial=True)
    assert (mmt4d.launches, mmt4d.partials) == (before[0] + 1, before[1] + 1)
    want = mmt4d_ref(ap, bp, out_dtype=torch.float32)
    if unpacked:
        want = unpack_ref(want, *to)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _close(got, want, 1e-4)
    assert torch.equal(got.to(bf), mmt4d(ap, bp, unpack_to=to))


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
            "ragged_attn": 2 * n if eng.flat else 0, "ragged_attn_partial": 0,
            "mmt4d_dgrad": 0, "mmt4d_wgrad": 0, "wkv6": 0,
            "selective_scan": 0, "wkv6_bwd": 0, "selective_scan_bwd": 0}
    assert kernels.launch_counts() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qwen3_widths_flat_drain_replays_the_eager_step(gen, dtype):
    """Qwen3-8B's widths (d 4096, 32 query heads over 8 KV heads of 128,
    qk_norm, d_ff 12288, its untied head over vocab 151936) cut to 2
    layers, served flat: every step of a drain after warmup replays a
    graph captured at warmup, its logits bit for bit the model's eager
    step on the same inputs and state, with the same wrapper counts; per
    model call 2 x 7 + 1 mmt4d, 2 ragged attention and 1 unpack."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2)
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", 256, 4, "decode"), device="cuda")
    eng = Engine(model, model.init(torch.Generator(device="cuda").manual_seed(0)),
                 device="cuda", max_slots=4, page_tokens=16, chunk_tokens=64)
    eng.warmup()
    graphs = eng.stats()["captures"]
    step, calls = eng._flat_step, []

    def checked(params, caches, *args, plan=None, graphs=None):
        c0 = kernels.counters()
        out, caches = step(params, caches, *args, plan=plan, graphs=graphs)
        out = out.clone()
        c1 = kernels.counters()
        want, _ = step.fn(params, caches, *(a.cuda() for a in args),
                          plan=plan.to("cuda"))
        c2 = kernels.counters()
        kernels.add_counts({k: c2[k] - c1[k] for k in c2}, -1)
        assert torch.equal(out, want)
        assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
        calls.append(c1["pack"] - c0["pack"])
        return out, caches

    eng._flat_step = checked
    rng = np.random.default_rng(6)
    kernels.reset_launch_counts()
    rids = [eng.add_request(rng.integers(0, cfg.vocab, n), 6) for n in (40, 100, 7, 70)]
    fin = eng.drain()
    assert sorted(r.rid for r in fin) == sorted(rids)
    assert all(len(r.out_tokens) == 6 for r in fin) and eng.pool.num_used == 0
    assert eng.stats()["captures"] == graphs
    n = len(calls)
    got = kernels.launch_counts()
    assert (got["mmt4d"], got["ragged_attn"], got["unpack"], got["pack"]) == \
        (15 * n, 2 * n, n, sum(calls))


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



# ---------------------------------------------------------------- training

_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_case(gen, dtype, lead, m, k, n, act, lay=None):
    lay = lay or make_layout("scalable", query("cuda"), dtype)
    ap = packing.pack_lhs(_rand(gen, (*lead, m, k), dtype), lay)
    bp = packing.pack_rhs(_rand(gen, (k, n), dtype), lay)
    dy = packing.pack_out(_rand(gen, (*lead, m, n), dtype), lay)
    z = None if act is None else packing.pack_out(_rand(gen, (*lead, m, n), dtype), lay)
    return ap, bp, dy, z


@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "tanh"])
@pytest.mark.parametrize("lead,m,k,n", [((), 40, 200, 136), ((2,), 33, 576, 1536),
                                        ((1,), 16, 1536, 576), ((), 100, 320, 640),
                                        ((4,), 1024, 576, 192), ((), 256, 576, 8192)],
                         ids=["ragged", "gate", "down", "p-off-64", "split-wgrad",
                              "split-dgrad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mmt4d_grad_kernels_match_plain(gen, dtype, lead, m, k, n, act):
    """dgrad and wgrad (with the fused bias gradient) against their plain
    versions; M and K off the tiles; padding rows and columns of the packed
    results zero, as the plain versions give them.  bfloat16 splits its
    reduction in a cluster at ``split-wgrad`` (wgrad over 4,096 tokens
    into 5 output tiles: 8 splits) and ``split-dgrad`` (dgrad over 8,192
    columns into 5 tiles: 8 splits); dgrad's P is 48 and 112 at
    ``ragged`` and ``p-off-64``."""
    ap, bp, dy, z = _grad_case(gen, dtype, lead, m, k, n, act)
    tol = _GRAD_TOL[dtype]
    fold = lambda t: None if t is None else t.reshape(-1, *t.shape[-3:])
    da = mmt4d_dgrad(dy, bp, z, activation=act)
    want_da = mmt4d_dgrad_ref(fold(dy), bp, fold(z), activation=act)
    assert _close(da, want_da.reshape(da.shape), tol)
    db, dbias = mmt4d_wgrad(dy, ap, z, activation=act, bias=True)
    want_db, want_bias = mmt4d_wgrad_ref(fold(dy), fold(ap), fold(z),
                                         activation=act, bias=True)
    assert _close(db, want_db, tol) and _close(dbias, want_bias, tol)


@pytest.mark.parametrize("lead,m,k,n", [((2,), 40, 576, 192), ((4,), 1024, 576, 192),
                                        ((), 256, 576, 8192)],
                         ids=["plain", "split-wgrad", "split-dgrad"])
def test_mmt4d_grad_kernels_one_launch_and_bit_identical(gen, lead, m, k, n):
    """One launch per call and bit-identical repeats, with and without a
    split reduction (the cluster sums its splits in a fixed order)."""
    ap, bp, dy, z = _grad_case(gen, torch.bfloat16, lead, m, k, n, "silu")
    d0, w0 = mmt4d_dgrad.launches, mmt4d_wgrad.launches
    first = (mmt4d_dgrad(dy, bp, z, activation="silu"),
             *mmt4d_wgrad(dy, ap, z, activation="silu", bias=True))
    assert (mmt4d_dgrad.launches - d0, mmt4d_wgrad.launches - w0) == (1, 1)
    again = (mmt4d_dgrad(dy, bp, z, activation="silu"),
             *mmt4d_wgrad(dy, ap, z, activation="silu", bias=True))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_mmt4d_grad_bf16_runs_on_tensor_cores_f32_does_not(gen):
    """bfloat16's gradient kernel runs warpgroup MMAs (HGMMA) on operands
    that TMA brings in (UTMALDG); float32 runs on neither tensor-core path."""
    funcs = _sass_by_function()
    tc = [v for k, v in funcs.items() if "packed_gemm_wgmma_kernel" in k]
    f32 = [v for k, v in funcs.items() if "packed_gemm_kernel" in k]
    # dgrad, wgrad with and without the bias gradient, and the
    # expert-batched dgrad and wgrad; f32: dgrad and wgrad
    assert len(tc) == 5 and len(f32) == 2, sorted(funcs)
    assert all("HGMMA" in v and "UTMALDG" in v for v in tc)
    assert not any("HMMA" in v or "HGMMA" in v for v in f32)


def test_grad_wrappers_refuse_what_the_kernels_do_not_take(gen):
    ap, bp, dy, z = _grad_case(gen, torch.float32, (), 16, 128, 128, "silu")
    with pytest.raises(ValueError):
        mmt4d_dgrad(dy, bp, activation="silu")          # no pre-activation
    with pytest.raises(ValueError):
        mmt4d_dgrad(dy, bp.cpu())
    with pytest.raises(TypeError):
        mmt4d_wgrad(dy, ap.to(torch.bfloat16))


@pytest.mark.parametrize("keep_packed", [False, True], ids=["exit", "packed"])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_linear_grads_card_equal_cpu(gen, act, keep_packed):
    """linear_apply's gradients (mmt4d, pack_lhs, pack_rhs, the unpacked
    store, the bias) in float32 on the card against the CPU's plain path,
    M and K off the tiles.  Tolerance 1e-5 of the largest gradient: float32
    sums in another order."""
    from repro_torch.core.hardware import presets
    from repro_torch.core.linear import MatmulContext, linear_apply
    from repro_torch.core.propagation import PackedArray
    outs = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator().manual_seed(3)
        x = torch.randn(2, 37, 200, generator=g).to(dev).requires_grad_(True)
        w = (torch.randn(200, 136, generator=g) * 0.1).to(dev).requires_grad_(True)
        b = torch.randn(136, generator=g).to(dev).requires_grad_(True)
        y = linear_apply({"w": w, "b": b}, x, MatmulContext(hw=presets["tpu_v5e"]),
                         activation=act, keep_packed=keep_packed)
        y = y.unpack() if isinstance(y, PackedArray) else y
        (y * torch.linspace(-1, 1, 136, device=dev)).sum().backward()
        outs[dev] = [t.grad.cpu() for t in (x, w, b)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_train_step_card_equals_cpu(gen):
    """One float32 train step of reduced SmolLM2 (2 layers, seq 32, batch
    2) from one state on the card and on the CPU.  Loss within 1e-5
    relative and every gradient leaf within 1e-5 of its largest entry
    (float32 sums in another order).  After the AdamW step every parameter
    within 1e-6, except where a near-zero gradient's sign differs, which
    Adam's first step turns into a difference of up to 2 * lr: counted, at
    most 1 in 10,000 entries, none above 2 * lr."""
    from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.core.hardware import presets
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import leaves, make_optimizer, tree_map
    from repro_torch.training.step import make_train_step, value_and_grad
    from repro_torch.training.train_state import TrainState
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    shape = ShapeSpec("t", 32, 2, "train")
    run = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                    warmup_steps=1)
    batch = SyntheticLM(cfg, shape, seed=0).batch_at(0)
    params = build_model(cfg, run, shape, device="cpu").init(
        torch.Generator().manual_seed(0))
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, run, shape, hw=presets["tpu_v5e"], device=dev)
        opt = make_optimizer(run, 10)
        p = tree_map(lambda t: t.to(dev), params)
        (loss, _), grads = value_and_grad(model, p, batch)
        st, _ = make_train_step(model, opt, run)(TrainState.create(p, opt), batch)
        res[dev] = (float(loss), [t.cpu() for t in leaves(grads)],
                    [t.cpu() for t in leaves(st.params)])
    lr = make_optimizer(run, 10).schedule(0)
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    off = total = 0
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        d = (a - b).abs()
        assert d.max() <= 2 * lr * 1.0001
        off += int((d > 1e-6).sum())
        total += d.numel()
    assert off <= total // 10_000


# ---------------------------------------------------------------------------
# the compiled train step: one CUDA graph per signature, the state in place
# ---------------------------------------------------------------------------

def _train_setup(dtype):
    """SmolLM2 at its full widths cut to 2 layers, seq 128, batch 2, AdamW
    with one warmup step."""
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import make_optimizer
    cfg = dataclasses.replace(get_config("smollm2-135m"), n_layers=2)
    shape = ShapeSpec("t", 128, 2, "train")
    run = RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False,
                    warmup_steps=1)
    model = build_model(cfg, run, shape, device="cuda")
    return model, make_optimizer(run, 10), run, SyntheticLM(cfg, shape, seed=0)


def _state_leaves(state):
    from repro_torch.training.optimizer import leaves
    return leaves({"p": state.params, "o": state.opt_state})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_compiled_train_step_replay_equals_eager(gen, dtype):
    """Two states from one init, three steps each: one through the compiled
    step's eager ``fn``, the other through the compiled step (eager and
    captured on the first call, replayed on the next two).  After every
    step the loss, grad_norm and every parameter and optimizer-state leaf
    agree bit for bit, each state leaf keeps its address, and each call
    adds the launches the eager step made; one signature, one capture."""
    from repro_torch import kernels
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.step import CompiledTrainStep
    from repro_torch.training.train_state import TrainState
    model, opt, run, data = _train_setup(dtype)
    step = CompiledTrainStep(model, opt, run)
    init = model.init(torch.Generator().manual_seed(0))
    eager, graph = (TrainState.create(tree_map(torch.clone, init), opt) for _ in range(2))
    ptrs = [t.data_ptr() for t in _state_leaves(graph)]
    for i in range(3):
        batch = data.batch_at(i)
        kernels.reset_launch_counts()
        eager, em = step.fn(eager, {k: torch.as_tensor(v, device="cuda")
                                    for k, v in batch.items()})
        torch.cuda.synchronize()
        want = kernels.launch_counts()
        kernels.reset_launch_counts()
        graph, gm = step(graph, batch)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == want and want["mmt4d_wgrad"] > 0
        assert eager.step == graph.step == i + 1
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(em[k], gm[k]), k
        assert [t.data_ptr() for t in _state_leaves(graph)] == ptrs
        assert all(torch.equal(a, b) for a, b in zip(_state_leaves(eager),
                                                     _state_leaves(graph)))
    assert step.captures == 1 and model.trace_counts["train"] == 1


def test_compiled_train_step_refuses_another_state(gen):
    """The step's graphs bind the state of its first call; a call with
    another state's tensors raises, before anything runs."""
    from repro_torch.training.step import CompiledTrainStep
    from repro_torch.training.train_state import TrainState
    model, opt, run, data = _train_setup("bfloat16")
    step = CompiledTrainStep(model, opt, run)
    state, _ = step(TrainState.create(model.init(torch.Generator().manual_seed(0)), opt),
                    data.batch_at(0))
    other = TrainState.create(model.init(torch.Generator().manual_seed(1)), opt)
    with pytest.raises(ValueError, match="another state"):
        step(other, data.batch_at(1))
    assert step.captures == 1


def test_dropped_trainer_frees_its_graph(gen):
    """A trainer's graph, its static buffers and its pool go with the
    trainer: after a first trainer has warmed the model's capture stream,
    a second one fitted and dropped (with its state) gives back every byte
    allocated and reserved."""
    import gc

    from repro_torch.training.trainer import Trainer
    model, _, run, data = _train_setup("bfloat16")

    def fit():
        t = Trainer(model, data, run, total_steps=3, log_fn=lambda *_: None)
        state, _ = t.fit(torch.Generator().manual_seed(0))
        assert t.step_fn.captures == 1 and state.step == 3
        return t, state

    t, state = fit()
    del t, state
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t, state = fit()
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() > reserved
    del t, state
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == allocated
    assert torch.cuda.memory_reserved() == reserved


def _pool_bytes() -> tuple:
    """(bytes allocated in the caching allocator's default pool, bytes
    reserved in graphs' private pools)."""
    segs = torch.cuda.memory._snapshot()["segments"]
    default = [seg for seg in segs if tuple(seg["segment_pool_id"]) == (0, 0)]
    return (sum(seg["allocated_size"] for seg in default),
            sum(seg["total_size"] for seg in segs) - sum(seg["total_size"] for seg in default))


def test_moe_train_capture_holds_one_steps_transients(gen):
    """C11: a moe train step (Qwen3-MoE's layout at 1 layer, d 1024, 16
    experts, a 32,768-token vocabulary; bf16, float32 moments, 4 x 512
    tokens) through the compiled step.  After its eager warmup and
    capture, the memory allocated outside the graph's pool is the state
    plus a slack (the step's inputs and metrics, cuBLAS's workspace: 10 %
    of the state or 256 MiB), not the state plus the warmup's transients;
    and the graph's pool, which a capture cannot give back to the device
    while it runs, holds no more than the step's transients plus that
    slack (each transient found a block its earlier ones left: the
    optimizer updates large leaves in slices)."""
    import dataclasses
    import gc

    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import CompiledTrainStep
    from repro_torch.training.train_state import TrainState
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=1, d_model=1024,
                              n_heads=8, n_kv_heads=2, n_experts=16, top_k=2,
                              d_ff_expert=512, d_ff=512, vocab=32768)
    shape = ShapeSpec("t", 512, 4, "train")
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", remat=False,
                    warmup_steps=1)
    model = build_model(cfg, run, shape, device="cuda")
    opt = make_optimizer(run, 10)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, _ = _pool_bytes()
    state = TrainState.create(model.init(torch.Generator(device="cuda").manual_seed(0)),
                              opt)
    state_bytes = sum(t.untyped_storage().nbytes() for t in _state_leaves(state))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = CompiledTrainStep(model, opt, run)
    state, _ = step(state, SyntheticLM(cfg, shape, seed=0).batch_at(0))
    torch.cuda.synchronize()
    transients = torch.cuda.max_memory_allocated() - base
    slack = max(256 * 2**20, state_bytes // 10)
    outside, pool = _pool_bytes()
    outside -= before
    assert step.captures == 1
    assert transients > 2 * slack, (transients, slack)   # the test can tell
    assert outside <= state_bytes + slack, (outside, state_bytes, transients)
    assert pool <= transients + slack, (pool, transients, slack)


# ---------------------------------------------------------------------------
# the static batch loop on the card: the dense-cache "decode" step
# ---------------------------------------------------------------------------

def _static_engine(arch, dtype):
    """Each model's full widths cut to 2 layers (whisper: 2 + 2) and a
    512-token vocabulary, seq_len 128, batch 3."""
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = dataclasses.replace(get_config(arch), n_layers=2, vocab=512,
                              encoder_layers=2 if arch == "whisper-small" else 0)
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", 128, 3, "decode"), device="cuda")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 device="cuda", max_slots=3)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 512, (3, 21)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((3, model.enc_len, cfg.d_model)
                                              ).astype(np.float32)
    return eng, batch


@pytest.mark.parametrize("arch", ["smollm2-135m", "whisper-small"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_static_decode_replay_equals_eager_step(gen, arch, dtype):
    """A static batch captures the prefill and decode graphs on its first
    call and nothing on its second (the same tokens); then each graph's
    replay equals the model's eager decode_step bit for bit on the same
    inputs and cache, adding to every wrapper count what the eager call
    adds; and an eager step reads nothing back to the host."""
    from repro_torch import kernels
    eng, batch = _static_engine(arch, dtype)
    first = eng.generate_static(batch, 6)
    made = (dict(eng.model.trace_counts), dict(eng._graphs.captures))
    assert made[0]["decode"] == made[1]["decode"] == 2
    np.testing.assert_array_equal(eng.generate_static(batch, 6), first)
    assert (dict(eng.model.trace_counts), dict(eng._graphs.captures)) == made
    [caches] = eng._static_bufs.values()
    step = eng._decode_step
    for tok, p in ((torch.from_numpy(batch["tokens"]), 0),
                   (torch.from_numpy(first[:, -1:].copy()), 40)):
        pos = torch.full((), p, dtype=torch.int32, device="cuda")
        c0 = kernels.counters()
        got, _ = step(eng.params, caches, tok, pos, None, graphs=eng._graphs)
        got = got.clone()
        c1 = kernels.counters()
        want, _ = step.fn(eng.params, caches, tok.cuda(), pos, None)
        c2 = kernels.counters()
        assert torch.equal(got, want)
        assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
        assert c1["mmt4d.bias_activation"] - c0["mmt4d.bias_activation"] == \
            (2 if arch == "whisper-small" else 0)
    assert dict(eng._graphs.captures) == made[1]
    tok = torch.from_numpy(first[:, -1:].copy()).cuda()
    pos = torch.full((), 41, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.model.decode_step(eng.params, caches, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [4, 1024], ids=["decode", "encoder"])
def test_whisper_bias_gelu_mmt4d_full_width(gen, dtype, tol, m):
    """whisper-small's MLP up-projection (d 768 -> d_ff 3072, bias, tanh
    GELU) at decode and over its encoder's 4 x 256 frames, through
    ``linear_apply`` (the weight packed on the call, the result kept
    packed, as the block runs it), against the plain version; counted as a
    bias + activation launch."""
    from repro_torch import kernels
    from repro_torch.core.linear import MatmulContext, linear_apply
    ctx = MatmulContext(hw=query("cuda"))
    x = _rand(gen, (m, 768), dtype)
    params = {"w": _rand(gen, (768, 3072), dtype) * 768 ** -0.5,
              "b": _rand(gen, (3072,), dtype) * 0.1}
    n0 = kernels.counters()["mmt4d.bias_activation"]
    got = linear_apply(params, x, ctx, activation="gelu", keep_packed=True)
    assert kernels.counters()["mmt4d.bias_activation"] == n0 + 1
    want = linear_apply({k: v.cpu() for k, v in params.items()}, x.cpu(),
                        MatmulContext(hw=query("cuda")), activation="gelu",
                        keep_packed=True)
    assert _close(got.unpack().cpu(), want.unpack(), tol)


# ------------------------------------- scaled descriptors, layout policies

_SCALED = ["h100_vl256", "h100_vl512"]
_CPU_TWIN = {"h100": "tpu_v5e", "h100_vl256": "tpu_vl256", "h100_vl512": "tpu_vl512"}


def test_query_names_on_the_card(gen):
    """``h100_vl256``/``h100_vl512`` are the card's own descriptor scaled 2
    and 4 times (lanes, mxu_k and the peaks; the memory system kept), with
    the tiles of the mirrored TPU presets; a ``tpu_*`` name is refused."""
    from repro_torch.core.hardware import presets
    base = query("cuda")
    for name, f in (("h100", 1), ("h100_vl256", 2), ("h100_vl512", 4)):
        hw = query("cuda", name)
        assert hw.name == name and hw.lanes == 128 * f and hw.mxu_k == 128 * f
        assert hw.flops_bf16 == f * base.flops_bf16 and hw.hbm_bw == base.hbm_bw
        for dt in (torch.float32, torch.bfloat16):
            for pol in ("scalable", "fixed", "unpacked"):
                lay = make_layout(pol, hw, dt)
                twin = make_layout(pol, presets[_CPU_TWIN[name]], dt)
                assert (lay.m_r, lay.n_r, lay.k_r) == (twin.m_r, twin.n_r, twin.k_r)
    with pytest.raises(ValueError):
        query("cuda", "tpu_vl512")


@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("unpacked", [False, True], ids=["packed", "unpacked"])
def test_mmt4d_f32_chunks_equal_whole_tile_staging(gen, monkeypatch, unpacked, act):
    """The float32 kernel stages 64 columns of k at a time; staging whole
    128-wide tiles (``F32_CHUNK = k_r``, the kernel before k was chunked)
    or chunks of 16 or 100 gives the same bits: each output's fmaf chain
    runs in one order."""
    from repro_torch.kernels.mmt4d import ops
    lay = make_layout("scalable", query("cuda"), torch.float32)
    m, k, n = 40, 5 * 128 + 40, 700
    ap = packing.pack_lhs(_rand(gen, (m, k), torch.float32), lay)
    bp = packing.pack_rhs(_rand(gen, (k, n), torch.float32) * k ** -0.5, lay)
    bias = Epilogue().bias_pack(_rand(gen, (n,), torch.float32), lay)
    to = (m, n) if unpacked else None
    got = mmt4d(ap, bp, bias, activation=act, unpack_to=to)
    for chunk in (lay.k_r, 16, 100):
        monkeypatch.setattr(ops, "F32_CHUNK", chunk)
        assert torch.equal(got, mmt4d(ap, bp, bias, activation=act,
                                      unpack_to=to)), chunk
    want = mmt4d_ref(ap, bp, bias, activation=act)
    want = unpack_ref(want, m, n) if unpacked else want
    assert _close(got, want, 1e-4)


@pytest.mark.parametrize("hw_name", _SCALED)
@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_kernels_at_scaled_tiles(gen, hw_name, dtype, tol):
    """Every kernel at the scaled tiles (n_r = k_r = 256, 512) against its
    plain version, at SmolLM2's widths: mmt4d (gate with silu, K/V, the
    unpacked store), pack (stream entry, W^T), unpack (final stream),
    dgrad and wgrad."""
    lay = make_layout("scalable", query("cuda", hw_name), dtype)
    assert lay.n_r == lay.k_r == {"h100_vl256": 256, "h100_vl512": 512}[hw_name]
    x = _rand(gen, (1, 16, 576), dtype)
    xp = pack(x, lay.m_r, lay.k_r)
    assert torch.equal(xp, pack_ref(x, lay.m_r, lay.k_r))
    assert torch.equal(unpack(xp, 16, 576), x)
    for k, n, act in ((576, 1536, "silu"), (576, 192, None), (1536, 576, None)):
        w = (_rand(gen, (k, n), dtype).float() * k ** -0.5).to(dtype)
        bp = packing.pack_rhs(w, lay)           # W^T, as prepack_params packs it
        assert torch.equal(bp, pack_ref(w.T, lay.n_r, lay.k_r))
        ap = packing.pack_lhs(_rand(gen, (1, 16, k), dtype), lay)
        want = mmt4d_ref(ap[0], bp, activation=act)[None]
        assert _close(mmt4d(ap, bp, activation=act), want, tol), (k, n)
        got = mmt4d(ap, bp, activation=act, unpack_to=(16, n))
        assert torch.equal(got, unpack(mmt4d(ap, bp, activation=act), 16, n))
    ap, bp, dy, z = _grad_case(gen, dtype, (), 256, 576, 1536, "silu", lay)
    assert _close(mmt4d_dgrad(dy, bp, z, activation="silu"),
                  mmt4d_dgrad_ref(dy, bp, z, activation="silu"), _GRAD_TOL[dtype])
    db, dbias = mmt4d_wgrad(dy, ap, z, activation="silu", bias=True)
    want_db, want_bias = mmt4d_wgrad_ref(dy, ap, z, activation="silu", bias=True)
    assert _close(db, want_db, _GRAD_TOL[dtype])
    assert _close(dbias, want_bias, _GRAD_TOL[dtype])


@pytest.mark.parametrize("policy,hw_name", [("scalable", "h100_vl256"),
                                            ("scalable", "h100_vl512"),
                                            ("fixed", "h100_vl512"),
                                            ("unpacked", "h100")])
def test_flat_drain_card_equals_cpu_under_each_layout(gen, policy, hw_name):
    """A float32 flat drain of SmolLM2's widths cut to 2 layers under each
    (policy, descriptor): the card's graph replays give the CPU's tokens
    (the CPU on the mirrored TPU preset, the same tiles); under
    ``unpacked`` no mmt4d, pack or unpack launches."""
    import dataclasses as dc

    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import presets
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = dc.replace(get_config("smollm2-135m"), n_layers=2)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    layout_policy=policy)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab, n), 6) for n in (5, 19, 33)]
    toks = {}
    for dev, hw in (("cuda", query("cuda", hw_name)),
                    ("cpu", presets[_CPU_TWIN[hw_name]])):
        model = build_model(cfg, run, ShapeSpec("serve", 64, 3, "decode"), hw=hw,
                            device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        eng = Engine(model, params, device=dev, max_slots=3, chunk_tokens=16)
        eng.warmup()
        kernels.reset_launch_counts()
        rids = [eng.add_request(p, n) for p, n in reqs]
        fin = {r.rid: r.out_tokens for r in eng.drain()}
        toks[dev] = [fin[r] for r in rids]
        if dev == "cuda":
            launches = kernels.launch_counts()
            assert eng.stats()["captures"] == eng.stats()["compiles"]
            assert launches["ragged_attn"] > 0
            moved = launches["mmt4d"] + launches["pack"] + launches["unpack"]
            assert (moved == 0) == (policy == "unpacked"), launches
    assert toks["cuda"] == toks["cpu"]


# ---------------------------------------------------------------------------
# the recurrent mixers: wkv6 and the RWKV-6 serving path
# ---------------------------------------------------------------------------

def _wkv6_inputs(gen, b, s, h, dh):
    r, k, v = (torch.randn((b, s, h, dh), generator=gen, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, dh), generator=gen,
                                         device="cuda") - 2))
    u = 0.1 * torch.randn((h, dh), generator=gen, device="cuda")
    s0 = 0.1 * torch.randn((b, h, dh, dh), generator=gen, device="cuda")
    return r, k, v, w, u, s0


def _wkv6_check(args):
    """y and the final state within 1e-5 of the plain version's largest
    |value| (float32 sums in another order); the state written into
    ``state_out`` when it is ``s0`` itself; one launch a call; repeats
    bit-identical."""
    from repro_torch import kernels
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    want = wkv6_ref(*args)
    kernels.reset_launch_counts()
    got = wkv6(*args)
    assert kernels.launch_counts()["wkv6"] == 1
    for g, x in zip(got, want):
        assert (g - x).abs().max().item() <= 1e-5 * x.abs().max().item()
    again = wkv6(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    s_in = args[5].clone()
    y, st = wkv6(*args[:5], s_in, state_out=s_in)
    assert st is s_in and torch.equal(s_in, got[1]) and torch.equal(y, got[0])


# the kernel's chunks are 16 tokens (csrc/wkv6.cu: kL): lengths at and
# around one and two chunks at each head width
@pytest.mark.parametrize("b,s,h,dh", [(4, 1, 32, 64), (1, 512, 32, 64),
                                      (3, 37, 4, 16), (2, 130, 2, 128),
                                      (1, 65, 8, 32), (2, 15, 3, 16),
                                      (1, 16, 2, 32), (2, 17, 2, 64),
                                      (1, 35, 2, 128), (2, 256, 32, 64)])
def test_wkv6_matches_plain(gen, b, s, h, dh):
    _wkv6_check(_wkv6_inputs(gen, b, s, h, dh))


@pytest.mark.parametrize("s", [1, 15, 16, 17, 35])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_wkv6_extreme_decays_match_plain(gen, dh, s):
    """``_wkv6_check`` with w = 1e-30 in channel 0 and 1 - 1e-7 in
    channel 1 of every head: products of decays that underflow to 0 (no
    overflow, no 0/0) and decays that barely decay."""
    args = _wkv6_inputs(gen, 2, s, 3, dh)
    args[3][..., 0], args[3][..., 1] = 1e-30, 1 - 1e-7
    _wkv6_check(args)


def _offset_copy(t):
    """``t`` copied into a contiguous view one element into its storage:
    4-byte aligned, not 16."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_wkv6_unaligned_operands_match_plain(gen):
    """r, k, v and w one float into their storage: the kernel stages them
    in 4-byte pieces instead of 16 (csrc/common.cuh: copy_granule)."""
    args = _wkv6_inputs(gen, 2, 37, 3, 64)
    _wkv6_check(tuple(_offset_copy(t) for t in args[:4]) + args[4:])


def test_wkv6_refuses_what_it_does_not_take(gen):
    """Refusals: another head width, bfloat16, and under autograd a
    ``state_out`` (the final state goes to a fresh tensor); a call with
    gradients runs through the backward kernel and gives every operand
    its gradient."""
    from repro_torch.kernels.wkv6.ops import wkv6
    r, k, v, w, u, s0 = _wkv6_inputs(gen, 2, 3, 2, 64)
    with pytest.raises(ValueError, match="fresh tensor"):
        wkv6(r.clone().requires_grad_(), k, v, w, u, s0, state_out=s0)
    ts = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, st = wkv6(*ts)
    grads = torch.autograd.grad(y.sum() + st.sum(), ts)
    assert all(g.shape == t.shape and torch.isfinite(g).all() and g.abs().sum() > 0
               for g, t in zip(grads, ts))
    with pytest.raises(ValueError, match="head width"):
        wkv6(*(t[..., :48].contiguous() for t in (r.detach(), k, v, w, u)),
             s0[..., :48, :48].contiguous())
    with pytest.raises(TypeError):
        wkv6(r.detach().to(torch.bfloat16), k, v, w, u, s0)


def _rwkv_model(dtype, device="cuda"):
    import dataclasses

    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=2, d_model=256,
                              d_ff=512, vocab=1024)
    name = str(dtype)[6:]
    return build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                       ShapeSpec("serve", 128, 3, "decode"), device=device)


@pytest.mark.parametrize("slots", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rwkv_second_drain_captures_nothing(gen, dtype, slots):
    """RWKV-6's heads (4 of 64) at 2 layers through the monolithic engine:
    warmup captures the decode step only; the first drain captures one
    prefill graph per prompt length; a second drain of the same requests
    captures nothing and repeats the tokens; the prefill graphs' state
    tree keeps its tensors throughout; a float32 drain gives the CPU's
    tokens, and a static batch on the same engine (its dense caches may
    share the paged caches' shapes) ``generate``'s tokens.  With one slot
    the prefill state is the slot's own."""
    from repro_torch.serving.engine import Engine
    model = _rwkv_model(dtype)
    params = model.init(gen)
    eng = Engine(model, params, device="cuda", max_slots=slots, page_tokens=16)
    eng.warmup()
    assert eng.stats()["captures"]["paged"] == 1
    ptrs = [t.data_ptr() for t in eng._prefill_states["p0"].values()]
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 1024, n), k) for n, k in ((7, 6), (30, 4), (7, 5), (19, 6))]

    def drain():
        rids = [eng.add_request(p, k) for p, k in reqs]
        fin = {r.rid: r.out_tokens for r in eng.drain()}
        return [fin[r] for r in rids]

    first = drain()
    assert eng.stats()["captures"]["paged"] == 1 + 3       # lengths 7, 30, 19
    second = drain()
    assert second == first and eng.stats()["captures"]["paged"] == 4
    assert [t.data_ptr() for t in eng._prefill_states["p0"].values()] == ptrs
    if dtype is torch.float32:
        cpu = Engine(_rwkv_model(dtype, "cpu"), params, device="cpu",
                     max_slots=slots, page_tokens=16)
        rids = [cpu.add_request(p, k) for p, k in reqs]
        fin = {r.rid: r.out_tokens for r in cpu.drain()}
        assert [fin[r] for r in rids] == first
        batch = {"tokens": rng.integers(0, 1024, (slots, 9)).astype(np.int32)}
        np.testing.assert_array_equal(eng.generate_static(batch, 5),
                                      eng.generate(batch, 5))


# ---------------------------------------------------------------------------
# mamba's selective scan and the jamba serving path
# ---------------------------------------------------------------------------

def _scan_inputs(gen, b, s, di, n, dtype, h0=True, dt_rank=12):
    """The scan's operands as mamba_apply hands them over: x and z halves
    of one in-projection output, B and C slices of one x-projection
    output (strided views), delta a softplus, a_log = log(1..N) plus
    noise, d_skip near 1, h0 ~ N(0, 1) or zero."""
    xz = torch.randn((b, s, 2 * di), generator=gen, device="cuda")
    xz[..., :di] = torch.nn.functional.silu(xz[..., :di])
    xz = xz.to(dtype)
    proj = torch.randn((b, s, dt_rank + 2 * n), generator=gen, device="cuda").to(dtype)
    delta = torch.nn.functional.softplus(
        torch.randn((b, s, di), generator=gen, device="cuda") - 2)
    a_log = (torch.log(torch.arange(1, n + 1, device="cuda", dtype=torch.float32))
             + 0.1 * torch.randn((di, n), generator=gen, device="cuda"))
    d_skip = 1 + 0.1 * torch.randn((di,), generator=gen, device="cuda")
    state = (torch.randn((b, di, n), generator=gen, device="cuda") if h0
             else torch.zeros((b, di, n), device="cuda"))
    views = (xz[..., :di], xz[..., di:], proj[..., dt_rank:dt_rank + n],
             proj[..., dt_rank + n:])
    return delta, views, a_log, d_skip, state


def _scan_close(got, want, dtype):
    """float32: within rtol 1e-5 / atol 1e-6 of the plain version, element
    by element (the state's recurrence rounds as the plain version does;
    the sum over N runs in another order); bfloat16 y: within 2e-2 of
    max(1, max |plain|) (a bfloat16 rounding of nearby float32 values)."""
    if dtype is torch.float32:
        return bool(((got - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())
    return _close(got, want, 2e-2)


# di 300 and 200 give x/z views 8- or 16-byte aligned, dt_rank 13 and an
# odd di views at an odd bfloat16 element: the kernel's copies narrow to
# what each view allows (csrc/common.cuh: copy_granule)
@pytest.mark.parametrize("b,s,di,n,h0,dt_rank",
                         [(4, 1, 8192, 16, True, 12), (1, 512, 256, 16, False, 12),
                          (2, 130, 300, 16, True, 12), (3, 37, 200, 8, True, 12),
                          (2, 1, 64, 8, False, 12), (6, 1, 8192, 16, True, 12),
                          (5, 70, 300, 8, True, 12), (5, 33, 200, 16, True, 12),
                          (2, 70, 301, 16, True, 13), (6, 33, 203, 8, False, 13)],
                         ids=["decode-rows", "prefill-zero", "prefill-cached",
                              "n8", "n8-decode-zero", "decode-rows-b6",
                              "n8-di300-b5", "n16-di200-b5", "n16-odd",
                              "n8-odd-b6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_matches_plain(gen, dtype, b, s, di, n, h0, dt_rank):
    """The kernel on strided views of xz and proj against its plain version
    on the same operands: y and the final state (written into ``state``
    in place) within the dtype's tolerance, the float32 state bit for bit
    (its products round as the plain version's); one launch a call; a
    repeat from the same h0 bit-identical."""
    from repro_torch import kernels
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    delta, views, a_log, d_skip, state = _scan_inputs(gen, b, s, di, n, dtype, h0,
                                                      dt_rank)
    h_init = state.clone()
    want_h = state.clone()
    want = selective_scan_ref(delta, *views, a_log, d_skip, want_h)
    kernels.reset_launch_counts()
    got = selective_scan(delta, *views, a_log, d_skip, state)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["selective_scan"] == 1
    assert got.dtype == dtype and got.shape == (b, s, di)
    assert _scan_close(got.float(), want.float(), dtype)
    assert _scan_close(state, want_h, torch.float32)
    if dtype is torch.float32:
        assert torch.equal(state, want_h)
    first_h = state.clone()
    state.copy_(h_init)
    again = selective_scan(delta, *views, a_log, d_skip, state)
    assert torch.equal(again, got) and torch.equal(state, first_h)


@pytest.mark.parametrize("s", [1, 40])
def test_selective_scan_unaligned_state_matches_plain(gen, s):
    """The state and a_log one float into their storage: the lanes read
    and write them as scalars, not 16-byte vectors; the float32 state
    still bit for bit."""
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    delta, views, a_log, d_skip, state = _scan_inputs(gen, 3, s, 200, 16,
                                                      torch.float32)
    want_h = state.clone()
    want = selective_scan_ref(delta, *views, a_log, d_skip, want_h)
    state, a_log = _offset_copy(state), _offset_copy(a_log)
    got = selective_scan(delta, *views, a_log, d_skip, state)
    assert _scan_close(got, want, torch.float32)
    assert torch.equal(state, want_h)


def test_selective_scan_refuses_what_it_does_not_take(gen):
    from repro_torch.kernels.selective_scan.ops import selective_scan
    delta, views, a_log, d_skip, state = _scan_inputs(gen, 2, 3, 64, 16,
                                                      torch.float32)
    # with gradients: through the backward kernel, the state only read
    h0 = state.clone()
    ts = [t.clone().requires_grad_() for t in (delta, *views, a_log, d_skip, state)]
    grads = torch.autograd.grad(selective_scan(*ts).sum(), ts)
    assert all(g.shape == t.shape and torch.isfinite(g).all() and g.abs().sum() > 0
               for g, t in zip(grads, ts))
    assert torch.equal(ts[-1].detach(), h0)
    with pytest.raises(ValueError, match="state width"):
        selective_scan(delta, views[0], views[1], views[2][..., :4],
                       views[3][..., :4], a_log[:, :4].contiguous(), d_skip,
                       state[..., :4].contiguous())
    with pytest.raises(TypeError):
        selective_scan(delta, views[0].to(torch.bfloat16), *views[1:], a_log,
                       d_skip, state)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(delta, *views, a_log, d_skip, state.transpose(1, 2))


def _jamba_model(dtype, device="cuda"):
    from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
    from repro_torch.models.model import build_model
    name = str(dtype)[6:]
    return build_model(reduced_config(get_config("jamba-v0.1-52b")),
                       RunConfig(param_dtype=name, compute_dtype=name),
                       ShapeSpec("serve", 128, 3, "decode"), device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_jamba_second_drain_captures_nothing(gen, dtype):
    """Reduced jamba-v0.1 (8 layers: seven mamba mixers through the scan
    kernel at N = 8, attention at index 4, 4 experts top-2 on every second
    layer) through the monolithic engine: one selective_scan launch per
    mamba layer and model call; a second drain captures nothing and
    repeats the first's tokens; in float32 the drain gives the CPU's
    tokens."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    model = _jamba_model(dtype)
    params = model.init(gen)
    eng = Engine(model, params, device="cuda", max_slots=3, page_tokens=16)
    eng.warmup()
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 512, n), k) for n, k in ((7, 6), (30, 4), (7, 5), (19, 6))]
    calls = []
    run = eng._run_paged
    eng._run_paged = lambda *a, **kw: calls.append(1) or run(*a, **kw)

    def drain(e):
        rids = [e.add_request(p, k) for p, k in reqs]
        fin = {r.rid: r.out_tokens for r in e.drain()}
        return [fin[r] for r in rids]

    kernels.reset_launch_counts()
    first = drain(eng)
    assert kernels.launch_counts()["selective_scan"] == 7 * len(calls)
    captures = eng.stats()["captures"]["paged"]
    assert drain(eng) == first and eng.stats()["captures"]["paged"] == captures
    if dtype is torch.float32:
        cpu = Engine(_jamba_model(dtype, "cpu"), params, device="cpu",
                     max_slots=3, page_tokens=16)
        assert drain(cpu) == first


# ---------------------------------------------------------------------------
# training the recurrent and moe families: the backward kernels of wkv6 and
# selective_scan, the expert-batched gradient kernels, the models' steps
# ---------------------------------------------------------------------------

def _leaf_close(got, want, rel):
    """Within ``rel`` of ``want``'s largest |entry|."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() <= rel * max(1e-30, want.abs().max().item())


def _wkv6_bwd_check(args, gen):
    """The backward kernel (from the forward kernel's checkpoints) against
    the plain backward (from its own): every gradient within 1e-5 of its
    largest entry (float32 sums in another order; the forward kernel's
    chunked states); one launch a call; a repeat bit for bit; the autograd
    Function's gradients equal the kernel's bit for bit."""
    from repro_torch import kernels
    from repro_torch.kernels.wkv6.ops import checkpoints, wkv6, wkv6_bwd
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref
    b, s, h, dh = args[0].shape
    dy = torch.randn((b, s, h, dh), generator=gen, device="cuda")
    ds = torch.randn((b, h, dh, dh), generator=gen, device="cuda")
    ckpt = checkpoints(args[0])
    wkv6(*args, ckpt=ckpt)
    want = wkv6_bwd_ref(*args, dy, ds)
    kernels.reset_launch_counts()
    got = wkv6_bwd(*args, dy, ds, ckpt)
    assert kernels.launch_counts()["wkv6_bwd"] == 1
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.shape == w.shape and _leaf_close(g, w, 1e-5), name
    again = wkv6_bwd(*args, dy, ds, ckpt)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    ts = [t.clone().requires_grad_() for t in args]
    y, st = wkv6(*ts)
    fn = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), ts)
    assert all(torch.equal(a, g) for a, g in zip(fn, got))


# chunk edges of the 16-token checkpoints at every head width, and RWKV-6's
# training shape cut in rows
@pytest.mark.parametrize("b,s,h,dh", [(2, 1, 3, 64), (2, 15, 3, 16), (1, 16, 2, 32),
                                      (2, 17, 2, 64), (1, 35, 2, 128), (3, 37, 4, 16),
                                      (1, 130, 2, 128), (2, 256, 4, 64),
                                      (1, 1024, 32, 64)])
def test_wkv6_bwd_matches_plain(gen, b, s, h, dh):
    _wkv6_bwd_check(_wkv6_inputs(gen, b, s, h, dh), gen)


@pytest.mark.parametrize("s", [1, 16, 17, 35])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_wkv6_bwd_extreme_decays_match_plain(gen, dh, s):
    """w = 1e-30 in channel 0 and 1 - 1e-7 in channel 1 of every head: the
    states are recomputed from checkpoints, never divided out."""
    args = _wkv6_inputs(gen, 2, s, 3, dh)
    args[3][..., 0], args[3][..., 1] = 1e-30, 1 - 1e-7
    _wkv6_bwd_check(args, gen)


# bf16: dx, dz, dB and dC rounded to bfloat16 from float32 sums in another
# order than the plain version's, which rounds the same sums
_SCAN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("b,s,di,n,h0,dt_rank",
                         [(2, 1, 256, 16, True, 12), (2, 37, 300, 16, True, 12),
                          (3, 33, 200, 8, False, 12), (2, 70, 301, 16, True, 13),
                          (1, 130, 8192, 16, False, 256), (2, 65, 203, 8, True, 13)],
                         ids=["one-step", "n16-h0", "n8-zero", "n16-odd",
                              "jamba-width", "n8-odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_bwd_matches_plain(gen, dtype, b, s, di, n, h0, dt_rank):
    """The backward kernel on the projections' strided views (odd widths:
    views at odd elements), from the forward kernel's checkpoints, against
    the plain backward: every gradient within the dtype's tolerance of its
    largest entry, in its operand's dtype; one launch a call; a repeat bit
    for bit; the autograd Function's gradients equal the kernel's bit for
    bit, and the state it started from unwritten."""
    from repro_torch import kernels
    from repro_torch.kernels.selective_scan.ops import (checkpoints, selective_scan,
                                                        selective_scan_bwd)
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref
    delta, views, a_log, d_skip, state = _scan_inputs(gen, b, s, di, n, dtype, h0,
                                                      dt_rank)
    dout = torch.randn((b, s, di), generator=gen, device="cuda").to(dtype)
    ckpt = checkpoints(delta, dtype, n)
    selective_scan(delta, *views, a_log, d_skip, state.clone(), ckpt=ckpt)
    ops = (delta, *views, a_log, d_skip, state)
    want = selective_scan_bwd_ref(*ops, dout)
    kernels.reset_launch_counts()
    got = selective_scan_bwd(*ops, dout, ckpt)
    assert kernels.launch_counts()["selective_scan_bwd"] == 1
    names = ("ddelta", "dx", "dz", "db", "dc", "da_log", "dd", "dh0")
    for name, g, w, o in zip(names, got, want, ops):
        assert g.dtype == o.dtype and g.shape == o.shape, name
        assert _leaf_close(g, w, _SCAN_BWD_TOL[dtype]), name
    again = selective_scan_bwd(*ops, dout, ckpt)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    ts = [t.clone().requires_grad_() for t in ops]
    fn = torch.autograd.grad((selective_scan(*ts).float() * dout.float()).sum(), ts)
    assert all(torch.equal(a, g) for a, g in zip(fn, got))
    assert torch.equal(ts[-1].detach(), state)


def _expert_grad_case(gen, dtype, e, c, k, n):
    """Packed A [E, C_o, K_o, m_r, k_r], B [E, N_o, K_o, n_r, k_r] and dZ
    [E, C_o, N_o, m_r, n_r] of an expert product [E, C, K] x [E, K, N]."""
    lay = make_layout("scalable", query("cuda"), dtype)
    ap = packing.pack_lhs(_rand(gen, (e, c, k), dtype), lay)
    bp = packing.pack_rhs((_rand(gen, (e, k, n), dtype).float() * k ** -0.5)
                          .to(dtype), lay)
    dz = packing.pack_out(_rand(gen, (e, c, n), dtype), lay)
    return ap, bp, dz


@pytest.mark.parametrize("e,c,k,n", [(16, 40, 256, 384), (16, 640, 512, 256),
                                     (128, 32, 256, 128), (128, 320, 384, 256),
                                     (4, 13, 128, 200)],
                         ids=["e16-c40", "e16-c640", "e128-c32", "e128-c320",
                              "e4-ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mmt4d_expert_grads_match_plain(gen, dtype, e, c, k, n):
    """mmt4d_dgrad and mmt4d_wgrad over every expert in one launch each,
    with and without silu's gradient, against their plain versions (within
    the 2-D kernels' tolerance of each result's largest entry); counted as
    expert-batched; repeats bit for bit; each expert equal bit for bit to
    the 2-D kernel on that expert alone, in float32 (C 40 and 13: an
    expert's reduction ends inside a 64-deep chunk, whose rows past it
    belong to the next expert)."""
    ap, bp, dz = _expert_grad_case(gen, dtype, e, c, k, n)
    z = mmt4d(ap, bp)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    for act, zz in ((None, None), ("silu", z)):
        before = (mmt4d_dgrad.expert_batched, mmt4d_wgrad.expert_batched)
        da = mmt4d_dgrad(dz, bp, zz, activation=act)
        db, _ = mmt4d_wgrad(dz, ap, zz, activation=act, experts=True)
        assert (mmt4d_dgrad.expert_batched, mmt4d_wgrad.expert_batched) == \
            (before[0] + 1, before[1] + 1)
        want_a = mmt4d_dgrad_ref(dz, bp, zz, activation=act)
        want_b, _ = mmt4d_wgrad_ref(dz, ap, zz, activation=act, experts=True)
        assert da.shape == ap.shape and db.shape == bp.shape
        assert _leaf_close(da, want_a, tol) and _leaf_close(db, want_b, tol), act
        assert torch.equal(mmt4d_dgrad(dz, bp, zz, activation=act), da)
        assert torch.equal(mmt4d_wgrad(dz, ap, zz, activation=act, experts=True)[0], db)
        if dtype == torch.float32:
            for x in sorted({0, e - 1}):
                zx = None if zz is None else zz[x]
                assert torch.equal(da[x], mmt4d_dgrad(dz[x], bp[x], zx, activation=act))
                assert torch.equal(db[x], mmt4d_wgrad(dz[x], ap[x], zx, activation=act)[0])


def _family_setup(arch, dtype, device, layers=None):
    from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
    from repro_torch.core.hardware import presets
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import make_optimizer
    cfg = reduced_config(get_config(arch), layers=layers)
    shape = ShapeSpec("t", 32, 2, "train")
    run = RunConfig(param_dtype=dtype, compute_dtype=dtype, remat=False,
                    warmup_steps=1)
    model = build_model(cfg, run, shape, hw=presets["tpu_v5e"], device=device)
    return model, make_optimizer(run, 10), run, SyntheticLM(cfg, shape, seed=0)


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2), ("jamba-v0.1-52b", 8),
                                         ("qwen3-moe-235b-a22b", 2),
                                         ("arctic-480b", 1)])
def test_family_value_and_grad_card_equals_cpu(gen, arch, layers):
    """Reduced configs in float32 (seq 32, batch 2), one state on the card
    and on the CPU: the loss within 1e-5 relative and every gradient leaf
    within 1e-5 of its largest entry (float32 sums in another order; the
    recurrences' backward kernels, the expert gradient kernels, the
    moe dispatch and combine), the moe metrics within 1e-6."""
    from repro_torch.training.optimizer import leaves, tree_map
    from repro_torch.training.step import value_and_grad
    model, _, _, data = _family_setup(arch, "float32", "cpu", layers)
    params = model.init(torch.Generator().manual_seed(0))
    batch = data.batch_at(0)
    res = {}
    for dev in ("cuda", "cpu"):
        m, _, _, _ = _family_setup(arch, "float32", dev, layers)
        p = tree_map(lambda t: t.to(dev), params)
        (loss, met), grads = value_and_grad(m, p, batch)
        res[dev] = (float(loss), {k: float(v) for k, v in met.items()},
                    [t.cpu() for t in leaves(grads)])
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for k in ("load_balance", "router_z", "dropped_frac"):
        if k in res["cpu"][1]:
            assert abs(res["cuda"][1][k] - res["cpu"][1][k]) <= 1e-6 * max(
                1.0, abs(res["cpu"][1][k])), k
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        assert _leaf_close(a, b, 1e-5)


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2), ("jamba-v0.1-52b", 8),
                                         ("qwen3-moe-235b-a22b", 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_family_compiled_train_step_replay_equals_eager(gen, arch, layers, dtype):
    """The compiled train step of each newly trainable family (reduced):
    three steps through the eager ``fn`` and through the compiled step
    (eager and captured on the first call, replayed after): the loss and
    every state leaf bit for bit, the same launches (the backward kernels
    among them), one capture."""
    from repro_torch import kernels
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.step import CompiledTrainStep
    from repro_torch.training.train_state import TrainState
    model, opt, run, data = _family_setup(arch, dtype, "cuda", layers)
    step = CompiledTrainStep(model, opt, run)
    init = model.init(torch.Generator(device="cuda").manual_seed(0))
    eager, graph = (TrainState.create(tree_map(torch.clone, init), opt) for _ in range(2))
    bwd = {"rwkv6-1.6b": "wkv6_bwd", "jamba-v0.1-52b": "selective_scan_bwd"}.get(
        arch, "mmt4d_wgrad")
    for i in range(3):
        batch = data.batch_at(i)
        kernels.reset_launch_counts()
        eager, em = step.fn(eager, {k: torch.as_tensor(v, device="cuda")
                                    for k, v in batch.items()})
        torch.cuda.synchronize()
        want = kernels.counters()
        kernels.reset_launch_counts()
        graph, gm = step(graph, batch)
        torch.cuda.synchronize()
        assert kernels.counters() == want and want[bwd] > 0
        if model.cfg.moe:
            assert want["mmt4d_wgrad.expert_batched"] > 0
        assert torch.equal(em["loss"], gm["loss"])
        assert all(torch.equal(a, b) for a, b in zip(_state_leaves(eager),
                                                     _state_leaves(graph)))
    assert step.captures == 1


# ---------------------------------------------------------------------------
# the kernels as torch.library ops, and the traced step
# ---------------------------------------------------------------------------

from _torch_op_samples import op_samples  # noqa: E402

_OP_CASES = [(name, case) for name, case, _ in op_samples("cpu")]


@pytest.mark.parametrize("name,case", _OP_CASES, ids=[f"{n}-{c}" for n, c in _OP_CASES])
def test_opcheck_cuda_impl_launches_the_kernel(gen, name, case):
    """Each op's CUDA impl passes opcheck (schema with its mutated
    arguments, fake impl against the kernel's outputs, autograd
    registration, AOT dispatch), and one call through
    ``torch.ops.repro_torch`` is one launch of its kernel, no other, and
    agrees with the CPU impl on the same inputs."""
    from repro_torch import kernels
    args = dict(((n, c), a) for n, c, a in op_samples("cuda"))[(name, case)]
    op = getattr(torch.ops.repro_torch, name).default
    torch.library.opcheck(op, args)
    fresh = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in fresh]
    if name.startswith("ragged_attn"):
        host[6] = None                   # the plan: the plain version's none
    before = kernels.launch_counts()
    got = op(*fresh)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {name: 1}
    want = op(*host)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cuda" and g.shape == w.shape
        if name.startswith("ragged_attn"):   # padding: zeros (lse: -inf) on the card
            real = host[4] >= 0
            pad = g[real.cuda().logical_not()]
            assert (pad == 0).all() or (pad == -torch.inf).all()
            g, w = g[real.cuda()], w[real]
            finite = torch.isfinite(w)       # a row without a held key: -inf
            assert torch.equal(torch.isfinite(g).cpu(), finite)
            g, w = g[finite.cuda()], w[finite]
        if g.numel():
            err = (g.cpu().float() - w.float()).abs().max().item()
            assert err <= 1e-3 * max(1.0, w.float().abs().max().item()), (name, err)


@pytest.mark.parametrize("case", sorted(_GRAPH_CASES))
def test_traced_op_counts_equal_eager_launches(gen, case):
    """A step traced with fake tensors on the card holds one repro_torch
    node per kernel launch of the same eager step, and launches nothing."""
    from repro_torch import kernels
    from repro_torch.analysis.graph_tools import trace_step
    from repro_torch.kernels.ragged_attn.ops import RaggedPlan
    from repro_torch.roofline.graph_cost import graph_cost
    family, rows, width = _GRAPH_CASES[case]
    eng = _small_engine(family, torch.bfloat16)
    host, plan, _ = _step_inputs(eng, rows, width)
    step = eng._flat_step if eng.flat else eng._paged_step
    args = [None if a is None else torch.from_numpy(a).cuda() for a in host]
    fn, extra = step.fn, ()
    if plan is not None:
        cplan = plan.to("cuda")
        extra = (cplan.items,)
        fn = lambda *a: step.fn(*a[:-1], plan=RaggedPlan(a[-1], cplan.splits))  # noqa: E731
    c0 = kernels.launch_counts()
    fn(eng.params, eng.caches, *args, *extra)
    torch.cuda.synchronize()
    c1 = kernels.launch_counts()
    launched = {k: c1[k] - c0[k] for k in c0 if c1[k] != c0[k]}
    gm = trace_step(fn, (eng.params, eng.caches, *args, *extra))
    assert graph_cost(gm).kernel_counts() == launched
    assert kernels.launch_counts() == c1
    assert launched["mmt4d"] == 2 * 7 + 1


def test_capture_holds_while_another_thread_collects(gen):
    """A capture survives a ``gc.collect()`` made by another thread while it
    runs (chip_smoke's CPU lanes collect after each run): an engine dropped
    in a reference cycle mid-capture keeps its graphs until the capture has
    ended, instead of destroying them inside it, which invalidates the
    capture (ROADMAP C16)."""
    import gc
    import threading
    import time as _time

    donor = _small_engine("flat", torch.bfloat16)
    donor.warmup()
    held = [donor]
    del donor
    victim = _small_engine("flat", torch.bfloat16)
    real = victim.model.flat_decode_step

    def step(*args, **kw):
        if held and torch.cuda.is_current_stream_capturing():
            eng = held.pop()
            eng.cycle = eng              # garbage only a collection frees
            del eng
            _time.sleep(0.5)             # the other thread collects meanwhile
        return real(*args, **kw)

    victim.model.flat_decode_step = step
    stop = threading.Event()
    collector = threading.Thread(target=lambda: [gc.collect() for _ in iter(
        stop.is_set, True)], daemon=True)
    collector.start()
    try:
        victim.warmup()
        torch.cuda.synchronize()
    finally:
        stop.set()
        collector.join(timeout=60)
    assert not collector.is_alive() and not held
    assert victim.stats()["captures"]["flat"] == len(victim._flat_shapes())
    gc.collect()
