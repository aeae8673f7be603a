"""The port's CUDA kernels against their plain versions on the card, at
small shapes (chip_smoke.py repeats this at the full SmolLM2 widths).
A CUDA kernel has no interpret mode, so without a card these tests skip.
Run them on the card with (``--noconftest``: tests/conftest.py imports JAX,
which a machine with only the port need not have):
    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.hardware import query
from repro_torch.core.layout import make_layout
from repro_torch.kernels.mmt4d.ops import mmt4d
from repro_torch.kernels.mmt4d.ref import mmt4d_ref
from repro_torch.kernels.pack.ops import pack
from repro_torch.kernels.pack.ref import pack_ref
from repro_torch.kernels.ragged_attn.ops import ragged_attention
from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref
from repro_torch.kernels.unpack.ops import unpack
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


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_pack_unpack_kernels_exact(gen, dtype, tol):
    a = _rand(gen, (2, 37, 200), dtype)
    assert torch.equal(pack(a, 8, 128), pack_ref(a, 8, 128))
    t = a[0].T                                         # strided input
    assert torch.equal(pack(t, 16, 128), pack_ref(t, 16, 128))
    p = pack(a, 16, 128)
    assert torch.equal(unpack(p, 37, 200), unpack_ref(p, 37, 200))
    assert torch.equal(unpack(p, 37, 200), a)


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


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ragged_kernel_matches_plain(gen, dtype, tol):
    hq, hkv, dh, t, pages, mp, w = 9, 3, 64, 16, 20, 4, 32
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(pages - 1)[:3 * mp] + 1)
                          .astype(np.int32).reshape(3, mp)).cuda()
    row_ids = np.full(w, -1, np.int32)
    q_pos = np.zeros(w, np.int32)
    row_ids[0], q_pos[0] = 0, 60
    row_ids[1:9], q_pos[1:9] = 1, np.arange(17, 25)
    row_ids[9:14], q_pos[9:14] = 2, np.arange(5)
    args = dict(block_tables=bt, row_ids=torch.from_numpy(row_ids).cuda(),
                q_pos=torch.from_numpy(q_pos).cuda())
    q = _rand(gen, (w, hq, dh), dtype)
    kp = _rand(gen, (pages, t, hkv, dh), dtype)
    vp = _rand(gen, (pages, t, hkv, dh), dtype)
    valid = torch.from_numpy(row_ids >= 0).cuda()
    got = ragged_attention(q, kp, vp, **args)[valid].float()
    want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
    assert (got - want).abs().max().item() <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    a = _rand(gen, (16, 128), torch.float16)
    with pytest.raises(TypeError):
        pack(a, 8, 128)
    with pytest.raises(ValueError):
        unpack(pack(_rand(gen, (16, 256), torch.float32), 8, 128)
               .transpose(1, 2), 16, 256)
