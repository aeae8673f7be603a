"""Port pack/unpack vs the JAX package: ``repro.core.packing`` and the
Pallas pack/unpack kernels in interpret mode, bit-exact, in float32 and
bfloat16 (compared as float32).  On the CPU the port's wrappers run their
plain versions; the CUDA kernels are held to those on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_layout, packing as jpacking, presets
from repro.kernels.pack.ops import pack as jpack_op
from repro.kernels.unpack.ops import unpack as junpack_op
from repro_torch.core import packing
from repro_torch.core.hardware import presets as tpresets
from repro_torch.core.layout import make_layout as tmake_layout
from repro_torch.kernels.pack.ops import pack
from repro_torch.kernels.unpack.ops import unpack

torch.set_num_threads(1)

# the pack and unpack shapes of tests/test_kernels.py:54 and :65
MK = [(64, 256), (37, 200), (8, 128), (130, 520), (1, 1), (1000, 3)]
MK_UNPACK = [(64, 256), (37, 200), (130, 520), (1, 1)]
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _pair(shape, tdt, jdt, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("mk", MK, ids=[str(s) for s in MK])
def test_pack_lhs_rhs_bit_exact(mk, name, tdt, jdt):
    ta, ja = _pair(mk, tdt, jdt)
    lay = make_layout("scalable", presets["tpu_v5e"], jdt)
    tlay = tmake_layout("scalable", tpresets["tpu_v5e"], tdt)
    assert (tlay.m_r, tlay.n_r, tlay.k_r) == (lay.m_r, lay.n_r, lay.k_r)
    got = packing.pack_lhs(ta, tlay)
    np.testing.assert_array_equal(_f32(got), _f32(jpacking.pack_lhs(ja, lay)))
    np.testing.assert_array_equal(_f32(got), _f32(jpack_op(ja, lay.m_r, lay.k_r,
                                                           interpret=True)))
    # RHS: B = A read as [K, N], packed from its transposed view
    np.testing.assert_array_equal(_f32(packing.pack_rhs(ta, tlay)),
                                  _f32(jpacking.pack_rhs(ja, lay)))


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("mk", MK_UNPACK, ids=[str(s) for s in MK_UNPACK])
def test_unpack_bit_exact(mk, name, tdt, jdt):
    m, k = mk
    lay = make_layout("scalable", presets["tpu_v5e"], jdt)
    tlay = tmake_layout("scalable", tpresets["tpu_v5e"], tdt)
    ta, ja = _pair(mk, tdt, jdt, seed=1)
    jp = jpacking.pack_lhs(ja, lay)
    tp = packing.pack_lhs(ta, tlay)
    got = packing.unpack_lhs(tp, m, k)
    np.testing.assert_array_equal(_f32(got), _f32(jpacking.unpack_lhs(jp, m, k)))
    np.testing.assert_array_equal(_f32(got), _f32(junpack_op(jp, m, k,
                                                             interpret=True)))
    np.testing.assert_array_equal(_f32(got), _f32(ta))


def test_pack_leading_dims_and_strided_input():
    """Leading dims survive pack/unpack, and a transposed view packs like
    its contiguous copy (the wrapper reads through strides)."""
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 37, 200)).astype(np.float32))
    p = pack(a, 8, 128)
    assert p.shape == (2, 3, 5, 2, 8, 128)
    assert torch.equal(unpack(p, 37, 200), a)
    t = a[0, 0].T
    assert torch.equal(pack(t, 8, 128), pack(t.contiguous(), 8, 128))
    assert torch.equal(packing.pad_to_tiles(a, 8, 128)[..., :37, :200], a)
