"""Port ragged paged attention (plain version on the CPU) vs the JAX
package's Pallas kernel in interpret mode and its jnp oracle, on mixed
decode, mid-prefill, fresh-prefill and padding segments; compared on the
valid positions only (padding rows carry garbage by contract).  float32
atol/rtol 1e-5: the same softmax, summed in another order (the Pallas
kernel's online softmax rescales per page)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ragged_attn.kernel import ragged_attention_kernel_call
from repro.kernels.ragged_attn.ref import (flat_write_destinations as
                                           jflat_write_destinations)
from repro.kernels.ragged_attn.ref import ragged_attention_ref as jref
from repro_torch.kernels.ragged_attn.ops import ragged_attention
from repro_torch.kernels.ragged_attn.ref import flat_write_destinations

torch.set_num_threads(1)


def _case(hq=6, hkv=2, dh=16, t=8, pages=14, mp=4, w=24, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((w, hq, dh)).astype(np.float32)
    kp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    bt = (rng.permutation(pages - 1)[:3 * mp] + 1).astype(np.int32).reshape(3, mp)
    row_ids = np.full(w, -1, np.int32)
    q_pos = np.zeros(w, np.int32)
    # row 0: one decode token at 27 (its last page); row 1: a 6-token chunk
    # at 8..13; row 2: a fresh 5-token prefill; the rest padding
    row_ids[0], q_pos[0] = 0, 27
    row_ids[1:7], q_pos[1:7] = 1, np.arange(8, 14)
    row_ids[7:12], q_pos[7:12] = 2, np.arange(5)
    return q, kp, vp, bt, row_ids, q_pos


@pytest.mark.parametrize("shape", [dict(), dict(hq=9, hkv=3, dh=64, t=16, mp=2, pages=8)],
                         ids=["g3-dh16", "smollm2-heads"])
def test_ragged_matches_pallas_and_ref(shape):
    q, kp, vp, bt, row_ids, q_pos = _case(**shape)
    valid = row_ids >= 0
    jargs = dict(block_tables=jnp.asarray(bt), row_ids=jnp.asarray(row_ids),
                 q_pos=jnp.asarray(q_pos))
    want_kernel = np.asarray(ragged_attention_kernel_call(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), interpret=True,
        **jargs))
    want_ref = np.asarray(jref(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), **jargs))
    got = ragged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        block_tables=torch.from_numpy(bt), row_ids=torch.from_numpy(row_ids),
        q_pos=torch.from_numpy(q_pos)).numpy()
    np.testing.assert_allclose(got[valid], want_kernel[valid], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[valid], want_ref[valid], atol=1e-5,
                               rtol=1e-5)


def test_ragged_bf16_matches_ref():
    """bfloat16 inputs: float32 scores and softmax on both sides, one
    rounding of the output (atol 2e-2)."""
    q, kp, vp, bt, row_ids, q_pos = _case(seed=1)
    valid = row_ids >= 0
    want = np.asarray(jref(jnp.asarray(q).astype(jnp.bfloat16),
                           jnp.asarray(kp).astype(jnp.bfloat16),
                           jnp.asarray(vp).astype(jnp.bfloat16),
                           block_tables=jnp.asarray(bt),
                           row_ids=jnp.asarray(row_ids),
                           q_pos=jnp.asarray(q_pos)), np.float32)
    bf = torch.bfloat16
    got = ragged_attention(
        torch.from_numpy(q).to(bf), torch.from_numpy(kp).to(bf),
        torch.from_numpy(vp).to(bf), block_tables=torch.from_numpy(bt),
        row_ids=torch.from_numpy(row_ids),
        q_pos=torch.from_numpy(q_pos)).float().numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-2, rtol=2e-2)


def test_flat_write_destinations_equal():
    _, _, _, bt, row_ids, q_pos = _case()
    q_pos = q_pos.copy()
    q_pos[0] = 40                       # past the table: clamps to MP - 1
    for t in (4, 8):
        got = flat_write_destinations(bt, row_ids, q_pos, t)
        want = jflat_write_destinations(bt, row_ids, q_pos, t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
