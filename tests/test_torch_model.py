"""The port's model vs the JAX package on reduced SmolLM2 (2 layers,
float32): one flat step and one paged step (decode rows, a monolithic
prefill bucket, a mixed chunk step) on identical pools and block tables,
with the reference's parameters carried across by ``from_jax_params``.
Logits agree within 1e-5 on valid rows (an inert row attends over
nothing and carries garbage in both packages); the pools agree everywhere
except the trash page 0 (padding writes land there in an unspecified
order), and the paged scatter alone writes them bit for bit.  Also the
shared components the steps run: packed RMSNorm and neox RoPE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import presets
from repro.core.linear import MatmulContext as JCtx
from repro.core.linear import prepack_params as jprepack
from repro.core.propagation import pack_activation as jpack_activation
from repro.models.attention import core_attention as jcore_attention
from repro.models.attention import paged_kv_update as jpaged_kv_update
from repro.models.common import apply_rope as japply_rope
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import presets as tpresets
from repro_torch.core.linear import MatmulContext, prepack_params
from repro_torch.core.propagation import pack_activation
from repro_torch.models.attention import core_attention, paged_kv_update
from repro_torch.models.common import apply_rope
from repro_torch.models.model import build_model
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                               for f in cfg.__dataclass_fields__})
    jm = jbuild_model(jcfg, JRun(**F32), JShape("serve", 64, 3, "decode"))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec("serve", 64, 3, "decode"),
                    device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    return jm, jparams, m, params


def _step_inputs(pages=14, t=8, mp=8, w=16):
    rng = np.random.default_rng(0)
    bt = (rng.permutation(pages - 1)[:3 * mp // 2] + 1).astype(np.int32)
    bt = np.concatenate([bt, np.zeros(3 * mp - bt.size, np.int32)]).reshape(3, mp)
    token = rng.integers(0, 512, (1, w)).astype(np.int32)
    row_ids = np.full(w, -1, np.int32)
    q_pos = np.zeros(w, np.int32)
    row_ids[0], q_pos[0] = 0, 17            # a decode token
    row_ids[1:6], q_pos[1:6] = 1, np.arange(8, 13)   # a mid-prefill chunk
    row_ids[6:10], q_pos[6:10] = 2, np.arange(4)     # a fresh prefill
    idx = np.array([0, 5, 9], np.int32)
    return bt, token, row_ids, q_pos, idx


@pytest.mark.parametrize("prepack", [False, True])
def test_flat_decode_step_matches_jax(models, prepack):
    jm, jparams, m, params = models
    pages, t = 14, 8
    bt, token, row_ids, q_pos, idx = _step_inputs(pages, t)
    jcaches = jm.init_paged_cache(pages, t, 3)
    rng = np.random.default_rng(1)
    fill = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jcaches)
    caches = from_jax_params(fill)
    if prepack:
        jparams = jprepack(jparams, jm.ctx)
        params = prepack_params(params, m.ctx)
    jlogits, jnew = jm.flat_decode_step(
        jparams, jax.tree.map(jnp.asarray, fill), jnp.asarray(token),
        jnp.asarray(bt), jnp.asarray(row_ids), jnp.asarray(q_pos),
        jnp.asarray(idx))
    logits, new = m.flat_decode_step(
        params, caches, torch.from_numpy(token), torch.from_numpy(bt),
        torch.from_numpy(row_ids), torch.from_numpy(q_pos),
        torch.from_numpy(idx))
    assert new is caches                      # pools are updated in place
    assert tuple(logits.shape) == jlogits.shape == (1, 3, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for kind in ("k_pages", "v_pages"):
        want = np.asarray(jnew["p0"]["kv"][kind])[:, 1:]
        got = new["p0"]["kv"][kind].numpy()[:, 1:]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # the scatter wrote exactly the valid positions' pages
        assert not np.array_equal(got, fill["p0"]["kv"][kind][:, 1:])


# (token width, [(lens, new_counts)] per row): decode rows, a monolithic
# prefill at its bucket, and a dense chunked step mixing a decode row, a
# mid-prompt chunk and an inert row
PAGED_CASES = {
    "decode": (1, [(17, 1), (5, 1), (30, 1)]),
    "prefill bucket": (16, [(0, 13)]),
    "mixed chunk": (8, [(20, 1), (8, 8), (0, 0)]),
}


def _fill(jcaches, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jcaches)


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_decode_step_matches_jax(models, case):
    jm, jparams, m, params = models
    pages, t, mp = 14, 8, 8
    s, rows = PAGED_CASES[case]
    rng = np.random.default_rng(2)
    b = len(rows)
    lens = np.array([l for l, _ in rows], np.int32)
    counts = np.array([n for _, n in rows], np.int32)
    bt = np.zeros((b, mp), np.int32)
    free = list(rng.permutation(pages - 1) + 1)
    for r, (l, n) in enumerate(rows):
        need = -(-(l + n) // t)
        bt[r, :need] = [free.pop() for _ in range(need)]
    token = rng.integers(0, 512, (b, s)).astype(np.int32)
    fill = _fill(jm.init_paged_cache(pages, t, b), 3)
    caches = from_jax_params(fill)
    jlogits, jnew = jm.paged_decode_step(
        jprepack(jparams, jm.ctx), jax.tree.map(jnp.asarray, fill),
        *(jnp.asarray(x) for x in (token, bt, lens, counts)))
    logits, new = m.paged_decode_step(
        prepack_params(params, m.ctx), caches,
        *(torch.from_numpy(x) for x in (token, bt, lens, counts)))
    assert new is caches                      # pools are updated in place
    assert tuple(logits.shape) == jlogits.shape == (b, 1, 512)
    valid = counts > 0
    np.testing.assert_allclose(logits.numpy()[valid],
                               np.asarray(jlogits)[valid], rtol=1e-5, atol=1e-5)
    for kind in ("k_pages", "v_pages"):
        np.testing.assert_allclose(new["p0"]["kv"][kind].numpy()[:, 1:],
                                   np.asarray(jnew["p0"]["kv"][kind])[:, 1:],
                                   rtol=1e-5, atol=1e-5)


def test_paged_kv_update_matches_jax_bit_for_bit():
    """The scatter writes every valid position where the reference does,
    bit for bit (invalid ones go to the trash page 0 in an unspecified
    order); the gathered streams and the length mask are the reference's."""
    rng = np.random.default_rng(8)
    pages, t, mp, hkv, dh = 12, 8, 4, 2, 16
    kp, vp = rng.standard_normal((2, pages, t, hkv, dh)).astype(np.float32)
    k, v = rng.standard_normal((2, 3, 16, hkv, dh)).astype(np.float32)
    lens = np.array([9, 0, 30], np.int32)
    counts = np.array([16, 0, 1], np.int32)
    bt = np.array([[3, 4, 5, 0], [0, 0, 0, 0], [6, 7, 8, 9]], np.int32)
    args = dict(lens=lens, new_counts=counts, block_tables=bt)
    jc, jk, jv, jmask = jpaged_kv_update(
        {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},
        jnp.asarray(k), jnp.asarray(v),
        **{a: jnp.asarray(x) for a, x in args.items()})
    cache = {"k_pages": torch.from_numpy(kp.copy()),
             "v_pages": torch.from_numpy(vp.copy())}
    c, tk, tv, tmask = paged_kv_update(
        cache, torch.from_numpy(k), torch.from_numpy(v),
        **{a: torch.from_numpy(x) for a, x in args.items()})
    assert c is cache
    for kind in ("k_pages", "v_pages"):
        got, want = c[kind].numpy(), np.asarray(jc[kind])
        assert np.array_equal(got[1:], want[1:])
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    live = np.asarray(jmask)
    assert np.array_equal(tk.numpy()[live], np.asarray(jk)[live])
    assert np.array_equal(tv.numpy()[live], np.asarray(jv)[live])


def test_packed_rms_norm_matches_jax():
    x = np.random.default_rng(2).standard_normal((1, 13, 200)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    jx = jpack_activation(jnp.asarray(x), JCtx(hw=presets["tpu_v5e"]).layout(jnp.float32))
    tx = pack_activation(torch.from_numpy(x),
                         MatmulContext(hw=tpresets["tpu_v5e"]).layout(torch.float32))
    want = np.asarray(jx.rms_norm(jnp.asarray(g)).unpack())
    got = tx.rms_norm(torch.from_numpy(g)).unpack().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_packed_layer_norm_matches_jax():
    """LayerNorm in the packed domain: the centred value is re-masked, so
    the feature padding stays zero and the result equals the reference."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 200)).astype(np.float32)
    g, b = rng.standard_normal((2, 200)).astype(np.float32)
    jx = jpack_activation(jnp.asarray(x), JCtx(hw=presets["tpu_v5e"]).layout(jnp.float32))
    tx = pack_activation(torch.from_numpy(x),
                         MatmulContext(hw=tpresets["tpu_v5e"]).layout(torch.float32))
    want = jx.layer_norm(jnp.asarray(g), jnp.asarray(b))
    got = tx.layer_norm(torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=1e-5, atol=1e-5)
    assert not got.data[..., -1, :, 200 - 128:].any()     # padding stays zero


@pytest.mark.parametrize("q_pos_rows", [False, True], ids=["shared", "per-row"])
def test_core_attention_matches_jax(q_pos_rows):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 9, 2, 16)).astype(np.float32)
    q_pos = np.arange(4, 9, dtype=np.int32)
    if q_pos_rows:
        q_pos = np.stack([q_pos, q_pos - 3])
    mask = np.arange(9)[None, :] < np.array([[9], [7]])
    want = jcore_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, q_pos=jnp.asarray(q_pos),
                           kv_len_mask=jnp.asarray(mask))
    got = core_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True,
                         q_pos=torch.from_numpy(q_pos),
                         kv_len_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 12, 9, 64)).astype(np.float32)
    k = rng.standard_normal((1, 12, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 1000, (1, 12)).astype(np.int32)
    jq, jk = japply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
