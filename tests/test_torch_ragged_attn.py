"""Port ragged paged attention (plain version on the CPU) vs the JAX
package's Pallas kernel in interpret mode and its jnp oracle, on mixed
decode, mid-prefill, fresh-prefill and padding segments; compared on the
valid positions only (padding rows carry garbage by contract).  float32
atol/rtol 1e-5: the same softmax, summed in another order (the Pallas
kernel's online softmax rescales per page).

The card kernel's plan (``plan_ragged``) over the layouts the port's
scheduler lays out at every flat width; the fixed-size plan a served step
uses (``slots=``: one size per width, so a CUDA graph replays it) over
those layouts and over any layout of up to ``slots`` row segments (a
property test); and the plan's arithmetic
(``ragged_attention_planned``: per-block partials over page ranges, merged
in split order) against the JAX package's oracle to 1e-6 in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ragged_attn.kernel import ragged_attention_kernel_call
from repro.kernels.ragged_attn.ref import (flat_write_destinations as
                                           jflat_write_destinations)
from repro.kernels.ragged_attn.ref import ragged_attention_ref as jref
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.kernels.ragged_attn.ops import (MAX_CLUSTER, TILE, max_tiles,
                                                 pick_splits, plan_ragged,
                                                 ragged_attention)
from repro_torch.kernels.ragged_attn.ref import (flat_write_destinations,
                                                 ragged_attention_planned)
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

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


# --------------------------------------------------------------- the plan

WIDTHS = [16, 32, 64, 128, 256, 512]
SMOLLM2 = dict(hkv=3, group=3)      # 9 query heads over 3 KV heads
SM_COUNT = 132                      # H100 SXM


@pytest.fixture(scope="module")
def scheduler_layouts():
    """(row_ids, q_pos, max_pages) of every flat step of a few seeded
    drains through the port's engine (scheduler and step layout as served:
    4 slots, chunk_tokens 128, pages of 16, seq_len 1024), by width.  The
    model step is replaced by zero logits: only the layouts matter here."""
    cfg = reduced_config(get_config("smollm2-135m"), layers=1)
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    by_width = {}
    for seed in range(4):
        eng = Engine(model, params, device="cpu", max_slots=4, chunk_tokens=128,
                     page_tokens=16)

        def fake_run(token, bt, row_ids, q_pos, idx, eng=eng):
            by_width.setdefault(token.shape[1], []).append(
                (row_ids.copy(), q_pos.copy(), eng.max_pages))
            return np.zeros((eng.slots, cfg.vocab), np.float32)

        eng._run_flat = fake_run
        rng = np.random.default_rng(seed)
        for n in rng.integers(1, 700, 10):
            eng.add_request(rng.integers(0, cfg.vocab, int(n)),
                            int(rng.integers(1, 60)))
        eng.drain()
    return by_width


def _check_plan(plan, row_ids, q_pos, max_pages, t=TILE):
    items, s = plan.items, plan.splits
    assert 1 <= s <= MAX_CLUSTER
    assert items.dtype == np.int32 and items.shape == (plan.tiles * s, 6)
    cover = np.zeros(row_ids.shape[0], int)
    for first in range(0, items.shape[0], s):
        block = items[first:first + s]
        start, n, row, q0 = block[0, :4]
        assert (block[:, :4] == block[0, :4]).all()     # one tile per cluster
        assert 1 <= n <= TILE
        cover[start:start + n] += 1
        assert (row_ids[start:start + n] == row).all()
        if row < 0:
            assert (block[:, 4] == block[:, 5]).all()   # padding: no pages
            continue
        assert (q_pos[start:start + n] == q0 + np.arange(n)).all()
        last = min((q0 + n - 1) // t, max_pages - 1)
        lo, hi = block[:, 4], block[:, 5]
        live = hi > lo
        k = int(live.sum())
        assert 1 <= k <= MAX_CLUSTER and live[:k].all() and not live[k:].any()
        # the live ranges partition [0, last], in order
        assert lo[0] == 0 and hi[k - 1] == last + 1
        assert (lo[1:k] == hi[:k - 1]).all()
    assert (cover == 1).all()                           # each position once


@pytest.mark.parametrize("width", WIDTHS)
def test_plan_over_scheduler_layouts(scheduler_layouts, width):
    """Every layout the scheduler produced at this width, with the picked
    split count and with every count up to the cluster limit."""
    layouts = scheduler_layouts.get(width, [])
    assert layouts, f"no drain step ran at width {width}"
    for row_ids, q_pos, mp in layouts:
        _check_plan(plan_ragged(row_ids, q_pos, TILE, mp, sm_count=SM_COUNT,
                                **SMOLLM2), row_ids, q_pos, mp)
        for s in range(1, MAX_CLUSTER + 1):
            _check_plan(plan_ragged(row_ids, q_pos, TILE, mp, sm_count=SM_COUNT,
                                    splits=s, **SMOLLM2), row_ids, q_pos, mp)


def _check_fixed_plan(row_ids, q_pos, mp, slots):
    """The fixed-size plan is the per-step plan at the width's split
    count, then empty tiles (no positions, padding row, no pages) up to
    the width's most tiles; its size and split count depend on the width
    alone."""
    w = row_ids.shape[0]
    fixed = plan_ragged(row_ids, q_pos, TILE, mp, sm_count=SM_COUNT,
                        slots=slots, **SMOLLM2)
    n_tiles = max_tiles(w, slots, TILE)
    assert fixed.splits == pick_splits(n_tiles, mp, SMOLLM2["hkv"], SM_COUNT)
    assert fixed.items.shape == (n_tiles * fixed.splits, 6)
    live = plan_ragged(row_ids, q_pos, TILE, mp, sm_count=SM_COUNT,
                       splits=fixed.splits, **SMOLLM2)
    _check_plan(live, row_ids, q_pos, mp)
    k = live.items.shape[0]
    assert np.array_equal(fixed.items[:k], live.items)
    assert (fixed.items[k:] == [0, 0, -1, 0, 0, 0]).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_fixed_plan_over_scheduler_layouts(scheduler_layouts, width):
    for row_ids, q_pos, mp in scheduler_layouts[width]:
        _check_fixed_plan(row_ids, q_pos, mp, slots=4)


@st.composite
def _row_layouts(draw):
    """A flat stream of up to ``slots`` row segments (consecutive q_pos
    each, in any row order) then padding: what a step lays out."""
    width = draw(st.sampled_from(WIDTHS))
    slots = draw(st.integers(1, 8))
    rows = draw(st.permutations(range(slots)))[:draw(st.integers(0, slots))]
    row_ids = np.full(width, -1, np.int32)
    q_pos = np.zeros(width, np.int32)
    pos = 0
    for r in rows:
        if pos == width:
            break
        n = draw(st.integers(1, width - pos))
        first = draw(st.integers(0, 1023 - n))
        row_ids[pos:pos + n] = r
        q_pos[pos:pos + n] = first + np.arange(n)
        pos += n
    return row_ids, q_pos, slots


@settings(max_examples=150, deadline=None)
@given(_row_layouts())
def test_fixed_plan_holds_every_row_layout(layout):
    row_ids, q_pos, slots = layout
    _check_fixed_plan(row_ids, q_pos, 64, slots)


def test_fixed_plan_refuses_more_rows():
    """A layout with more row segments than the plan was sized for is
    refused, never cut."""
    row_ids = np.arange(16, dtype=np.int32)          # 16 decode rows
    with pytest.raises(ValueError, match="tiles at width 16"):
        plan_ragged(row_ids, np.zeros(16, np.int32), TILE, 64,
                    sm_count=SM_COUNT, slots=4, **SMOLLM2)


def test_pick_splits_rule():
    """Decode steps split long rows so that a block walks at most 8 pages
    (one per warp); a step whose tiles fill half the card does not split."""
    assert pick_splits(4, 63, 3, SM_COUNT) == 8       # decode at 1000
    assert pick_splits(1, 63, 3, SM_COUNT) == 8
    assert pick_splits(4, 20, 3, SM_COUNT) == 3
    assert pick_splits(4, 8, 3, SM_COUNT) == 1
    assert pick_splits(22, 63, 3, SM_COUNT) == 1      # 66 blocks: half a wave
    assert pick_splits(21, 63, 3, SM_COUNT) == 8
    assert pick_splits(34, 38, 3, SM_COUNT) == 1      # mixed prefill, W = 512


def test_plan_tiles_break_on_row_and_position():
    """A tile never spans two rows, a jump in q_pos or more than 16
    positions; padding runs are tiles of their own."""
    row_ids = np.array([0, 0, 1, 1, 1, 1, -1, -1] + [2] * 20 + [-1] * 4, np.int32)
    q_pos = np.array([5, 9, 0, 1, 2, 3, 0, 0] + list(range(7, 27)) + [0] * 4,
                     np.int32)
    plan = plan_ragged(row_ids, q_pos, TILE, 4, 3, SM_COUNT, group=3, splits=1)
    assert plan.items[:, :4].tolist() == [
        [0, 1, 0, 5], [1, 1, 0, 9], [2, 4, 1, 0], [6, 2, -1, 0],
        [8, 16, 2, 7], [24, 4, 2, 23], [28, 4, -1, 0]]
    _check_plan(plan, row_ids, q_pos, 4)


# ------------------------------------------------- the plan's arithmetic

def _layout(kind, w, mp, t):
    row_ids = np.full(w, -1, np.int32)
    q_pos = np.zeros(w, np.int32)
    if kind == "page_edges":      # decode rows at 0, 15, 16, 17 and MP*T - 1
        for r, p in enumerate([0, t - 1, t, t + 1, mp * t - 1]):
            row_ids[r], q_pos[r] = r, p
    elif kind == "long_row":
        row_ids[0], q_pos[0] = 0, mp * t - 2
    else:                         # segments of 1, 15, 16, 17, 40 mid-page
        pos = 0
        for r, (first, n) in enumerate([(5, 1), (21, 15), (37, 16), (3, 17),
                                        (50, 40)]):
            row_ids[pos:pos + n] = r
            q_pos[pos:pos + n] = first + np.arange(n)
            pos += n
    return row_ids, q_pos


@pytest.mark.parametrize("splits", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["page_edges", "long_row", "segments"])
def test_planned_arithmetic_matches_jax_ref(kind, splits):
    """Per-block partials over page ranges, merged in split order, equal the
    JAX oracle to 1e-6 in float32: with more splits than a tile has pages
    (empty ranges), and splits where a tile's first rows see no key
    (all-masked partials: m = -inf, l = 0)."""
    hq, hkv, dh, t, mp, w = 6, 2, 16, TILE, 6, 96
    rng = np.random.default_rng(7)
    row_ids, q_pos = _layout(kind, w, mp, t)
    pages = 1 + 5 * mp
    q = rng.standard_normal((w, hq, dh)).astype(np.float32)
    kp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    bt = (rng.permutation(pages - 1) + 1).astype(np.int32).reshape(5, mp)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           block_tables=jnp.asarray(bt),
                           row_ids=jnp.asarray(row_ids),
                           q_pos=jnp.asarray(q_pos)))
    plan = plan_ragged(row_ids, q_pos, t, mp, hkv, SM_COUNT, group=hq // hkv,
                       splits=splits)
    got = ragged_attention_planned(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        block_tables=torch.from_numpy(bt), items=plan.items,
        splits=plan.splits).numpy()
    valid = row_ids >= 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-6, rtol=1e-6)
    assert not got[~valid].any()                  # padding: zeros


def test_cpu_call_ignores_the_plan():
    q, kp, vp, bt, row_ids, q_pos = _case(t=16, mp=2, pages=8)
    args = dict(block_tables=torch.from_numpy(bt),
                row_ids=torch.from_numpy(row_ids), q_pos=torch.from_numpy(q_pos))
    plan = plan_ragged(row_ids, q_pos, 16, 2, 2, SM_COUNT, group=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    assert torch.equal(ragged_attention(tq, tk, tv, plan=plan, **args),
                       ragged_attention(tq, tk, tv, **args))
