"""The port's graph walker (``repro_torch.analysis.graph_tools``) beside the
JAX package's jaxpr walker (``repro.analysis.jaxpr_tools``), on the CPU:

- the reference's seeded aliasing cases (``tests/test_analysis.py``'s
  ``test_aliasing_flags_unguarded_write`` and
  ``test_aliasing_accepts_guarded_write``) at the same shapes, through both
  packages: both flag the unguarded scatter with ``unguarded-write``
  naming ``trash0``, and both accept the guarded one;
- the port's ``paged_kv_update`` and ``flat_paged_kv_update`` give the same
  write count and index labels as the reference's walker on its own
  functions at the same shapes;
- every form of the zero case that a traced ``torch.where`` can take earns
  ``trash0``; a write through a ``repro_torch`` op whose mutated argument
  is the pool is a write site;
- a step with a host sync or a data-dependent shape stops the fake trace
  with a ``TraceError`` naming the op and its call site; nothing the trace
  touches is allocated on a real device.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.aliasing import lint_kv_writes as jlint_kv_writes
from repro.analysis.aliasing import taint_step as jtaint_step
from repro.models import attention as jattention
from repro_torch.analysis.aliasing import lint_kv_writes, taint_step
from repro_torch.analysis.graph_tools import (TRASH_LABEL, TaintWalker,
                                              TraceError, iter_nodes,
                                              leaf_labels, node_where,
                                              trace_step)
from repro_torch.models import attention

torch.set_num_threads(1)

S = jax.ShapeDtypeStruct
POOL = lambda p: "pages" if "_pages" in p else None


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_aliasing_flags_unguarded_write():
    """A scatter addressed without the validity route and its zero must be
    flagged, in both packages: the pass proves the guard."""
    def jbad(pages, idx, val):
        return pages.at[idx].set(val)

    def bad(pages, idx, val):
        pages[idx.long()] = val
        return pages

    jw = jtaint_step(jbad, (S((8, 4), jnp.float32), S((2,), jnp.int32),
                            S((2, 4), jnp.float32)), {0: "pages", 1: "block_tables"})
    w = taint_step(bad, (_meta((8, 4)), _meta((2,), torch.int32), _meta((2, 4))),
                   {0: "pages", 1: "block_tables"})
    for findings in (jlint_kv_writes(jw, "seeded-bad-update"),
                     lint_kv_writes(w, "seeded-bad-update")):
        assert any(f.rule == "unguarded-write" and "trash0" in f.message
                   for f in findings), findings
    assert [sorted(s.index_labels) for s in w.write_sites] == \
        [sorted(s.index_labels) for s in jw.write_sites] == [["block_tables"]]


def test_aliasing_accepts_guarded_write():
    """The real guard, where(valid, the block-table gather, 0), earns both
    labels and passes in both packages."""
    def jgood(pages, bt, counts, val):
        pos = jnp.arange(val.shape[0], dtype=jnp.int32)
        valid = pos < counts
        page = jnp.where(valid, bt[pos], 0)
        return pages.at[page].set(val)

    def good(pages, bt, counts, val):
        pos = torch.arange(val.shape[0], device=val.device)
        valid = pos < counts
        page = torch.where(valid, bt[pos].long(), 0)
        pages[page] = val
        return pages

    roles = {0: "pages", 1: "block_tables", 2: "validity"}
    jw = jtaint_step(jgood, (S((8, 4), jnp.float32), S((6,), jnp.int32),
                             S((), jnp.int32), S((6, 4), jnp.float32)), roles)
    w = taint_step(good, (_meta((8, 4)), _meta((6,), torch.int32),
                          _meta((), torch.int32), _meta((6, 4))), roles)
    assert jlint_kv_writes(jw, "guarded-update") == []
    assert lint_kv_writes(w, "guarded-update") == [], \
        [f.format() for f in lint_kv_writes(w, "guarded-update")]
    assert len(w.write_sites) == len(jw.write_sites) == 1


B, MP, T, HKV, DH, P = 3, 4, 8, 2, 16, 13


def _cache_specs():
    shp = (P, T, HKV, DH)
    return ({"k_pages": S(shp, jnp.float32), "v_pages": S(shp, jnp.float32)},
            {"k_pages": _meta(shp), "v_pages": _meta(shp)})


@pytest.mark.parametrize("unit", ["paged_kv_update", "flat_paged_kv_update"])
def test_unit_updates_match_reference_walker(unit):
    """Two pool writes each (K and V), indexed through the block tables
    and the trash route, with the same label sets as the reference's."""
    jcache, cache = _cache_specs()
    i32 = jnp.int32
    if unit == "paged_kv_update":
        s = 5
        jargs = (jcache, S((B, s, HKV, DH), jnp.float32), S((B, s, HKV, DH), jnp.float32),
                 S((B, MP), i32), S((B,), i32), S((B,), i32))
        args = (cache, _meta((B, s, HKV, DH)), _meta((B, s, HKV, DH)),
                _meta((B, MP), torch.int32), _meta((B,), torch.int32),
                _meta((B,), torch.int32))
        jfn = lambda c, k, v, bt, ln, nc: jattention.paged_kv_update(
            c, k, v, block_tables=bt, lens=ln, new_counts=nc)
        fn = lambda c, k, v, bt, ln, nc: attention.paged_kv_update(
            c, k, v, block_tables=bt, lens=ln, new_counts=nc)
    else:
        w = 24
        jargs = (jcache, S((1, w, HKV, DH), jnp.float32), S((1, w, HKV, DH), jnp.float32),
                 S((B, MP), i32), S((w,), i32), S((w,), i32))
        args = (cache, _meta((1, w, HKV, DH)), _meta((1, w, HKV, DH)),
                _meta((B, MP), torch.int32), _meta((w,), torch.int32),
                _meta((w,), torch.int32))
        jfn = lambda c, k, v, bt, r, q: jattention.flat_paged_kv_update(
            c, k, v, block_tables=bt, row_ids=r, q_pos=q)
        fn = lambda c, k, v, bt, r, q: attention.flat_paged_kv_update(
            c, k, v, block_tables=bt, row_ids=r, q_pos=q)
    roles = {0: POOL, 3: "block_tables", 4: "validity", 5: "validity"}
    jw = jtaint_step(jfn, jargs, roles)
    w = taint_step(fn, args, roles)
    jpool = [s for s in jw.write_sites if s.writes("pages")]
    pool = [s for s in w.write_sites if s.writes("pages")]
    assert len(pool) == len(jpool) == 2
    assert [sorted(s.index_labels) for s in pool] == \
        [sorted(s.index_labels) for s in jpool]
    assert all({"block_tables", TRASH_LABEL} <= s.index_labels for s in pool)
    assert lint_kv_writes(w, unit, expect_writes=2) == []
    assert all("repro_torch/models/attention.py:" in s.where for s in pool), \
        [s.where for s in pool]


ZEROS = {
    "python-scalar": lambda page: 0,
    "zeros-like": lambda page: torch.zeros_like(page),
    "full": lambda page: torch.full(page.shape, 0, dtype=page.dtype,
                                    device=page.device),
    "cast-expand": lambda page: torch.zeros((), device=page.device).long()
    .expand(page.shape),
    "view-unsqueeze": lambda page: torch.zeros(page.shape[0], dtype=page.dtype,
                                               device=page.device)
    .unsqueeze(0).view(page.shape),
}


@pytest.mark.parametrize("zero", sorted(ZEROS))
def test_trash_route_through_the_constant_folder(zero):
    """where(valid, page, <a zero>) earns trash0 whatever form the zero
    takes in the traced graph; a nonzero constant does not."""
    def update(pages, bt, valid_in, val, make=ZEROS[zero]):
        valid = valid_in > 0
        page = bt.long()
        pages[torch.where(valid, page, make(page))] = val
        return pages

    args = (_meta((8, 4)), _meta((6,), torch.int32), _meta((6,), torch.int32),
            _meta((6, 4)))
    roles = {0: "pages", 1: "block_tables", 2: "validity"}
    w = taint_step(update, args, roles)
    assert lint_kv_writes(w, zero) == []

    def one(pages, bt, valid_in, val):
        pages[torch.where(valid_in > 0, bt.long(), 1)] = val
        return pages

    w1 = taint_step(one, args, roles)
    assert [f.rule for f in lint_kv_writes(w1, zero)] == ["unguarded-write"]


def test_kernel_op_writing_the_pool_is_a_write_site():
    """A repro_torch op whose mutated argument carries the pool's label is
    judged like a scatter (a fused KV store would be one): wkv6's state is
    its written argument."""
    from repro_torch.kernels.wkv6.ops import checkpoints, wkv6

    def step(r, u, state):
        y, _ = wkv6(r, r, r, r, u, state, state_out=state,
                    ckpt=checkpoints(r))
        return y

    args = (_meta((1, 20, 2, 16)), _meta((2, 16)), _meta((1, 2, 16, 16)))
    w = taint_step(step, args, {2: "pages"})
    assert [s.prim for s in w.write_sites] == ["repro_torch.wkv6"]
    assert [f.rule for f in lint_kv_writes(w, "op")] == ["unguarded-write"]


def test_trace_is_fake_and_each_kernel_one_node():
    """The traced step allocates nothing real, each kernel is one
    repro_torch node, and the placeholders follow the argument leaves."""
    from repro_torch.kernels.mmt4d.ops import mmt4d
    from repro_torch.kernels.pack.ops import pack

    def step(tree, x):
        return mmt4d(pack(x, 8, 16), tree["w"], activation="silu")

    args = ({"w": torch.zeros(2, 3, 32, 16), "none": None}, torch.zeros(20, 48))
    gm = trace_step(step, args)
    ops = [str(n.target) for _, n in iter_nodes(gm) if n.op == "call_function"]
    assert ops == ["repro_torch.pack.default", "repro_torch.mmt4d.default"]
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert len(phs) == len(leaf_labels(args, {})) == 3
    out = [n for n in gm.graph.nodes if n.op == "output"][0].args[0][0]
    assert isinstance(out.meta["val"], torch._subclasses.fake_tensor.FakeTensor)
    assert tuple(out.meta["val"].shape) == (3, 2, 8, 32)
    assert all(node_where(n).startswith("<unknown") or ".py:" in node_where(n)
               for n in gm.graph.nodes)


@pytest.mark.parametrize("sync", ["item", "tolist", "nonzero"])
def test_host_sync_stops_the_trace_with_its_call_site(sync):
    def step(x):
        if sync == "item":
            return x * x.sum().item()
        if sync == "tolist":
            return x[: int(x.sum().tolist())]
        return x[torch.nonzero(x > 0)[:, 0]]

    with pytest.raises(TraceError) as e:
        trace_step(step, (torch.ones(4),))
    assert e.value.op.startswith("aten.")
    assert "host sync or a data-dependent op" in e.value.message


def test_taint_walker_counts_labels_per_placeholder():
    gm = trace_step(lambda a, b: a + b, (torch.ones(2), torch.ones(2)))
    with pytest.raises(ValueError, match="labels for 2 placeholders"):
        TaintWalker().run(gm, [set()])
    w = TaintWalker().run(gm, [{"pages"}, {"validity"}])
    assert w.out_labels == [{"pages", "validity"}]
