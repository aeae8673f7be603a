"""Mixture-of-Experts FFN with sort-based capacity dispatch, the JAX
package's ``models/moe.py``.

  1. router (float32, a plain product as in the JAX package) -> top-k ->
     renormalised combine weights;
  2. flat (token, choice) assignments sorted by expert (stable), position
     in the expert from counts and offsets, capacity drop;
  3. dispatch into ``[E, C, D]``;
  4. the expert FFNs as expert-batched packed matmuls: one mmt4d launch
     per product over every expert (``core/linear.py:batched_linear_apply``);
  5. the weighted combine back to the tokens.

Aux losses: Switch-style load balance and the router z-loss, and the
dropped fraction.  Covers qwen3-moe (128 experts, top-8), arctic (128,
top-2, with a parallel dense branch) and jamba's moe layers (16, top-2).

What differs from the JAX package, and why:

- top-k is a stable descending sort (``lax.top_k`` puts the lower index
  first on a tie; ``torch.topk``'s tie order on the card is unspecified);
- the per-expert counts are a ``scatter_add_`` of ones, not ``bincount``
  (which reads its maximum back to the host on the card: no step with
  it could be captured in a CUDA graph);
- dispatch and combine use no atomics, so the step is bitwise repeatable
  (graph replay = eager, and the engine's other identities): dispatch is
  an ``index_put_`` into ``[E, C + 1, D]`` whose row C takes every dropped
  assignment and is sliced off (the JAX package adds zeros into row C - 1:
  the same values); the combine gathers each token's k contributions and
  adds them in ascending expert order, the order of the JAX package's
  scatter-add over the expert-sorted assignments.  Their gradients too:
  both gathers (of the tokens' rows into the dispatch, of the experts'
  rows into the combine) repeat rows, and their backward, an accumulate,
  adds in a fixed order (``models/common.py:gather_rows``);
- the per-shard dispatch (``ctx.moe_local``) takes the global view's
  blocks in one buffer ``[E, blocks * C + 1, D]``: block b's kept
  assignments fill rows ``b * C ..`` of each expert, every dropped one
  lands in the last row, which is sliced off, so the expert products read
  ``[E, blocks * C, D]`` as a view, the JAX package's ``[blocks, E, C,
  D]`` transposed; the combine reads the same rows back.  Its
  ``constrain_blocks`` pins the blocks to the data axes for GSPMD and
  has no counterpart: a rank of a ``DeviceMesh`` (the local view) holds
  its own block, routes and dispatches it alone, and all-reduces only
  the aux losses' terms over its data group (``ctx.dp``), so its
  aux losses, and its gradients once averaged over the data ranks, are
  the global view's.

Routing is token-level and not padding-neutral: padded tokens of a step
count toward routing and capacity, so a step's result depends on its
token count (``capacity``), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import (MatmulContext, batched_linear_apply,
                                     linear_init)
from repro_torch.core.propagation import pack_activation
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import Stream, gather_rows, maybe_unpack

__all__ = ["moe_init", "moe_apply", "capacity", "dispatch_blocks", "DropCounter"]

_DRAW_ELEMENTS = 1 << 28      # float32 elements drawn at a time (1 GiB)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = -(-c // 8) * 8  # round up to sublane multiple (packing-friendly)
    return max(8, min(c, n_tokens))


def _expert_linear_init(generator: torch.Generator, e: int, d_in: int,
                        d_out: int, dtype: torch.dtype,
                        scale: Optional[float] = None) -> dict:
    """``{"w": [e, d_in, d_out]}`` drawn N(0, scale^2) in float32 and cast,
    as the JAX package draws it, a block of experts at a time: a
    full-width leaf (arctic's 128 x 7168 x 4864) never exists in float32
    (on the meta device, which allocates nothing, in one draw)."""
    scale = (d_in ** -0.5) if scale is None else scale
    dev = generator.device
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=dev)
    step = e if dev.type == "meta" else max(1, _DRAW_ELEMENTS // (d_in * d_out))
    for e0 in range(0, e, step):
        n = min(step, e - e0)
        w[e0:e0 + n] = (torch.randn((n, d_in, d_out), generator=generator,
                                    device=dev) * scale).to(dtype)
    return {"w": w}


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's tree: ``router`` {"w" [d, E]} in float32, ``wu``
    and ``wd`` (and ``wg`` for a GLU) {"w" [E, d, d_ff_expert]} /
    [E, d_ff_expert, d], arctic's ``dense`` MLP."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": linear_init(generator, d, e, dtype=torch.float32,
                               scale=d ** -0.5),
         "wu": _expert_linear_init(generator, e, d, f, dtype),
         "wd": _expert_linear_init(generator, e, f, d, dtype,
                                   scale=f ** -0.5 / max(1, cfg.n_layers) ** 0.5)}
    if cfg.glu:
        p["wg"] = _expert_linear_init(generator, e, d, f, dtype)
    if cfg.dense_residual:
        p["dense"] = mlp_mod.mlp_init(generator, d, cfg.d_ff, cfg, dtype)
    return p


class DropCounter:
    """The real tokens' routed and kept assignments, summed over every moe
    layer call on one device while installed (:meth:`install`): ``counts``
    [2] int64 on the device, added to in place, so a CUDA graph captured
    while it is installed adds to it on every replay.  ``dropped_frac()``
    reads it.  A serving step's padding tokens are left out (``moe_apply``'s
    ``paged``): they route and take capacity as in the JAX package, but
    what they hold is the step's garbage (the card's ragged attention
    writes zeros there, the plain version attends over row 0), and they
    trail every real token of their row, so they never take a real
    token's expert slot ahead of it in the flat step."""

    _installed: dict = {}

    def __init__(self, device):
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)

    def install(self) -> "DropCounter":
        DropCounter._installed[self.counts.device.type] = self
        return self

    def uninstall(self) -> None:
        DropCounter._installed.pop(self.counts.device.type, None)

    def reset(self) -> None:
        self.counts.zero_()

    def dropped_frac(self) -> float:
        routed, kept = self.counts.tolist()
        return 1.0 - kept / routed if routed else 0.0


def _route(xf: torch.Tensor, w_router: torch.Tensor, k: int):
    """(logits, probs, top_p, top_e): float32 routing, the top k by a stable
    descending sort (ties to the lower expert), weights renormalised."""
    logits = xf.float() @ w_router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return logits, probs, top_p / top_p.sum(-1, keepdim=True), top_e


def _real_tokens(paged: dict, s: int) -> torch.Tensor:
    """A serving step's real tokens as a flat [B * S] mask: the flat
    step's ``row_ids >= 0``, the paged step's first ``new_counts[b]``
    positions of each row."""
    if "row_ids" in paged:
        return paged["row_ids"] >= 0
    pos = torch.arange(s, device=paged["new_counts"].device)
    return (pos[None, :] < paged["new_counts"][:, None]).reshape(-1)


def dispatch_blocks(t: int, ctx: MatmulContext) -> int:
    """The dispatch blocks of a step of ``t`` tokens: ``ctx.dp_size`` with
    the per-shard dispatch (``ctx.moe_local``) in the global view, when
    they divide the tokens, else 1.  A rank of a ``DeviceMesh`` (the
    local view, ``ctx.dp_local``) holds its own shard's tokens, which are
    one block: blocking them again would cut ``t / dp_size^2`` pieces."""
    if ctx.dp_local:
        if ctx.dp_size > 1 and not ctx.moe_local:
            raise NotImplementedError(
                "moe_apply on a rank of a data-parallel DeviceMesh needs "
                "RunConfig(moe_local_dispatch=True): the global dispatch sorts "
                "every rank's tokens together, which would need them gathered")
        return 1
    if ctx.moe_local and ctx.dp_size > 1 and t % ctx.dp_size == 0:
        return ctx.dp_size
    return 1


def moe_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig,
              *, paged: Optional[dict] = None):
    """Returns (y [B, S, D] unpacked, aux {"load_balance", "router_z",
    "dropped_frac"}).  The stream is unpacked at entry (routing is
    token-level); the expert products run packed.  The tokens are sorted
    and given capacity per dispatch block (:func:`dispatch_blocks`: the
    contiguous token blocks of a data-parallel step).  ``paged`` (a
    serving step's metadata) only tells an installed :class:`DropCounter`
    which tokens are real; every token routes."""
    xu = maybe_unpack(x)
    b, s, d = xu.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = xu.reshape(t, d)
    dev = xf.device
    blocks = dispatch_blocks(t, ctx)
    tb = t // blocks

    # 1. routing
    logits, probs, top_p, top_e = _route(xf, params["router"]["w"], k)

    # 2. sort by expert within each block, capacity per block
    c = capacity(tb, cfg)
    e_flat, w_flat = top_e.reshape(t * k), top_p.reshape(t * k)
    e_blk = e_flat.view(blocks, tb * k)
    # token priority within a block; global assignment indices
    perm = (torch.sort(e_blk, dim=-1, stable=True).indices
            + torch.arange(0, t * k, tb * k, device=dev)[:, None]).reshape(t * k)
    e_sorted = e_flat[perm]
    counts = torch.zeros((blocks, e), dtype=torch.int64, device=dev).scatter_add_(
        1, e_blk, torch.ones_like(e_blk))
    offsets = torch.cumsum(counts, 1) - counts                # exclusive
    blk = torch.arange(t * k, device=dev) // (tb * k)         # each sorted one's
    pos = torch.arange(tb * k, device=dev).repeat(blocks) - offsets[blk, e_sorted]
    keep = pos < c
    counts = counts.sum(0)

    # 3. dispatch: kept assignments own distinct (expert, row) pairs, block
    # b's in rows b*c ..; dropped ones land in the last row, sliced off
    rows_e = blocks * c
    buf = torch.zeros((e, rows_e + 1, d), dtype=xf.dtype, device=dev)
    row = torch.where(keep, blk * c + pos, rows_e)
    buf.index_put_((e_sorted, row), gather_rows(xf, perm // k))
    x_e = buf[:, :rows_e]

    # 4. the expert FFN, one launch per product over every expert
    act = cfg.act
    if cfg.glu:
        if ctx.packed:     # one pack of x_e for the gate and up products
            x_e = pack_activation(x_e, ctx.layout(x_e.dtype))
        g = batched_linear_apply(params["wg"], x_e, ctx, activation=act)
        u = batched_linear_apply(params["wu"], x_e, ctx)
        h = g * u
    else:
        h = batched_linear_apply(params["wu"], x_e, ctx, activation=act)
    y_e = batched_linear_apply(params["wd"], h, ctx)          # [E, blocks*C, D]

    # 5. combine: each token's k contributions in ascending expert order
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(t * k, device=dev)
    keep_flat = keep[inv].reshape(t, k)
    slot = torch.where(keep, row, 0)[inv].reshape(t, k)
    order = torch.argsort(top_e, dim=-1)
    pick = lambda v: torch.gather(v, 1, order)
    ex, sl = pick(top_e), pick(slot)
    wk = (pick(top_p) * pick(keep_flat)).to(y_e.dtype)
    y = torch.zeros((t, d), dtype=xu.dtype, device=dev)
    rows = y_e.reshape(e * rows_e, d)
    for j in range(k):
        y = y + gather_rows(rows, ex[:, j] * rows_e + sl[:, j]) * wk[:, j, None]
    y = y.reshape(b, s, d)

    if cfg.dense_residual:  # arctic: the parallel dense branch
        y = y + maybe_unpack(mlp_mod.mlp_apply(params["dense"], x, ctx, cfg))

    kept = keep.sum()
    counter = DropCounter._installed.get(dev.type)
    if counter is not None:
        if paged is None:
            counter.counts[0] += t * k
            counter.counts[1] += kept
        else:
            valid = _real_tokens(paged, s)
            counter.counts[0] += valid.sum() * k
            counter.counts[1] += (keep & valid[perm // k]).sum()
    me = probs.mean(0)                                         # mean router prob
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    routed = t * k
    if ctx.dp_local and ctx.dp is not None:
        # the local view: the aux losses over every rank's tokens, as the
        # global view's over all its blocks (each rank holds t tokens)
        me, z, counts, kept, routed = _over_ranks(me, z, counts, kept, routed,
                                                  ctx.dp.group)
    ce = counts.float() / routed                               # dispatch fraction
    aux = {"load_balance": e * torch.sum(me * ce), "router_z": z,
           "dropped_frac": 1.0 - kept.float() / routed}
    return y, aux


def _over_ranks(me, z, counts, kept, routed: int, group) -> tuple:
    """The aux losses' terms summed over the ranks of ``group``: the mean
    router probability and z-loss averaged (an all-reduce autograd follows:
    its backward sums each rank's gradient, so with the gradients averaged
    over the data ranks, as data-parallel training does, every parameter's
    gradient is the global view's), the counts, kept and routed summed."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce
    ranks = dist.get_world_size(group)
    me = all_reduce(me, group=group) / ranks
    z = all_reduce(z, group=group) / ranks
    ints = torch.cat([counts, kept.reshape(1)])
    dist.all_reduce(ints, group=group)
    return me, z, ints[:-1], ints[-1], routed * ranks
