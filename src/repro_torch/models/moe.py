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
- one dispatch block: ``local_dispatch`` and ``constrain_blocks`` only
  shard the sort over a data-parallel mesh, which the port has not
  (ROADMAP A10).

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

__all__ = ["moe_init", "moe_apply", "capacity", "DropCounter"]

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
    full-width leaf (arctic's 128 x 7168 x 4864) never exists in float32."""
    scale = (d_in ** -0.5) if scale is None else scale
    dev = generator.device
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=dev)
    step = max(1, _DRAW_ELEMENTS // (d_in * d_out))
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


def moe_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig,
              *, paged: Optional[dict] = None):
    """Returns (y [B, S, D] unpacked, aux {"load_balance", "router_z",
    "dropped_frac"}).  The stream is unpacked at entry (routing is
    token-level); the expert products run packed.  ``paged`` (a serving
    step's metadata) only tells an installed :class:`DropCounter` which
    tokens are real; every token routes."""
    if ctx.dp_size > 1:
        raise NotImplementedError("moe_apply: per-shard dispatch over a "
                                  "data-parallel mesh waits for ROADMAP A10")
    xu = maybe_unpack(x)
    b, s, d = xu.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = xu.reshape(t, d)
    dev = xf.device

    # 1. routing
    logits, probs, top_p, top_e = _route(xf, params["router"]["w"], k)

    # 2. sort by expert, capacity
    c = capacity(t, cfg)
    e_flat, w_flat = top_e.reshape(t * k), top_p.reshape(t * k)
    perm = torch.sort(e_flat, stable=True).indices            # token priority
    e_sorted = e_flat[perm]
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, 0) - counts                 # exclusive
    pos = torch.arange(t * k, device=dev) - offsets[e_sorted]
    keep = pos < c

    # 3. dispatch: kept assignments own distinct (expert, slot) pairs;
    # dropped ones land in row c, which is sliced off
    buf = torch.zeros((e, c + 1, d), dtype=xf.dtype, device=dev)
    buf.index_put_((e_sorted, torch.where(keep, pos, c)), gather_rows(xf, perm // k))
    x_e = buf[:, :c]

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
    y_e = batched_linear_apply(params["wd"], h, ctx)          # [E, C, D]

    # 5. combine: each token's k contributions in ascending expert order
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(t * k, device=dev)
    keep_flat = keep[inv].reshape(t, k)
    slot = torch.where(keep, pos, 0)[inv].reshape(t, k)
    order = torch.argsort(top_e, dim=-1)
    pick = lambda v: torch.gather(v, 1, order)
    ex, sl = pick(top_e), pick(slot)
    wk = (pick(top_p) * pick(keep_flat)).to(y_e.dtype)
    y = torch.zeros((t, d), dtype=xu.dtype, device=dev)
    rows = y_e.reshape(e * c, d)
    for j in range(k):
        y = y + gather_rows(rows, ex[:, j] * c + sl[:, j]) * wk[:, j, None]
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
    ce = counts.float() / (t * k)                              # dispatch fraction
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2),
           "dropped_frac": 1.0 - kept.float() / (t * k)}
    return y, aux
