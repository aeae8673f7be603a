"""AdamW with warmup+cosine schedule, global-norm clipping, and optional
8-bit (per-row absmax quantized) moment states: the JAX package's
``training/optimizer.py`` in plain PyTorch tensor ops.

Parameters, gradients and states are nested dicts of tensors (the model's
parameter tree).  8-bit moments store m and v as int8 with float32 per-row
scales (shape ``param.shape[:-1]``); leaves of fewer than 2 dims stay
float32 with a scale of 1.

The update writes the new parameters and moments into the state's own
tensors, as the JAX package's jitted step, which donates its state, lets
XLA do; every leaf of ``init`` is its own storage, so no write lands on
another leaf.  The step's scalars (lr, and the two bias corrections) are
computed in float32 on the host (numpy), as the JAX package computes them
in float32, and read by the update from a small float32 tensor on the
parameters' device (:meth:`AdamW.scalars`): a CUDA graph of the step then
reads each step's values, and nothing is read back.

The float32 update of a leaf of more than :data:`UPDATE_SLICE` elements
runs over slices of that many (elementwise, so the result is the whole
leaf's bit for bit): its float32 temporaries, a few per element, then
stay a fraction of a GiB.  A CUDA graph's capture cannot give the free
memory of its pool back to the device, so each of the step's transients
must fit a block the capture's earlier transients left; the temporaries
of Qwen3-MoE's stacked experts, 3 GiB each whole, fitted none (ROADMAP
C11).

Across ranks (``update(..., ranks=)``, a :class:`Ranks`) every tree holds
the rank's shards: the global norm sums each leaf's squares over the
ranks that cut it and counts a replicated leaf once, and an 8-bit
moment's row absmax is the max over the ranks that cut the leaf's last
dim, so the update is the one-rank update's, shard by shard.  A
non-tensor leaf of the parameters (a linear's ``w_split``) reaches no
update: :func:`tree_map` hands it back and :func:`leaves` skips it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import RunConfig

__all__ = ["AdamW", "Ranks", "make_optimizer", "global_norm", "tree_map",
           "leaves", "UPDATE_SLICE"]

# elements of a leaf the float32 update takes at once (256 MiB a temporary)
UPDATE_SLICE = 1 << 26


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of one structure (the
    first tree's): a leaf of the first tree that is neither a dict nor a
    tensor (a linear's ``w_split`` across ranks) comes back as it is, and
    the other trees need not hold it."""
    if isinstance(trees[0], dict):
        return {k: (tree_map(fn, *(t[k] for t in trees))
                    if isinstance(v, (dict, torch.Tensor)) else v)
                for k, v in trees[0].items()}
    return fn(*trees)


def leaves(tree) -> list:
    """The tensor leaves in the JAX package's flattening order (sorted
    keys); a non-tensor leaf (``w_split``) is skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tensors(tree):
    """``tree`` without its non-tensor leaves."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()
                if isinstance(v, (dict, torch.Tensor))}
    return tree


class Ranks:
    """How a rank's trees are cut across the ranks of a mesh: its data
    and model axes (``DataAxis``, ``ModelAxis``; None for one rank) and
    ``specs``, the parameter tree's specs (``sharding.param_specs``; a
    moment's, an error buffer's and a gradient's are its parameter's)."""

    def __init__(self, dp, tp, specs):
        self.dp, self.tp, self.specs = dp, tp, specs

    def _cut_by(self, entries) -> list:
        names = {a for e in entries for a in
                 (() if e is None else e if isinstance(e, tuple) else (e,))}
        return [ax for ax, cut in ((self.dp, bool(names & {"pod", "data"})),
                                   (self.tp, "model" in names))
                if ax is not None and cut]

    def holder(self, spec) -> bool:
        """Whether this rank's copy of a leaf's piece is the one counted:
        on each axis that does not cut the leaf, rank 0's."""
        cut = self._cut_by(spec)
        return all(ax in cut or ax.rank == 0 for ax in (self.dp, self.tp)
                   if ax is not None)

    def max_over(self, t: torch.Tensor, entries) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks of the axes that
        ``entries`` (spec entries) name."""
        for ax in self._cut_by(entries):
            t = ax.max(t.contiguous())
        return t

    def norm(self, grads) -> torch.Tensor:
        """The whole tree's global norm from the rank's shards: each leaf's
        sum of squares, counted on one rank of each axis that does not cut
        it, summed over the ranks (one collective an axis), then over the
        leaves in their order, as :func:`global_norm` adds them."""
        sq = torch.stack([torch.sum(torch.square(g.float())) if self.holder(sp)
                          else torch.zeros((), device=g.device)
                          for g, sp in zip(leaves(grads), _spec_leaves(self.specs),
                                           strict=True)])
        for ax in (self.tp, self.dp):
            if ax is not None:
                ax.sum_(sq)
        return torch.sqrt(sum(sq.unbind()))


def _spec_leaves(specs) -> list:
    """A spec tree's leaves (tuples) in :func:`leaves`' order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def unzip(tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(_pick(tree, i) for i in range(n))


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves(tree)))


def _quantize(x: torch.Tensor, ranks: "Ranks" = None, spec=None):
    """Per-row (last-axis) absmax int8 quantization; fewer than 2 dims stay
    float32 with a scale of 1.  Across ranks (``ranks``, the leaf's
    ``spec``) the row absmax is the max over the ranks that cut the last
    axis, so the scales are the whole leaf's."""
    if x.ndim < 2:
        return x.float(), torch.ones(x.shape[:-1], dtype=torch.float32,
                                     device=x.device)
    top = (x.abs().amax(dim=-1) if x.shape[-1] else
           torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device))
    if ranks is not None:
        top = ranks.max_over(top, spec[-1:])
    s = torch.clamp(top / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q, s.float()


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if q.dtype != torch.int8:
        return q
    return q.float() * s[..., None]


def _tree_quant(tree):
    return unzip(tree_map(_quantize, tree), 2)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0
    eightbit: bool = False

    def schedule(self, step: int) -> float:
        """Linear warmup then cosine decay to ``min_lr_frac``, in float32."""
        f32 = np.float32
        step = f32(step)
        warm = np.minimum(f32(1.0), (step + f32(1)) / f32(max(1, self.warmup_steps)))
        prog = np.clip((step - f32(self.warmup_steps))
                       / f32(max(1, self.total_steps - self.warmup_steps)),
                       f32(0.0), f32(1.0))
        cos = f32(self.min_lr_frac) + f32(1 - self.min_lr_frac) * f32(0.5) \
            * (f32(1) + np.cos(f32(np.pi) * prog))
        return float(f32(self.lr) * warm * cos)

    def scalars(self, step: int, device="cpu") -> torch.Tensor:
        """float32 [lr, bc1, bc2] of ``step`` on ``device``: ``schedule(step)``
        and the bias corrections ``1 - b ** (step + 1)``, computed on the
        host in float32 as the JAX package computes them, and copied
        without waiting for the device."""
        f32 = np.float32
        t = f32(step) + f32(1.0)
        host = torch.tensor([self.schedule(step), f32(1) - f32(self.b1) ** t,
                             f32(1) - f32(self.b2) ** t], dtype=torch.float32)
        return host.to(device, non_blocking=True)

    def init(self, params, ranks: "Ranks" = None) -> dict:
        """Zero moments; every leaf its own storage (the update writes each
        in place); a rank's shards across ranks (no ``w_split`` in them)."""
        params = tensors(params)

        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        if not self.eightbit:
            return {"m": zeros(), "v": zeros()}
        mq, ms = _tree_quant(zeros())
        vq, vs = _tree_quant(zeros())
        return {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}

    def update(self, grads, opt_state: dict, params, scalars: torch.Tensor,
               ranks: "Ranks" = None):
        """One step, written into ``params`` and ``opt_state`` in place;
        ``scalars``: the step's :meth:`scalars` on the parameters' device.
        Returns (params, opt_state, {"grad_norm", "lr"}), ``lr`` a 0-d
        view of ``scalars``.  ``ranks``: every tree is the rank's shards
        (module docstring)."""
        gnorm = global_norm(grads) if ranks is None else ranks.norm(grads)
        specs = (tree_map(lambda p: None, params) if ranks is None
                 else ranks.specs)
        scale = (torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
                 if self.grad_clip > 0 else 1.0)
        lr, bc1, bc2 = scalars.unbind()
        b1, b2 = self.b1, self.b2

        def moments(p, g, m_, v_, matrix):
            g = g.float() * scale
            m_ = b1 * m_ + (1 - b1) * g
            v_ = b2 * v_ + (1 - b2) * g * g
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps)
            if matrix:               # decoupled weight decay on matrices only
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
            return m_, v_

        if self.eightbit:
            def leaf(p, g, mq, ms, vq, vs, spec):
                new = moments(p, g, _dequantize(mq, ms), _dequantize(vq, vs),
                              p.ndim >= 2)
                for q, s, x in zip((mq, vq), (ms, vs), new):
                    nq, ns = _quantize(x, ranks, spec)
                    q.copy_(nq)
                    s.copy_(ns)
            tree_map(leaf, params, grads, *(opt_state[k] for k in
                                            ("m_q", "m_s", "v_q", "v_s")), specs)
        else:
            def leaf(p, g, m_, v_):
                whole = (p, g, m_, v_)
                if p.numel() > UPDATE_SLICE and all(t.is_contiguous() for t in whole):
                    flat = [t.view(-1) for t in whole]
                    parts = [[t[i:i + UPDATE_SLICE] for t in flat]
                             for i in range(0, p.numel(), UPDATE_SLICE)]
                else:
                    parts = [whole]
                for pp, gg, mm, vv in parts:
                    for t, x in zip((mm, vv), moments(pp, gg, mm, vv, p.ndim >= 2)):
                        t.copy_(x)
            tree_map(leaf, params, grads, opt_state["m"], opt_state["v"])
        return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def make_optimizer(run: RunConfig, total_steps: int = 10000) -> AdamW:
    return AdamW(lr=run.lr, warmup_steps=run.warmup_steps,
                 weight_decay=run.weight_decay, grad_clip=run.grad_clip,
                 total_steps=total_steps, eightbit=run.adam_8bit)
