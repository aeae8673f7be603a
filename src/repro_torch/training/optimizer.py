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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import RunConfig

__all__ = ["AdamW", "make_optimizer", "global_norm", "tree_map", "leaves",
           "UPDATE_SLICE"]

# elements of a leaf the float32 update takes at once (256 MiB a temporary)
UPDATE_SLICE = 1 << 26


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves in the JAX package's flattening order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


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


def _quantize(x: torch.Tensor):
    """Per-row (last-axis) absmax int8 quantization; fewer than 2 dims stay
    float32 with a scale of 1."""
    if x.ndim < 2:
        return x.float(), torch.ones(x.shape[:-1], dtype=torch.float32,
                                     device=x.device)
    s = torch.clamp(x.abs().amax(dim=-1) / 127.0, min=1e-12)
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

    def init(self, params) -> dict:
        """Zero moments; every leaf its own storage (the update writes each
        in place)."""
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        if not self.eightbit:
            return {"m": zeros(), "v": zeros()}
        mq, ms = _tree_quant(zeros())
        vq, vs = _tree_quant(zeros())
        return {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}

    def update(self, grads, opt_state: dict, params, scalars: torch.Tensor):
        """One step, written into ``params`` and ``opt_state`` in place;
        ``scalars``: the step's :meth:`scalars` on the parameters' device.
        Returns (params, opt_state, {"grad_norm", "lr"}), ``lr`` a 0-d
        view of ``scalars``."""
        gnorm = global_norm(grads)
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
            def leaf(p, g, mq, ms, vq, vs):
                new = moments(p, g, _dequantize(mq, ms), _dequantize(vq, vs),
                              p.ndim >= 2)
                for q, s, x in zip((mq, vq), (ms, vs), new):
                    nq, ns = _quantize(x)
                    q.copy_(nq)
                    s.copy_(ns)
            tree_map(leaf, params, grads, *(opt_state[k] for k in
                                            ("m_q", "m_s", "v_q", "v_s")))
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
