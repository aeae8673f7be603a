"""Int8 error-feedback gradient compression (the JAX package's
``training/compression.py``).

Each gradient leaf plus its error buffer is quantized to int8 with one
absmax scale; the quantization error is kept and re-injected next step, so
the accumulated compressed gradients track the true ones (EF-SGD).  The
transform runs on the reduced gradients; across ranks (``ranks=``, an
``optimizer.Ranks``) on each rank's shard, the scale the max over every
rank that holds a piece of the leaf, so it is the whole leaf's.  The
error buffer is updated in place (the JAX package's jitted step donates
it).
"""

from __future__ import annotations

import torch

from repro_torch.training.optimizer import tensors, tree_map

__all__ = ["init_error_buffer", "compress_with_feedback"]


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    tensors(params))


def _q8(x: torch.Tensor, ranks=None, spec=None):
    top = x.abs().max() if x.numel() else torch.zeros((), device=x.device)
    if ranks is not None:
        top = ranks.max_over(top, spec)
    s = torch.clamp(top / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def compress_with_feedback(grads, err, ranks=None):
    """Returns (decompressed_grads, err): g_hat = Q8(g + err), and ``err``
    itself, set in place to (g + err) - g_hat."""
    specs = tree_map(lambda g: None, grads) if ranks is None else ranks.specs

    def one(g, e, spec):
        gf = g.float() + e
        q, s = _q8(gf, ranks, spec)
        deq = q.float() * s
        e.copy_(gf - deq)
        return deq.to(g.dtype)

    return tree_map(one, grads, err, specs), err
