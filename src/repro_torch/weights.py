"""Carry parameters and training state across from the JAX package.

:func:`from_jax_params` takes the reference's parameter tree with every
leaf already turned into a numpy array (the caller does the
``np.asarray``; this module imports no JAX) and returns the port's tree:
the same keys, shapes and dtypes, as torch tensors.  Any tree of arrays
comes across so, an optimizer state too (int8 moments, float32 scales,
0-d scales of 1-D leaves); :func:`from_jax_state` carries a whole train
state, so both packages' trainers can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params", "from_jax_state"]


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` (the port updates pools in place; the caller's
    arrays stay untouched)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def from_jax_params(tree, device="cpu"):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def from_jax_state(step, params, opt_state, device="cpu"):
    """The port's ``TrainState`` from the JAX package's ``TrainState``
    fields, each leaf a numpy array (``step`` a 0-d array or an int)."""
    from repro_torch.training.train_state import TrainState
    return TrainState(step=int(step), params=from_jax_params(params, device),
                      opt_state=from_jax_params(opt_state, device))
