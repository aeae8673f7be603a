"""Carry parameters across from the JAX package.

:func:`from_jax_params` takes the reference's parameter tree with every
leaf already turned into a numpy array (the caller does the
``np.asarray``; this module imports no JAX) and returns the port's tree:
the same keys, shapes and dtypes, as torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_params"]


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
