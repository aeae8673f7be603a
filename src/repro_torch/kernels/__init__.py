"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of the
JAX package: ``ops.py`` (the wrapper, with its launch count) beside
``ref.py`` (the plain PyTorch version).  Sources live in ``csrc/``."""

from __future__ import annotations


def wrappers() -> dict:
    """The kernel wrappers by name; each carries a ``launches`` count."""
    from repro_torch.kernels.mmt4d.ops import mmt4d
    from repro_torch.kernels.pack.ops import pack
    from repro_torch.kernels.ragged_attn.ops import ragged_attention
    from repro_torch.kernels.unpack.ops import unpack
    return {"mmt4d": mmt4d, "pack": pack, "unpack": unpack,
            "ragged_attn": ragged_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and mmt4d's ``unpacked_stores``."""
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["mmt4d"].unpacked_stores = 0
