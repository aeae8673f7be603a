"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of the
JAX package: ``ops.py`` (the wrapper, with its launch count) beside
``ref.py`` (the plain PyTorch version).  Sources live in ``csrc/``.

A wrapper adds one to its ``launches`` where it launches its kernel.  A
CUDA graph replay calls no wrapper, so each captured step records the
counts its capture added (:func:`counters` before and after) and adds
them again on every replay (:func:`add_counts`): the counts stay what the
card ran."""

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


def counters() -> dict:
    """Every count a wrapper keeps: ``launches`` by kernel name, and
    mmt4d's ``unpacked_stores`` as ``"mmt4d.unpacked_stores"``."""
    out = launch_counts()
    out["mmt4d.unpacked_stores"] = wrappers()["mmt4d"].unpacked_stores
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` (keys as :func:`counters` gives them) to the
    wrappers' counts."""
    fns = wrappers()
    for key, n in delta.items():
        name, _, attr = key.partition(".")
        attr = attr or "launches"
        setattr(fns[name], attr, getattr(fns[name], attr) + sign * n)


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and mmt4d's ``unpacked_stores``."""
    add_counts(counters(), -1)
