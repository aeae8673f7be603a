"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of the
JAX package: ``ops.py`` (the wrapper, with its launch count, and the op's
impls) beside ``ref.py`` (the plain PyTorch version).  Sources live in
``csrc/``.  Each kernel is a ``torch.library`` op, ``torch.ops.
repro_torch.<name>`` (:mod:`repro_torch.kernels.library`): the wrapper
checks its arguments and calls the op; the dispatcher takes the plain
version for CPU tensors and the kernel for CUDA tensors, and a fake impl
gives a traced step the shapes.
mmt4d's package also holds its two gradient products (``mmt4d_dgrad``,
``mmt4d_wgrad``, ``csrc/mmt4d_bwd.cu``); ``wkv6`` RWKV-6's recurrence
(``csrc/wkv6.cu``) and ``selective_scan`` mamba's
(``csrc/selective_scan.cu``), and their backwards (``wkv6_bwd``,
``selective_scan_bwd``), have no Pallas counterpart.

An op's CUDA impl adds one to its wrapper's ``launches`` where it
launches the kernel.  A
CUDA graph replay calls no wrapper, so each captured step records the
counts its capture added (:func:`counters` before and after) and adds
them again on every replay (:func:`add_counts`): the counts stay what the
card ran."""

from __future__ import annotations


def wrappers() -> dict:
    """The kernel wrappers by name; each carries a ``launches`` count."""
    from repro_torch.kernels.mmt4d.ops import mmt4d, mmt4d_dgrad, mmt4d_wgrad
    from repro_torch.kernels.pack.ops import pack
    from repro_torch.kernels.ragged_attn.ops import (ragged_attention,
                                                     ragged_attention_partial)
    from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                        selective_scan_bwd)
    from repro_torch.kernels.unpack.ops import unpack
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_bwd
    return {"mmt4d": mmt4d, "pack": pack, "unpack": unpack,
            "ragged_attn": ragged_attention,
            "ragged_attn_partial": ragged_attention_partial,
            "mmt4d_dgrad": mmt4d_dgrad,
            "mmt4d_wgrad": mmt4d_wgrad, "wkv6": wkv6,
            "selective_scan": selective_scan, "wkv6_bwd": wkv6_bwd,
            "selective_scan_bwd": selective_scan_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def counters() -> dict:
    """Every count a wrapper keeps: ``launches`` by kernel name, mmt4d's
    ``unpacked_stores``, ``bias_activation``, ``expert_batched`` and
    ``partials`` as ``"mmt4d.<count>"``, and the gradient kernels'
    ``expert_batched``."""
    out = launch_counts()
    fns = wrappers()
    for attr in ("unpacked_stores", "bias_activation", "expert_batched",
                 "partials"):
        out[f"mmt4d.{attr}"] = getattr(fns["mmt4d"], attr)
    for name in ("mmt4d_dgrad", "mmt4d_wgrad"):
        out[f"{name}.expert_batched"] = fns[name].expert_batched
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
    """Zero every wrapper's ``launches`` and mmt4d's other counts."""
    add_counts(counters(), -1)
