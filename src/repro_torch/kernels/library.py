"""The port's kernels as ``torch.library`` ops: ``torch.ops.repro_torch.*``.

Each kernel is one op of the ``repro_torch`` namespace, the PyTorch
counterpart of a ``pallas_call`` being a primitive with an abstract rule.
The dispatcher picks the impl by the device of the tensors it is given:

- ``CPU``: the kernel's plain version (``ref.py``);
- ``CUDA``: the ``ctypes`` launch of the kernel (``csrc/*.cu``, the plain
  C interface of :mod:`repro_torch.kernels.build`), which adds one to its
  wrapper's ``launches`` count, or raises;
- fake (``FakeTensorMode``): the output shapes only, so a step traced
  with fake tensors (:mod:`repro_torch.analysis.graph_tools`) records each
  launch as one node and allocates nothing;
- ``Meta``: raises, as the CUDA impl does for any tensor off the card (a
  meta tensor holds no data to launch on).

No impl computes with the plain version on a CUDA tensor, and no
composite impl stands in for a kernel.  Every argument a kernel writes in
place is declared mutated in its schema (``Tensor(a!)``): the
recurrences' state and checkpoint buffers.  Outputs never alias inputs.
Host-side plans (the ragged-attention plan, the gradient kernels' split)
go in as tensors or ints; the forward's tile split (``pick_split``) is
picked inside the CUDA impl from the card's SM count.

:func:`register` is called once per op by its wrapper module
(``kernels/<name>/ops.py``), which holds the three impls beside the
wrapper users call."""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["LIB", "SCHEMAS", "NAMESPACE", "register", "op", "fresh"]

NAMESPACE = "repro_torch"

# op name -> schema; every kernel of the port, in the order of PERF.md's table
SCHEMAS = {
    "mmt4d": "mmt4d(Tensor a_pack, Tensor b_pack, Tensor? bias_pack, "
             "str? activation, int[]? unpack_to, bool partial=False) -> Tensor",
    "pack": "pack(Tensor a, int t0, int t1) -> Tensor",
    "unpack": "unpack(Tensor a_pack, int m, int k) -> Tensor",
    "ragged_attn": "ragged_attn(Tensor q, Tensor k_pages, Tensor v_pages, "
                   "Tensor block_tables, Tensor row_ids, Tensor q_pos, "
                   "Tensor? items, int splits) -> Tensor",
    "ragged_attn_partial": "ragged_attn_partial(Tensor q, Tensor k_pages, "
                           "Tensor v_pages, Tensor block_tables, Tensor row_ids, "
                           "Tensor q_pos, Tensor? items, int splits, int page_lo, "
                           "int page_count) -> (Tensor, Tensor)",
    "mmt4d_dgrad": "mmt4d_dgrad(Tensor dz_pack, Tensor b_pack, Tensor? z_pack, "
                   "str? activation, int? splits) -> Tensor",
    "mmt4d_wgrad": "mmt4d_wgrad(Tensor dz_pack, Tensor a_pack, Tensor? z_pack, "
                   "str? activation, bool bias, bool experts, int? splits) "
                   "-> (Tensor, Tensor)",
    "wkv6": "wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0, "
            "Tensor(a!) state_out, Tensor(b!)? ckpt) -> Tensor",
    "wkv6_bwd": "wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
                "Tensor s0, Tensor dy, Tensor? ds, Tensor ckpt) "
                "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    "selective_scan": "selective_scan(Tensor delta, Tensor x, Tensor z, "
                      "Tensor b, Tensor c, Tensor a_log, Tensor d_skip, "
                      "Tensor(a!) state, Tensor(b!)? ckpt) -> Tensor",
    "selective_scan_bwd": "selective_scan_bwd(Tensor delta, Tensor x, Tensor z, "
                          "Tensor b, Tensor c, Tensor a_log, Tensor d_skip, "
                          "Tensor h0, Tensor dout, Tensor ckpt) -> (Tensor, "
                          "Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
}

LIB = torch.library.Library(NAMESPACE, "DEF")
for _schema in SCHEMAS.values():
    LIB.define(_schema)


def register(name: str, *, cpu, cuda, fake) -> None:
    """Register op ``name``'s impls (module docstring).  The Meta impl goes
    in after the fake one, which registers itself for meta tensors too."""
    def meta(*args):
        build.require_cuda(name, *(a for a in args if isinstance(a, torch.Tensor)))

    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    LIB.impl(name, meta, "Meta", allow_override=True)


def op(name: str):
    """The op's overload (``torch.ops.repro_torch.<name>.default``): called
    directly, it skips the packet's overload resolution."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def fresh(out, *inputs: torch.Tensor):
    """A CPU impl's result made what the schema promises: each tensor
    contiguous (as the kernel writes it and the fake impl describes it)
    and sharing no storage with an input (a plain version may return a
    view of one, e.g. an unpack of a single tile)."""
    if isinstance(out, (tuple, list)):
        return tuple(fresh(t, *inputs) for t in out)
    ptrs = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, torch.Tensor) and t.numel()}
    if out.numel() and out.untyped_storage().data_ptr() in ptrs:
        return out.clone(memory_format=torch.contiguous_format)
    return out.contiguous()
