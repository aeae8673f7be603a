"""Wrapper of the ragged paged-attention kernel (``csrc/ragged_attn.cu``).

Replaces the Pallas ``ragged_attention_kernel_call``
(src/repro/kernels/ragged_attn/kernel.py:109).  A CPU tensor takes the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises.
q and the pools share one dtype (float32 or bfloat16) and are contiguous;
the index tensors are int32.  Bound by bytes: each page is read once per
(query position, KV head); sharing page loads across a segment's positions
is later work (see the source).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref

__all__ = ["ragged_attention"]


def ragged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, *, block_tables: torch.Tensor,
                     row_ids: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """q: [W, Hq, dh]; k_pages/v_pages: [P, T, Hkv, dh]; block_tables:
    [B, MP]; row_ids: [W] (-1 = pad); q_pos: [W].  Returns [W, Hq, dh]."""
    if q.device.type == "cpu":
        return ragged_attention_ref(q, k_pages, v_pages,
                                    block_tables=block_tables,
                                    row_ids=row_ids, q_pos=q_pos)
    build.require_cuda("ragged_attention", q, k_pages, v_pages, block_tables,
                       row_ids, q_pos)
    code = build.require_dtype("ragged_attention", q.dtype, q, k_pages, v_pages)
    for name, t in (("block_tables", block_tables), ("row_ids", row_ids),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"ragged_attention: {name} is {t.dtype}, not int32")
    build.require_contiguous("ragged_attention", q=q, k_pages=k_pages,
                             v_pages=v_pages, block_tables=block_tables,
                             row_ids=row_ids, q_pos=q_pos)
    w, hq, dh = q.shape
    p, t, hkv, dh2 = k_pages.shape
    if dh2 != dh or tuple(v_pages.shape) != tuple(k_pages.shape) \
            or hq % hkv or row_ids.shape != (w,) or q_pos.shape != (w,):
        raise ValueError(f"ragged_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"row_ids {tuple(row_ids.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} do not agree")
    out = torch.empty_like(q)
    rc = build.load_library().repro_ragged_attn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), row_ids.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), code, w, hq, hkv, dh, t, block_tables.shape[1],
        build.stream_of(q))
    build.check(rc, "ragged_attention")
    ragged_attention.launches += 1
    return out


ragged_attention.launches = 0
