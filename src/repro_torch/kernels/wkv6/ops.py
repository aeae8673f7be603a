"""Wrapper of the wkv6 kernel (``csrc/wkv6.cu``): RWKV-6's time-mix
recurrence.

Replaces no Pallas kernel: the JAX package runs the recurrence as a
``lax.scan`` (src/repro/models/rwkv6.py:87, ``_wkv_scan``), which the
port would otherwise run as a Python loop of small launches per token.
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  Every operand is float32 and contiguous; the head
width is one of :data:`HEAD_WIDTHS`.  ``state_out`` may be ``s0`` itself:
the serving caches update their per-slot state in place.

The kernel has no backward yet (ROADMAP B8): a CUDA call that autograd
would have to differentiate raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import wkv6_ref

__all__ = ["wkv6", "HEAD_WIDTHS"]

HEAD_WIDTHS = (16, 32, 64, 128)   # one instance of the kernel each


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, S, H, dh]; u: [H, dh]; s0: [B, H, dh, dh].  Returns
    (y [B, S, H, dh], the final state: ``state_out`` when given, else a
    new tensor)."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0, state_out=state_out)
    out = torch.empty_like(s0) if state_out is None else state_out
    build.require_cuda("wkv6", r, k, v, w, u, s0, out)
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, s0, out)):
        raise TypeError(f"wkv6: dtypes {[t.dtype for t in (r, k, v, w, u, s0, out)]}; "
                        f"the kernel takes float32")
    build.require_contiguous("wkv6", r=r, k=k, v=v, w=w, u=u, s0=s0,
                             state_out=out)
    b, s, h, dh = r.shape
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, dh)
            or s0.shape != (b, h, dh, dh) or out.shape != s0.shape):
        raise ValueError(f"wkv6: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}, state_out "
                         f"{tuple(out.shape)}")
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"wkv6: head width {dh}; the kernel takes {HEAD_WIDTHS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        raise NotImplementedError("wkv6 has no backward kernel yet (ROADMAP B8): "
                                  "the recurrent families do not train on the card")
    y = torch.empty_like(r)
    rc = build.load_library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), out.data_ptr(), b, s, h, dh,
        build.stream_of(r))
    build.check(rc, "wkv6")
    wkv6.launches += 1
    return y, out


wkv6.launches = 0
