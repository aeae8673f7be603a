"""Wrappers of the wkv6 kernels: RWKV-6's time-mix recurrence
(``csrc/wkv6.cu``) and its backward (``csrc/wkv6_bwd.cu``).

Replaces no Pallas kernel: the JAX package runs the recurrence as a
``lax.scan`` (src/repro/models/rwkv6.py:87, ``_wkv_scan``), which the
port would otherwise run as a Python loop of small launches per token,
and differentiates it through the scan, checkpointed per 128-token chunk.
The kernels are the ops ``torch.ops.repro_torch.wkv6`` and
``repro_torch.wkv6_bwd`` (:mod:`repro_torch.kernels.library`; the state
and the checkpoints are declared written in place): a CPU tensor takes the
plain versions (``ref.py``), a CUDA tensor launches the kernels or
raises.  Every operand is float32 and contiguous; the head width is one
of :data:`HEAD_WIDTHS`.  ``state_out`` may be ``s0`` itself: the serving
caches update their per-slot state in place.

Under autograd :func:`wkv6` is a ``torch.autograd.Function``: its forward
also writes the state at every chunk boundary (``ckpt``), its backward is
:func:`wkv6_bwd`, and the final state goes to a fresh tensor, never into
an input.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, library
from repro_torch.kernels.wkv6.ref import CHUNK, wkv6_bwd_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_bwd", "checkpoints", "HEAD_WIDTHS"]

HEAD_WIDTHS = (16, 32, 64, 128)   # one instance of the kernels each


def checkpoints(r: torch.Tensor) -> torch.Tensor:
    """An empty buffer for the state before each chunk of :data:`CHUNK`
    tokens but the first: [B, H, ceil(S / 16) - 1, dh, dh], r's dtype."""
    b, s, h, dh = r.shape
    return r.new_empty((b, h, max(0, -(-s // CHUNK) - 1), dh, dh))


def _check(name, r, k, v, w, u, s0, *extra):
    build.require_cuda(name, r, k, v, w, u, s0, *extra)
    tensors = (r, k, v, w, u, s0, *extra)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]}; "
                        f"the kernel takes float32")
    build.require_contiguous(name, r=r, k=k, v=v, w=w, u=u, s0=s0,
                             **{f"operand {i}": t for i, t in enumerate(extra)})
    b, s, h, dh = r.shape
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, dh)
            or s0.shape != (b, h, dh, dh)):
        raise ValueError(f"{name}: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"{name}: head width {dh}; the kernel takes {HEAD_WIDTHS}")


def _forward(r, k, v, w, u, s0, state_out, ckpt):
    out = torch.empty_like(s0) if state_out is None else state_out
    return _OP(r, k, v, w, u, s0, out, ckpt), out


def _wkv6_cpu(r, k, v, w, u, s0, state_out, ckpt):
    y, _ = wkv6_ref(r, k, v, w, u, s0, state_out=state_out, ckpt=ckpt)
    return library.fresh(y, r, k, v, w, u, s0, state_out)


def _wkv6_cuda(r, k, v, w, u, s0, state_out, ckpt):
    _check("wkv6", r, k, v, w, u, s0, state_out,
           *(() if ckpt is None else (ckpt,)))
    if state_out.shape != s0.shape or (ckpt is not None
                                       and ckpt.shape != checkpoints(r).shape):
        raise ValueError(f"wkv6: state_out {tuple(state_out.shape)}, ckpt "
                         f"{None if ckpt is None else tuple(ckpt.shape)}")
    b, s, h, dh = r.shape
    y = torch.empty_like(r)
    rc = build.load_library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        None if ckpt is None or ckpt.numel() == 0 else ckpt.data_ptr(),
        b, s, h, dh, build.stream_of(r))
    build.check(rc, "wkv6")
    wkv6.launches += 1
    return y


def _wkv6_fake(r, k, v, w, u, s0, state_out, ckpt):
    return torch.empty_like(r, memory_format=torch.contiguous_format)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None,
         ckpt: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, S, H, dh]; u: [H, dh]; s0: [B, H, dh, dh].  Returns
    (y [B, S, H, dh], the final state: ``state_out`` when given, else a
    new tensor).  ``ckpt`` (:func:`checkpoints`) also takes the state at
    every chunk boundary.  Under autograd (an operand that requires a
    gradient) the call is differentiable and takes neither."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        if state_out is not None or ckpt is not None:
            raise ValueError("wkv6: under autograd the final state goes to a "
                             "fresh tensor and the checkpoints are the "
                             "call's own")
        return _Wkv6Fn.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0, state_out, ckpt)


wkv6.launches = 0


class _Wkv6Fn(torch.autograd.Function):
    """wkv6 with its gradient: the forward saves its operands and the
    state at each chunk boundary; the backward is one :func:`wkv6_bwd`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ckpt = checkpoints(r)
        y, state = _forward(r, k, v, w, u, s0, None, ckpt)
        ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        return y, state

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return wkv6_bwd(r, k, v, w, u, s0, dy.contiguous(),
                        None if ds is None else ds.contiguous(), ckpt)


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
             dy: torch.Tensor, ds: Optional[torch.Tensor], ckpt: torch.Tensor):
    """(dr, dk, dv, dw, du, ds0): the gradients of :func:`wkv6` at (r, k,
    v, w, u, s0) from dy [B, S, H, dh] and ds (the final state's gradient;
    None: zero), with ``ckpt`` as the forward wrote it.  A CPU tensor takes
    :func:`~repro_torch.kernels.wkv6.ref.wkv6_bwd_ref`; a CUDA tensor
    launches the backward kernel (and the sum of its per-row ``du``
    partials, in row order) or raises."""
    return _BWD(r, k, v, w, u, s0, dy, ds, ckpt)


def _bwd_cpu(r, k, v, w, u, s0, dy, ds, ckpt):
    return library.fresh(wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds, ckpt),
                         r, k, v, w, u, s0, dy, ds, ckpt)


def _bwd_cuda(r, k, v, w, u, s0, dy, ds, ckpt):
    name = "wkv6_bwd"
    _check(name, r, k, v, w, u, s0, dy, ckpt, *(() if ds is None else (ds,)))
    b, s, h, dh = r.shape
    if (dy.shape != r.shape or ckpt.shape != checkpoints(r).shape
            or (ds is not None and ds.shape != s0.shape)):
        raise ValueError(f"{name}: dy {tuple(dy.shape)}, ckpt "
                         f"{tuple(ckpt.shape)}, ds "
                         f"{None if ds is None else tuple(ds.shape)}")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ds0 = torch.empty_like(s0)
    du_rows = r.new_empty((b, h, dh))
    rc = build.load_library().repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), dy.data_ptr(), None if ds is None else ds.data_ptr(),
        None if ckpt.numel() == 0 else ckpt.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), du_rows.data_ptr(), b, s, h, dh,
        build.stream_of(r))
    build.check(rc, name)
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


def _bwd_fake(r, k, v, w, u, s0, dy, ds, ckpt):
    like = lambda t: torch.empty_like(t, memory_format=torch.contiguous_format)
    return like(r), like(r), like(r), like(r), like(u), like(s0)


wkv6_bwd.launches = 0


library.register("wkv6", cpu=_wkv6_cpu, cuda=_wkv6_cuda, fake=_wkv6_fake)
library.register("wkv6_bwd", cpu=_bwd_cpu, cuda=_bwd_cuda, fake=_bwd_fake)
_OP = library.op("wkv6")
_BWD = library.op("wkv6_bwd")
