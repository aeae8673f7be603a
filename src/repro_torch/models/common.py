"""Shared model components: norms, rotary embeddings, embeddings,
activations.  Each speaks both plain tensors and :class:`PackedArray`."""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.core.linear import MatmulContext
from repro_torch.core.propagation import PackedArray, pack_activation

Stream = Union[torch.Tensor, PackedArray]

ACTS = {"silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
        "relu": F.relu,
        "tanh": torch.tanh}

__all__ = ["ACTS", "Stream", "norm_init", "norm_apply", "apply_rope",
           "embed_init", "embed_apply", "maybe_pack", "maybe_unpack",
           "stream_add"]


def maybe_pack(x: torch.Tensor, ctx: MatmulContext) -> Stream:
    if ctx.packed and ctx.propagate:
        return pack_activation(x, ctx.layout(x.dtype))
    return x


def maybe_unpack(x: Stream) -> torch.Tensor:
    return x.unpack() if isinstance(x, PackedArray) else x


def stream_add(a: Stream, b: Stream) -> Stream:
    if isinstance(a, PackedArray) and isinstance(b, PackedArray):
        return a + b
    return maybe_unpack(a) + maybe_unpack(b)


def norm_init(kind: str, d: int, dtype: torch.dtype = torch.float32) -> dict:
    if kind == "rmsnorm":
        return {"g": torch.ones((d,), dtype=dtype)}
    if kind == "layernorm":
        return {"g": torch.ones((d,), dtype=dtype),
                "b": torch.zeros((d,), dtype=dtype)}
    if kind == "layernorm_np":
        return {}
    raise ValueError(kind)


def norm_apply(params: dict, x: Stream, kind: str, eps: float = 1e-6) -> Stream:
    if isinstance(x, PackedArray):
        if kind == "rmsnorm":
            return x.rms_norm(params["g"], eps)
        if kind == "layernorm":
            return x.layer_norm(params["g"], params["b"], eps)
        if kind == "layernorm_np":
            return x.layer_norm(None, None, eps)
        raise ValueError(kind)
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * params["g"].float()).to(x.dtype)
    if kind in ("layernorm", "layernorm_np"):
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["g"].float() + params["b"].float()
        return y.to(x.dtype)
    raise ValueError(kind)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4, pct: float = 1.0):
    """Neox-style rotary embedding (rotate halves, not interleaved pairs).
    q: [B,S,Hq,dh], k: [B,S,Hkv,dh], positions: [B,S] or [S].  ``pct < 1``
    rotates only the first ``pct * dh`` dims."""
    dh = q.shape[-1]
    rot = int(dh * pct)
    rot -= rot % 2
    if positions.ndim == 1:
        positions = positions[None, :]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions.float()[..., None] * freqs            # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]

    def rotate(x):
        xr, xp = x[..., :rot], x[..., rot:]
        x1, x2 = xr[..., :half], xr[..., half:]
        y1 = x1 * cos - x2 * sin
        y2 = x2 * cos + x1 * sin
        return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], -1)

    return rotate(q), rotate(k)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> dict:
    return {"e": (torch.randn((vocab, d), generator=generator) * 0.02).to(dtype)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["e"][tokens.long()]
