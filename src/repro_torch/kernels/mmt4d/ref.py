"""Plain PyTorch versions of the mmt4d kernel and of its two gradient
products (``csrc/mmt4d.cu``, ``csrc/mmt4d_bwd.cu``).  Sums run in float32
(float64 stays float64, for ``gradcheck``), then one cast to the operands'
dtype."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    None: lambda x: x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}

_GELU_C = 0.7978845608028654      # sqrt(2 / pi)


def _gelu_grad(z):
    t = torch.tanh(_GELU_C * (z + 0.044715 * z * z * z))
    return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * _GELU_C * (1 + 3 * 0.044715 * z * z)


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1 + z * (1 - s))


# d act(z) / dz, the formulas csrc/mmt4d_bwd.cu evaluates
ACTIVATION_GRADS = {
    "gelu": _gelu_grad,
    "silu": _silu_grad,
    "relu": lambda z: (z > 0).to(z.dtype),
    "tanh": lambda z: 1 - torch.tanh(z) ** 2,
}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The sums' dtype: float32, or float64 for float64 operands."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def mmt4d_ref(a_pack: torch.Tensor, b_pack: torch.Tensor,
              bias_pack: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C_pack[m_o,n_o] = act(sum_k A_pack[m_o,k] @ B_pack[n_o,k]^T + bias),
    float32 accumulation and epilogue, one cast to A's dtype (or to
    ``out_dtype``: float32 keeps the sums as they are, the kernel's
    partial; not with an expert dim).  With an
    expert dim (a_pack [E, M_o, K_o, m_r, k_r], b_pack [E, N_o, K_o, n_r,
    k_r], bias_pack [E, N_o, n_r]) each expert's product, C_pack [E, M_o,
    N_o, m_r, n_r]."""
    acc = acc_dtype(a_pack.dtype)
    out_dtype = out_dtype or a_pack.dtype
    if b_pack.ndim == 5:
        return _experts_ref(a_pack, b_pack, bias_pack, activation, acc)
    out = torch.einsum("mkab,nkcb->mnac", a_pack.to(acc), b_pack.to(acc))
    if bias_pack is not None:
        out = out + bias_pack[None, :, None, :].to(acc)
    return ACTIVATIONS[activation](out).to(out_dtype)


def _experts_ref(a_pack, b_pack, bias_pack, activation, acc):
    """The expert-batched product, one K tile at a time: each tile's
    [E * N_o, n_r, k_r] slice of B is a strided view, so the weights (up to
    gigabytes a leaf) are never copied whole, as an einsum over the packed
    dims would.  Without a bias an expert whose rows of A are all zero
    (no token dispatched to it) gives zeros, as every activation maps 0
    to 0, and is skipped: a serving step routes its few tokens to a few
    of the experts, and the plain path need not read the others' weights."""
    e, m_o, k_o, m_r, k_r = a_pack.shape
    n_o, n_r = b_pack.shape[1], b_pack.shape[3]
    out = torch.zeros((e, n_o, m_o * m_r, n_r), dtype=acc, device=a_pack.device)
    live = slice(None)                     # a view: B read in place
    if bias_pack is None:
        idx = torch.nonzero(a_pack.reshape(e, -1).any(dim=1))[:, 0]
        if len(idx) < e:
            live = idx
    a = a_pack[live].to(acc).permute(0, 2, 1, 3, 4)
    a = a.reshape(a.shape[0], k_o, 1, m_o * m_r, k_r)
    part = out[live]
    for ko in range(k_o):
        part += torch.matmul(a[:, ko],
                             b_pack[live, :, ko].to(acc).transpose(-1, -2))
    out[live] = part
    out = out.reshape(e, n_o, m_o, m_r, n_r).permute(0, 2, 1, 3, 4)
    if bias_pack is not None:
        out = out + bias_pack[:, None, :, None, :].to(acc)
    return ACTIVATIONS[activation](out).to(a_pack.dtype).contiguous()


def dz_ref(dy: torch.Tensor, z: Optional[torch.Tensor],
           activation: Optional[str]) -> torch.Tensor:
    """dZ = dY * act'(Z) in the sums' dtype, rounded to dY's dtype (what the
    kernels form as they load dZ); dY itself without an activation."""
    if activation is None:
        return dy
    acc = acc_dtype(dy.dtype)
    return (dy.to(acc) * ACTIVATION_GRADS[activation](z.to(acc))).to(dy.dtype)


def mmt4d_dgrad_ref(dz_pack: torch.Tensor, b_pack: torch.Tensor,
                    z_pack: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None) -> torch.Tensor:
    """dA_pack[m_o,k_o,i,k] = sum_{n_o,j} dZ[m_o,n_o,i,j] B_pack[n_o,k_o,j,k];
    dz_pack [M_o, N_o, m_r, n_r] (leading dims folded), b_pack [N_o, K_o,
    n_r, k_r].  Expert-batched (b_pack [E, N_o, K_o, n_r, k_r], dz_pack
    [E, M_o, N_o, m_r, n_r]): each expert's, dA_pack [E, M_o, K_o, m_r,
    k_r]."""
    acc = acc_dtype(dz_pack.dtype)
    dz = dz_ref(dz_pack, z_pack, activation)
    eq = "emnij,enkjl->emkil" if b_pack.ndim == 5 else "mnij,nkjl->mkil"
    return torch.einsum(eq, dz.to(acc),
                        b_pack.to(acc)).to(dz_pack.dtype).contiguous()


def mmt4d_wgrad_ref(dz_pack: torch.Tensor, a_pack: torch.Tensor,
                    z_pack: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None, bias: bool = False,
                    experts: bool = False):
    """(dB_pack[n_o,k_o,j,k] = sum_{m_o,i} dZ[m_o,n_o,i,j] A_pack[m_o,k_o,i,k],
    dbias[n_o,j] = sum_{m_o,i} dZ[m_o,n_o,i,j] or None); dz_pack [M_o, N_o,
    m_r, n_r], a_pack [M_o, K_o, m_r, k_r].  With ``experts`` the leading
    dim of both is the expert's: each expert's sums, dB_pack [E, N_o, K_o,
    n_r, k_r] and dbias [E, N_o, n_r]."""
    acc = acc_dtype(dz_pack.dtype)
    dz = dz_ref(dz_pack, z_pack, activation).to(acc)
    e = "e" if experts else ""
    db = torch.einsum(f"{e}mnij,{e}mkil->{e}nkjl", dz,
                      a_pack.to(acc)).to(dz_pack.dtype).contiguous()
    dims = (1, 3) if experts else (0, 2)
    return db, (dz.sum(dim=dims).to(dz_pack.dtype) if bias else None)
