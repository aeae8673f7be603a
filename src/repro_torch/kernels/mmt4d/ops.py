"""Wrapper of the mmt4d kernel (``csrc/mmt4d.cu``).

Replaces the Pallas ``mmt4d_kernel_call`` (src/repro/kernels/mmt4d/kernel.py:113).
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  Operands are contiguous packed tiles of one dtype
(float32 or bfloat16); accumulation, bias and activation are float32, then
one cast.  bfloat16 runs on the tensor cores, cut by :func:`pick_split`
(K split in a thread-block cluster only where a block's K range is long);
float32 runs on the CUDA cores in IEEE arithmetic.  One launch per call
either way.

With ``unpack_to=(m, n)`` the same launch writes ``C[..., m, n]`` row-major,
the tile padding dropped, instead of ``C_pack``: the unpacked store, which
``core/linear.py`` uses wherever a linear's result leaves the packed
domain, so no unpack kernel follows it.  ``mmt4d.unpacked_stores`` counts
those launches beside ``mmt4d.launches``; :func:`unpacked_index` and
:meth:`Split.stores` mirror the store's index map.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mmt4d.ref import mmt4d_ref
from repro_torch.kernels.unpack.ref import unpack_ref

__all__ = ["mmt4d", "ACTIVATION_CODES", "Split", "pick_split", "unpacked_index"]

# activation name -> the code csrc/mmt4d.cu switches on (same keys as ACTIVATIONS)
ACTIVATION_CODES = {None: 0, "gelu": 1, "silu": 2, "relu": 3, "tanh": 4}

# limits of the bfloat16 kernel (csrc/mmt4d.cu)
MAX_COLS = 32            # tm * m_r: the MMA's N per block
MAX_CLUSTER = 8          # portable thread-block cluster size
ROWS = (64, 32, 16)      # weight rows per block
WARPS = 8                # per block: 16 rows each, K chunks split among them
CHUNKS_IN_FLIGHT = 4     # 32-wide K chunks a warp of a narrow block loads ahead


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Split:
    """How the bfloat16 kernel cuts one call.  Block (x, y, z) of the grid
    computes weight rows ``[r0, r0 + rows)`` of output tile ``no``, for mo
    tiles ``[y * tm, y * tm + tm)``, over its share of the K tiles; the
    ``splits`` blocks of one output slice form one cluster.  :meth:`work`
    is the kernel's index arithmetic."""

    rows: int       # weight rows per block: the MMA's M
    tm: int         # mo tiles per block: the MMA's N is tm * m_r
    splits: int     # K ranges per output slice, one block each
    grid: tuple     # (N_o * n_r / rows, ceil(M_o / tm), splits)

    @property
    def cluster(self) -> int:
        """Blocks per thread-block cluster: the splits of one slice."""
        return self.splits

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    def work(self, x: int, y: int, z: int, m_o: int, k_o: int, n_r: int):
        """Block (x, y, z)'s (mo range, no, weight-row range, ko range)."""
        per_tile = n_r // self.rows
        no, r0 = x // per_tile, (x % per_tile) * self.rows
        mo0 = y * self.tm
        return (range(mo0, min(mo0 + self.tm, m_o)), no,
                range(r0, r0 + self.rows),
                range(z * k_o // self.splits, (z + 1) * k_o // self.splits))

    def stores(self, x: int, y: int, z: int, m_o: int, m_r: int, n_r: int):
        """Block (x, y, z)'s share of its slice's epilogue: the (mo, no,
        mi, n) of each group of 4 outputs it stores (weight rows n .. n + 3
        of output tile (mo, no), activation row mi); the blocks of one
        cluster divide the slice's groups among themselves."""
        per_tile = n_r // self.rows
        no, r0 = x // per_tile, (x % per_tile) * self.rows
        mo0 = y * self.tm
        vpr = self.rows // 4
        items = min(self.tm, m_o - mo0) * m_r * vpr
        for it in range(z * items // self.splits, (z + 1) * items // self.splits):
            mm, q = divmod(it, vpr)
            yield mo0 + mm // m_r, no, mm % m_r, r0 + 4 * q


def unpacked_index(mo: int, no: int, mi: int, n: int, *, m: int, n_cols: int,
                   mo_per_batch: int, m_r: int, n_r: int):
    """Where the unpacked store writes output (mo, no, mi, n) of the folded
    C_pack: its (row, column) in C viewed as [batch * m, n_cols], or None
    for tile padding, which is not written (csrc/mmt4d.cu)."""
    b, mo_b = divmod(mo, mo_per_batch)
    r, col = mo_b * m_r + mi, no * n_r + n
    if r >= m or col >= n_cols:
        return None
    return b * m + r, col


@functools.lru_cache(maxsize=None)
def pick_split(m_o: int, n_o: int, k_o: int, m_r: int, n_r: int, k_r: int,
               sm_count: int) -> Split:
    """The bfloat16 kernel's decomposition of one call.

    A call is bound by the latency of a few dependent loads and MMAs more
    than by bytes, so the grid should cover the SMs; within that, a larger
    block (``rows`` x ``tm * m_r``) re-reads fewer bytes through L2.  The
    pick is the largest block (ties: more activation rows) of at most
    ``MAX_COLS`` activation rows whose grid covers every SM.  When none
    does (a decode linear: M_o = 1, 2-12 weight tiles), blocks of 16 rows
    take the whole K range without a cluster, whose launch and barriers
    cost more than the few blocks lose; K is split in a cluster (at most
    ``MAX_CLUSTER`` ways, none empty) only so far that no warp walks more
    than ``CHUNKS_IN_FLIGHT`` 32-wide K chunks (the down projection)."""
    rows_ok = [r for r in ROWS if n_r % r == 0]
    best = None
    for tm in range(1, max(1, min(m_o, MAX_COLS // m_r)) + 1):
        groups = _ceil_div(m_o, tm)
        for rows in rows_ok:
            slices = n_o * (n_r // rows)
            if slices * groups >= sm_count:
                key = (rows * tm, tm)
                if best is None or key > best[0]:
                    best = (key, rows, tm, slices, groups, 1)
    if best is None:
        rows, tm = rows_ok[-1], 1
        chunks = k_o * _ceil_div(k_r, 32) / (WARPS // (rows // 16))   # per warp
        splits = max(1, min(MAX_CLUSTER, k_o,
                            math.ceil(chunks / CHUNKS_IN_FLIGHT)))
        best = (None, rows, tm, n_o * (n_r // rows), m_o, splits)
    _, rows, tm, slices, groups, splits = best
    return Split(rows=rows, tm=tm, splits=splits,
                 grid=(slices, groups, splits))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mmt4d(a_pack: torch.Tensor, b_pack: torch.Tensor,
          bias_pack: Optional[torch.Tensor] = None, *,
          activation: Optional[str] = None,
          unpack_to: Optional[tuple] = None) -> torch.Tensor:
    """a_pack [..., M_o, K_o, m_r, k_r], b_pack [N_o, K_o, n_r, k_r],
    optional bias_pack [N_o, n_r] -> C_pack [..., M_o, N_o, m_r, n_r] in
    a_pack's dtype; with ``unpack_to=(m, n)``, C [..., m, n] (what
    ``unpack_ref`` makes of C_pack) from the same launch.  Leading dims
    fold into M_o."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"mmt4d: activation {activation!r} not in "
                         f"{list(ACTIVATION_CODES)}")
    if a_pack.ndim < 4 or b_pack.ndim != 4 \
            or a_pack.shape[-3] != b_pack.shape[1] \
            or a_pack.shape[-1] != b_pack.shape[3]:
        raise ValueError(f"mmt4d: shapes {tuple(a_pack.shape)} x "
                         f"{tuple(b_pack.shape)} do not contract")
    *lead, mo_b, k_o, m_r, k_r = a_pack.shape
    n_o, _, n_r, _ = b_pack.shape
    if bias_pack is not None and tuple(bias_pack.shape) != (n_o, n_r):
        raise ValueError(f"mmt4d: bias {tuple(bias_pack.shape)} is not "
                         f"({n_o}, {n_r})")
    if unpack_to is not None and not (0 <= unpack_to[0] <= mo_b * m_r
                                      and 0 < unpack_to[1] <= n_o * n_r):
        raise ValueError(f"mmt4d: unpack_to {unpack_to} outside the packed "
                         f"extent ({mo_b * m_r}, {n_o * n_r})")
    if a_pack.device.type == "cpu":
        out = mmt4d_ref(a_pack.reshape(-1, k_o, m_r, k_r), b_pack, bias_pack,
                        activation=activation).reshape(*lead, mo_b, n_o, m_r, n_r)
        return out if unpack_to is None else unpack_ref(out, *unpack_to)
    extra = () if bias_pack is None else (bias_pack,)
    dev = build.require_cuda("mmt4d", a_pack, b_pack, *extra)
    code = build.require_dtype("mmt4d", a_pack.dtype, a_pack, b_pack, *extra)
    build.require_contiguous("mmt4d", a_pack=a_pack, b_pack=b_pack,
                             **({"bias_pack": bias_pack} if extra else {}))
    m_o = math.prod(lead) * mo_b          # leading dims folded into M_o
    picks = (0, 0, 0)
    if a_pack.dtype == torch.bfloat16:
        if m_r % 8 or m_r > MAX_COLS or n_r % 64 or k_r % 16 or k_o == 0:
            raise ValueError(f"mmt4d: bfloat16 tiles m_r={m_r}, n_r={n_r}, "
                             f"k_r={k_r} (K_o={k_o}); the kernel takes m_r a "
                             f"multiple of 8 up to {MAX_COLS}, n_r of 64, "
                             f"k_r of 16, and K_o >= 1")
        if (a_pack.data_ptr() | b_pack.data_ptr()) % 16:
            raise ValueError("mmt4d: bfloat16 operands must start on 16 bytes")
        s = pick_split(m_o, n_o, k_o, m_r, n_r, k_r, _sm_count(dev))
        picks = (s.rows, s.tm, s.splits)
    if unpack_to is None:
        shape, extent = (*lead, mo_b, n_o, m_r, n_r), (0, 0, 0)
    else:
        shape, extent = (*lead, *unpack_to), (*unpack_to, max(1, mo_b))
    out = torch.empty(shape, dtype=a_pack.dtype, device=a_pack.device)
    rc = build.load_library().repro_mmt4d(
        a_pack.data_ptr(), b_pack.data_ptr(),
        None if bias_pack is None else bias_pack.data_ptr(), out.data_ptr(),
        code, m_o, n_o, k_o, m_r, n_r, k_r, ACTIVATION_CODES[activation],
        *picks, *extent, build.stream_of(a_pack))
    build.check(rc, "mmt4d")
    mmt4d.launches += 1
    mmt4d.unpacked_stores += unpack_to is not None
    return out


mmt4d.launches = 0
mmt4d.unpacked_stores = 0     # launches that wrote C unpacked
