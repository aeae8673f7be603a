"""Wrapper of the mmt4d kernel (``csrc/mmt4d.cu``).

Replaces the Pallas ``mmt4d_kernel_call`` (src/repro/kernels/mmt4d/kernel.py:113).
The kernel is the op ``torch.ops.repro_torch.mmt4d``, its gradients
``repro_torch.mmt4d_dgrad`` and ``repro_torch.mmt4d_wgrad``
(:mod:`repro_torch.kernels.library`): a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises.  Operands are contiguous packed tiles of one dtype
(float32 or bfloat16); accumulation, bias and activation are float32, then
one cast.  bfloat16 runs on the tensor cores, cut by :func:`pick_split`
(K split in a thread-block cluster only where a block's K range is long);
float32 runs on the CUDA cores in IEEE arithmetic, staging ``F32_CHUNK``
columns of k at a time, so it takes any ``k_r`` with ``m_r·n_r <= 4096``.
One launch per call either way.

Expert-batched (the MoE family's expert FFNs): ``a_pack [E, M_o, K_o, m_r,
k_r]`` and ``b_pack [E, N_o, K_o, n_r, k_r]`` (optional ``bias_pack [E,
N_o, n_r]``) give ``C[e] = act(A[e] B[e]^T + bias[e])``, every expert in
the same launch (the expert dim in the kernel's grid), packed or, with
``unpack_to=(m, n)``, stored unpacked as ``C [E, m, n]``.

With ``unpack_to=(m, n)`` the same launch writes ``C[..., m, n]`` row-major,
the tile padding dropped, instead of ``C_pack``: the unpacked store, which
``core/linear.py`` uses wherever a linear's result leaves the packed
domain, so no unpack kernel follows it.  ``mmt4d.unpacked_stores`` counts
those launches beside ``mmt4d.launches``, and ``mmt4d.bias_activation`` the
launches whose epilogue both adds a bias and applies an activation (the
encdec MLP's biased tanh-GELU up-projection); :func:`unpacked_index` and
:meth:`Split.stores` mirror the store's index map.

With ``partial=True`` the launch returns the float32 sums without the
epilogue and the cast (no bias, no activation): a rank's share of a
row-parallel product across ranks, which ``core/linear.py`` sums over the
ranks before it applies the bias and the activation once.  Packed or
unpacked alike; ``mmt4d.partials`` counts those launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, library
from repro_torch.kernels.mmt4d.ref import (mmt4d_dgrad_ref, mmt4d_ref,
                                           mmt4d_wgrad_ref)
from repro_torch.kernels.unpack.ref import unpack_ref

__all__ = ["mmt4d", "mmt4d_dgrad", "mmt4d_wgrad", "ACTIVATION_CODES", "Split",
           "pick_split", "unpacked_index", "gemm_operands", "pick_grad_split",
           "grad_tiles_ok", "grad_tma", "grad_store_offset", "F32_CHUNK"]

# activation name -> the code csrc/mmt4d.cu switches on (same keys as ACTIVATIONS)
ACTIVATION_CODES = {None: 0, "gelu": 1, "silu": 2, "relu": 3, "tanh": 4}

# limits of the bfloat16 kernel (csrc/mmt4d.cu)
MAX_COLS = 32            # tm * m_r: the MMA's N per block
MAX_CLUSTER = 8          # portable thread-block cluster size
ROWS = (64, 32, 16)      # weight rows per block
WARPS = 8                # per block: 16 rows each, K chunks split among them
CHUNKS_IN_FLIGHT = 4     # 32-wide K chunks a warp of a narrow block loads ahead
# the float32 kernel: columns of k staged in shared memory at a time (read
# at each call); the sums do not depend on it (one fmaf order), only the
# shared memory does, and at F32_CHUNK >= k_r whole tiles are staged
F32_CHUNK = 64


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
               sm_count: int, experts: int = 1) -> Split:
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
    than ``CHUNKS_IN_FLIGHT`` 32-wide K chunks (the down projection).

    With ``experts`` the grid repeats per expert (``m_o`` is one expert's):
    the blocks of every expert cover the SMs together, so an expert of one
    m_r tile (a flat step's capacity) takes the largest block and no
    split."""
    rows_ok = [r for r in ROWS if n_r % r == 0]
    best = None
    for tm in range(1, max(1, min(m_o, MAX_COLS // m_r)) + 1):
        groups = _ceil_div(m_o, tm)
        for rows in rows_ok:
            slices = n_o * (n_r // rows)
            if slices * groups * experts >= sm_count:
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
          unpack_to: Optional[tuple] = None,
          partial: bool = False) -> torch.Tensor:
    """a_pack [..., M_o, K_o, m_r, k_r], b_pack [N_o, K_o, n_r, k_r],
    optional bias_pack [N_o, n_r] -> C_pack [..., M_o, N_o, m_r, n_r] in
    a_pack's dtype; with ``unpack_to=(m, n)``, C [..., m, n] (what
    ``unpack_ref`` makes of C_pack) from the same launch.  Leading dims
    fold into M_o.  Expert-batched: a_pack [E, M_o, K_o, m_r, k_r], b_pack
    [E, N_o, K_o, n_r, k_r], bias_pack [E, N_o, n_r] -> C_pack [E, M_o,
    N_o, m_r, n_r] (or C [E, m, n]).  ``partial``: float32 sums, no
    epilogue and no cast (a bias or an activation is refused)."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"mmt4d: activation {activation!r} not in "
                         f"{list(ACTIVATION_CODES)}")
    if partial and (bias_pack is not None or activation is not None
                    or b_pack.ndim == 5):
        raise ValueError("mmt4d: a partial (float32, summed across ranks "
                         "before its epilogue) takes no bias, no activation "
                         "and no expert dim")
    experts = b_pack.shape[0] if b_pack.ndim == 5 else None
    if a_pack.ndim < 4 or b_pack.ndim not in (4, 5) \
            or (experts is not None and (a_pack.ndim != 5
                                         or a_pack.shape[0] != experts)) \
            or a_pack.shape[-3] != b_pack.shape[-3] \
            or a_pack.shape[-1] != b_pack.shape[-1]:
        raise ValueError(f"mmt4d: shapes {tuple(a_pack.shape)} x "
                         f"{tuple(b_pack.shape)} do not contract")
    *lead, mo_b, k_o, m_r, k_r = a_pack.shape
    n_o, _, n_r, _ = b_pack.shape[-4:]
    want_bias = (n_o, n_r) if experts is None else (experts, n_o, n_r)
    if bias_pack is not None and tuple(bias_pack.shape) != want_bias:
        raise ValueError(f"mmt4d: bias {tuple(bias_pack.shape)} is not "
                         f"{want_bias}")
    if unpack_to is not None and not (0 <= unpack_to[0] <= mo_b * m_r
                                      and 0 < unpack_to[1] <= n_o * n_r):
        raise ValueError(f"mmt4d: unpack_to {unpack_to} outside the packed "
                         f"extent ({mo_b * m_r}, {n_o * n_r})")
    return _OP(a_pack, b_pack, bias_pack, activation,
               None if unpack_to is None else list(unpack_to), partial)


def _out_shape(a_pack, b_pack, unpack_to) -> tuple:
    *lead, mo_b, _, m_r, _ = a_pack.shape
    n_o, _, n_r, _ = b_pack.shape[-4:]
    return ((*lead, mo_b, n_o, m_r, n_r) if unpack_to is None
            else (*lead, *unpack_to))


def _out_dtype(a_pack, partial):
    return torch.float32 if partial else a_pack.dtype


def _mmt4d_cpu(a_pack, b_pack, bias_pack, activation, unpack_to, partial=False):
    *lead, mo_b, k_o, m_r, k_r = a_pack.shape
    a_ref = a_pack if b_pack.ndim == 5 else a_pack.reshape(-1, k_o, m_r, k_r)
    out = mmt4d_ref(a_ref, b_pack, bias_pack, activation=activation,
                    out_dtype=_out_dtype(a_pack, partial)).reshape(
        _out_shape(a_pack, b_pack, None))
    if unpack_to is not None:
        out = unpack_ref(out, *unpack_to)
    return library.fresh(out, a_pack, b_pack)


def _mmt4d_cuda(a_pack, b_pack, bias_pack, activation, unpack_to,
                partial=False):
    experts = b_pack.shape[0] if b_pack.ndim == 5 else None
    *lead, mo_b, k_o, m_r, k_r = a_pack.shape
    n_o, _, n_r, _ = b_pack.shape[-4:]
    extra = () if bias_pack is None else (bias_pack,)
    dev = build.require_cuda("mmt4d", a_pack, b_pack, *extra)
    code = build.require_dtype("mmt4d", a_pack.dtype, a_pack, b_pack, *extra)
    build.require_contiguous("mmt4d", a_pack=a_pack, b_pack=b_pack,
                             **({"bias_pack": bias_pack} if extra else {}))
    m_o = math.prod(lead) * mo_b          # leading dims folded into M_o
    picks = (min(F32_CHUNK, k_r), 0, 0)     # float32: the k chunk
    if a_pack.dtype == torch.bfloat16:
        if m_r % 8 or m_r > MAX_COLS or n_r % 64 or k_r % 16 or k_o == 0:
            raise ValueError(f"mmt4d: bfloat16 tiles m_r={m_r}, n_r={n_r}, "
                             f"k_r={k_r} (K_o={k_o}); the kernel takes m_r a "
                             f"multiple of 8 up to {MAX_COLS}, n_r of 64, "
                             f"k_r of 16, and K_o >= 1")
        if (a_pack.data_ptr() | b_pack.data_ptr()) % 16:
            raise ValueError("mmt4d: bfloat16 operands must start on 16 bytes")
        s = pick_split(mo_b if experts else m_o, n_o, k_o, m_r, n_r, k_r,
                       _sm_count(dev), experts or 1)
        picks = (s.rows, s.tm, s.splits)
    extent = (0, 0, 0) if unpack_to is None else (*unpack_to, max(1, mo_b))
    out = torch.empty(_out_shape(a_pack, b_pack, unpack_to),
                      dtype=_out_dtype(a_pack, partial), device=a_pack.device)
    rc = build.load_library().repro_mmt4d(
        a_pack.data_ptr(), b_pack.data_ptr(),
        None if bias_pack is None else bias_pack.data_ptr(), out.data_ptr(),
        code, experts or 1, m_o, n_o, k_o, m_r, n_r, k_r,
        ACTIVATION_CODES[activation],
        *picks, *extent, int(partial), build.stream_of(a_pack))
    build.check(rc, "mmt4d")
    mmt4d.launches += 1
    mmt4d.partials += partial
    mmt4d.unpacked_stores += unpack_to is not None
    mmt4d.bias_activation += bias_pack is not None and activation is not None
    mmt4d.expert_batched += experts is not None
    return out


def _mmt4d_fake(a_pack, b_pack, bias_pack, activation, unpack_to,
                partial=False):
    return a_pack.new_empty(_out_shape(a_pack, b_pack, unpack_to),
                            dtype=_out_dtype(a_pack, partial))


mmt4d.launches = 0
mmt4d.unpacked_stores = 0     # launches that wrote C unpacked
mmt4d.bias_activation = 0     # launches whose epilogue adds a bias, then activates
mmt4d.expert_batched = 0      # launches over an expert-batched B_pack [E, ...]
mmt4d.partials = 0            # launches that stored a float32 partial


# ---------------------------------------------------------------- gradients
#
# mmt4d's two gradient products (csrc/mmt4d_bwd.cu): one kernel computes
# C[p, q] = sum_r X(p, r) Y(r, q) where each logical matrix lies in a packed
# tensor, element (i, j) at row_off(i) + col_off(j).  A descriptor
# (rs, ti, ii, cs, tj, ij) gives row_off(i) = (i // ti) * rs + (i % ti) * ii
# and col_off(j) = (j // tj) * cs + (j % tj) * ij.  In bfloat16 a block
# computes a GRAD_TILE of C (p x q) over chunks of r that TMA brings in
# (:func:`grad_tma`), its reduction split in a cluster by
# :func:`pick_grad_split`.

GRAD_TILE = (256, 128, 64)    # bfloat16: block tile (p, q) and reduction chunk (r)
GRAD_MIN_CHUNKS = 8           # chunks a split keeps at least


def _desc(o0: int, o1: int, t0: int, t1: int, transposed: bool = False) -> tuple:
    """The descriptor of a packed [O0, O1, t0, t1] tensor read as the
    logical [O0 * t0, O1 * t1] matrix, or as its transpose."""
    rows = (o1 * t0 * t1, t0, t1)          # (tile stride, tile, in-tile stride)
    cols = (t0 * t1, t1, 1)
    return (*cols, *rows) if transposed else (*rows, *cols)


def gemm_operands(kind: str, m_o: int, n_o: int, k_o: int, m_r: int, n_r: int,
                  k_r: int):
    """(P, Q, R, (X, Y, C descriptors), x_contig_p) of the ``"dgrad"`` or
    ``"wgrad"`` product on packed dZ [M_o, N_o, m_r, n_r], A_pack [M_o, K_o,
    m_r, k_r] and B_pack [N_o, K_o, n_r, k_r] (leading dims folded into M_o):

    - dgrad: X = dZ (p = m, r = n), Y = B_pack (r = n, q = k), C = dA_pack;
    - wgrad: X = dZ^T (p = n, r = m), Y = A_pack (r = m, q = k), C = dB_pack.

    ``x_contig_p``: X's consecutive addresses run along p (the kernel's
    loads follow them)."""
    dz = (m_o, n_o, m_r, n_r)
    if kind == "dgrad":
        return (m_o * m_r, k_o * k_r, n_o * n_r,
                (_desc(*dz), _desc(n_o, k_o, n_r, k_r), _desc(m_o, k_o, m_r, k_r)),
                False)
    if kind == "wgrad":
        return (n_o * n_r, k_o * k_r, m_o * m_r,
                (_desc(*dz, transposed=True), _desc(m_o, k_o, m_r, k_r),
                 _desc(n_o, k_o, n_r, k_r)), True)
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def pick_grad_split(p: int, q: int, r: int, sm_count: int, experts: int = 1) -> int:
    """Reduction ranges per output tile of the bfloat16 gradient kernel,
    one block each: the blocks of one tile form a cluster of that size.

    One block runs per SM (its ring takes most of the shared memory), and
    the kernel is bound by what L2 feeds the SMs, so more blocks than one
    wave buy nothing, and each split costs its partial tile's pass through
    distributed shared memory.  Output tiles too few to fill the SMs
    (wgrad at a layer linear: 5-36 tiles of 256 x 128) split the reduction
    as far as one wave of blocks allows, each split at least
    ``GRAD_MIN_CHUNKS`` chunks deep; the rest keep it whole.  A sweep of
    every split count on the H100 (``python -m
    repro_torch.kernels.mmt4d.sweep --grads``) ranks the pick first at the
    training linears but the tied head's dgrad and the Q/O projections'
    wgrad, within 9 % of the best there (PERF.md).  With ``experts`` the
    tiles repeat per expert (``p``, ``q``, ``r`` are one expert's)."""
    bp, bq, bk = GRAD_TILE
    tiles = _ceil_div(p, bp) * _ceil_div(q, bq) * experts
    chunks = _ceil_div(r, bk)
    return max(1, min(MAX_CLUSTER, sm_count // tiles, chunks // GRAD_MIN_CHUNKS))


def grad_tiles_ok(m_r: int, n_r: int, k_r: int) -> bool:
    """Whether the bfloat16 gradient kernel takes these tiles: its boxes cut
    n_r and k_r into 64-wide pieces (a power of two of them to a tile) and
    take whole m_r tiles (m_r a power of two up to 128)."""
    pow2 = lambda v: v > 0 and v & (v - 1) == 0
    return (n_r % 64 == 0 and k_r % 64 == 0 and pow2(n_r // 64) and pow2(k_r // 64)
            and pow2(m_r) and m_r <= 128)


def grad_tma(kind: str, m_o: int, n_o: int, k_o: int, m_r: int, n_r: int, k_r: int,
             experts: int = 1):
    """The bfloat16 gradient kernel's TMA geometry, mirrored from
    ``csrc/mmt4d_bwd.cu`` (``encode``, ``encode_mn``): ``(maps, loads)``.
    ``maps`` gives the tensor map of X (and of Z, shaped alike) and Y as
    (dims, strides, box), innermost first, strides in elements for dims
    1 and up; ``loads(p0, q0, r0)`` lists the block at (p0, q0)'s copies for
    the chunk at r0 as (operand, box origin).  dgrad's X is K-major: one
    4-D box, 256 rows of p by 64 of r.  An MN-major operand (wgrad's X,
    every Y) is a 5-D map, (64 of c, r in a tile, r tiles, 64-wide pieces
    of a c tile, c tiles) with c its contiguous dimension, whose box lays
    down [piece][64 r][64 c]: four pieces of X (p0 + 64 h), two of Y (q0 +
    64 h).  With ``experts`` the experts' packed slices follow one another,
    and each map folds them into its outer tile dimension (TMA takes at
    most five): ``loads(p0, q0, r0, e)`` then gives expert e's copies, its
    tiles from e M_o (dgrad's X, the p tiles) or e times the r tiles."""
    bp, bq, bk = GRAD_TILE

    def packed_map(o0, o1, t0, t1, box):
        return (t1, t0, o1, o0), (t1, t0 * t1, o1 * t0 * t1), box

    def mn_map(o0, o1, t0, t1, pieces):
        rb, nh = min(t0, bk), min(t1 // 64, pieces)
        return ((64, t0, o0, t1 // 64, o1), (t1, o1 * t0 * t1, 64, t0 * t1),
                (64, rb, bk // rb, nh, pieces // nh))

    e = experts
    if kind == "dgrad":
        p_t, r_t, q_t = m_r, n_r, k_r
        x = packed_map(e * m_o, n_o, m_r, n_r, (bk, m_r, 1, bp // m_r))
        y = mn_map(e * n_o, k_o, n_r, k_r, bq // 64)
        x_tiles, r_tiles = m_o, n_o
    elif kind == "wgrad":
        p_t, r_t, q_t = n_r, m_r, k_r
        x = mn_map(e * m_o, n_o, m_r, n_r, bp // 64)
        y = mn_map(e * m_o, k_o, m_r, k_r, bq // 64)
        x_tiles, r_tiles = m_o, m_o
    else:
        raise ValueError(kind)

    def loads(p0: int, q0: int, r0: int, ex: int = 0) -> list:
        ri, ro = r0 % r_t, r0 // r_t
        x_at = ((ri, 0, ro, ex * x_tiles + p0 // p_t) if kind == "dgrad"
                else (0, ri, ex * x_tiles + ro, (p0 % p_t) // 64, p0 // p_t))
        return [("x", x_at),
                ("y", (0, ri, ex * r_tiles + ro, (q0 % q_t) // 64, q0 // q_t))]

    return {"x": x, "y": y}, loads


def grad_store_offset(p: int, q: int, p_t: int, q_t: int, q_o: int) -> int:
    """Where the bfloat16 gradient kernel stores C[p, q]: C is [P_o, Q_o,
    p_t, q_t] (dA_pack or dB_pack), mirrored from its epilogue."""
    return ((p // p_t) * q_o + q // q_t) * p_t * q_t + (p % p_t) * q_t + q % q_t


def _fold(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, *t.shape[-3:])


def _check_grad_args(name, dz_pack, other, z_pack, activation):
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"{name}: activation {activation!r} not in "
                         f"{list(ACTIVATION_CODES)}")
    if (activation is None) != (z_pack is None):
        raise ValueError(f"{name}: the pre-activation z_pack comes with an "
                         f"activation, and only then")
    if z_pack is not None and z_pack.shape != dz_pack.shape:
        raise ValueError(f"{name}: z_pack {tuple(z_pack.shape)} is not shaped "
                         f"like dz_pack {tuple(dz_pack.shape)}")
    if dz_pack.ndim < 4 or other.ndim < 4:
        raise ValueError(f"{name}: packed operands have 4 trailing dims")


def _launch_gemm(name, kind, dz, y, z, dims, bias, activation, splits=None,
                 experts=1):
    """Launch the gradient kernel on folded, contiguous operands; returns
    (C, dbias or None).  ``splits`` overrides :func:`pick_grad_split`
    (bfloat16; the sweep ranks the choices).  ``experts``: the operands
    are [E, ...] stacks of one product each (``dims`` one expert's), the
    expert in the kernel's grid."""
    m_o, n_o, k_o, m_r, n_r, k_r = dims
    extra = () if z is None else (z,)
    build.require_cuda(name, dz, y, *extra)
    code = build.require_dtype(name, dz.dtype, dz, y, *extra)
    build.require_contiguous(name, dz_pack=dz, other=y,
                             **({"z_pack": z} if extra else {}))
    p, q, r, descs, x_contig_p = gemm_operands(kind, *dims)
    if dz.dtype == torch.bfloat16:
        if not grad_tiles_ok(m_r, n_r, k_r) or any(t.data_ptr() % 16
                                                    for t in (dz, y, *extra)):
            raise ValueError(f"{name}: bfloat16 tiles m_r={m_r}, n_r={n_r}, "
                             f"k_r={k_r}; the kernel's TMA boxes take n_r and "
                             f"k_r of 64 times a power of two, m_r a power of "
                             f"two up to 128, and every operand starting on 16 "
                             f"bytes")
        if experts > 1 and bias:
            raise ValueError(f"{name}: the expert-batched bfloat16 wgrad takes "
                             f"no bias (an expert linear has none)")
        if splits is None:
            splits = pick_grad_split(p, q, r, _sm_count(dz.device), experts)
    else:
        splits = 1
    shape = (m_o, k_o, m_r, k_r) if kind == "dgrad" else (n_o, k_o, n_r, k_r)
    lead = (experts,) if experts > 1 else ()
    out = torch.empty((*lead, *shape), dtype=dz.dtype, device=dz.device)
    dbias = (torch.empty((*lead, n_o, n_r), dtype=dz.dtype, device=dz.device)
             if bias else None)
    flat = (ctypes.c_int64 * 18)(*(v for d in descs for v in d))
    rc = build.load_library().repro_packed_gemm(
        dz.data_ptr(), None if z is None else z.data_ptr(), y.data_ptr(),
        out.data_ptr(), None if dbias is None else dbias.data_ptr(), code,
        p, q, r, flat, int(x_contig_p), ACTIVATION_CODES[activation], splits,
        experts, build.stream_of(dz))
    build.check(rc, name)
    return out, dbias


def mmt4d_dgrad(dz_pack: torch.Tensor, b_pack: torch.Tensor,
                z_pack: Optional[torch.Tensor] = None, *,
                activation: Optional[str] = None) -> torch.Tensor:
    """dA_pack [..., M_o, K_o, m_r, k_r] = sum over (N_o, n_r) of dZ .
    B_pack, with dZ = dz_pack [..., M_o, N_o, m_r, n_r], or dz_pack *
    act'(z_pack) when ``activation`` is given (z_pack: the pre-activation,
    packed alike).  b_pack [N_o, K_o, n_r, k_r].  Leading dims fold into M_o.
    Expert-batched: b_pack [E, N_o, K_o, n_r, k_r] and dz_pack [E, M_o,
    N_o, m_r, n_r] give each expert's dA_pack [E, M_o, K_o, m_r, k_r], in
    one launch.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    _check_grad_args("mmt4d_dgrad", dz_pack, b_pack, z_pack, activation)
    experts = b_pack.shape[0] if b_pack.ndim == 5 else None
    *lead, mo_b, n_o, m_r, n_r = dz_pack.shape
    n_o_b, k_o, n_r_b, k_r = b_pack.shape[-4:]
    if (b_pack.ndim not in (4, 5) or (n_o_b, n_r_b) != (n_o, n_r)
            or (experts is not None and tuple(lead) != (experts,))):
        raise ValueError(f"mmt4d_dgrad: dz {tuple(dz_pack.shape)} and b "
                         f"{tuple(b_pack.shape)} do not contract")
    dz = dz_pack if experts else _fold(dz_pack)
    z = None if z_pack is None else (z_pack if experts else _fold(z_pack))
    return _DGRAD(dz, b_pack, z, activation, None).reshape(
        *lead, mo_b, k_o, m_r, k_r)


def _dgrad_cpu(dz, b_pack, z, activation, splits):
    return library.fresh(mmt4d_dgrad_ref(dz, b_pack, z, activation=activation),
                         dz, b_pack)


def _dgrad_cuda(dz, b_pack, z, activation, splits):
    m_o, n_o, m_r, n_r = dz.shape[-4:]
    k_o, k_r = b_pack.shape[-3], b_pack.shape[-1]
    expert = b_pack.ndim == 5
    out, _ = _launch_gemm("mmt4d_dgrad", "dgrad", dz, b_pack, z,
                          (m_o, n_o, k_o, m_r, n_r, k_r), False, activation,
                          splits, experts=b_pack.shape[0] if expert else 1)
    mmt4d_dgrad.launches += 1
    mmt4d_dgrad.expert_batched += expert
    return out


def _dgrad_fake(dz, b_pack, z, activation, splits):
    return dz.new_empty((*dz.shape[:-3], b_pack.shape[-3], dz.shape[-2],
                         b_pack.shape[-1]))


def mmt4d_wgrad(dz_pack: torch.Tensor, a_pack: torch.Tensor,
                z_pack: Optional[torch.Tensor] = None, *,
                activation: Optional[str] = None, bias: bool = False,
                experts: bool = False):
    """(dB_pack [N_o, K_o, n_r, k_r] = sum over every (M_o, m_r) of dZ^T .
    A_pack, dbias [N_o, n_r] = the same sum of dZ alone when ``bias``, else
    None), both from one launch.  dz_pack [..., M_o, N_o, m_r, n_r] (dZ as
    for :func:`mmt4d_dgrad`), a_pack [..., M_o, K_o, m_r, k_r].  With
    ``experts`` the leading dim (E) is the expert's, not folded: each
    expert's dB_pack [E, N_o, K_o, n_r, k_r] and dbias [E, N_o, n_r].  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    _check_grad_args("mmt4d_wgrad", dz_pack, a_pack, z_pack, activation)
    if experts:
        if (dz_pack.ndim != 5 or a_pack.ndim != 5
                or a_pack.shape[0] != dz_pack.shape[0]):
            raise ValueError(f"mmt4d_wgrad: expert-batched dz "
                             f"{tuple(dz_pack.shape)} and a {tuple(a_pack.shape)}")
        dz, a, z = dz_pack, a_pack, z_pack
    else:
        dz, a = _fold(dz_pack), _fold(a_pack)
        z = None if z_pack is None else _fold(z_pack)
    m_o, n_o, m_r, n_r = dz.shape[-4:]
    if a.shape[-4] != m_o or a.shape[-2] != m_r:
        raise ValueError(f"mmt4d_wgrad: dz {tuple(dz_pack.shape)} and a "
                         f"{tuple(a_pack.shape)} do not contract")
    out, dbias = _WGRAD(dz, a, z, activation, bias, bool(experts), None)
    return out, (dbias if bias else None)


def _no_bias(dz):
    """The second output of a wgrad without a bias: empty (an op's outputs
    are tensors)."""
    return dz.new_empty((0,))


def _wgrad_cpu(dz, a, z, activation, bias, experts, splits):
    out, dbias = mmt4d_wgrad_ref(dz, a, z, activation=activation, bias=bias,
                                 experts=experts)
    return library.fresh((out, _no_bias(dz) if dbias is None else dbias), dz, a)


def _wgrad_cuda(dz, a, z, activation, bias, experts, splits):
    m_o, n_o, m_r, n_r = dz.shape[-4:]
    k_o, k_r = a.shape[-3], a.shape[-1]
    out, dbias = _launch_gemm("mmt4d_wgrad", "wgrad", dz, a, z,
                              (m_o, n_o, k_o, m_r, n_r, k_r), bias, activation,
                              splits, experts=dz.shape[0] if experts else 1)
    mmt4d_wgrad.launches += 1
    mmt4d_wgrad.expert_batched += experts
    return out, _no_bias(dz) if dbias is None else dbias


def _wgrad_fake(dz, a, z, activation, bias, experts, splits):
    lead = dz.shape[:1] if experts else ()
    n_o, n_r = dz.shape[-3], dz.shape[-1]
    out = dz.new_empty((*lead, n_o, a.shape[-3], n_r, a.shape[-1]))
    return out, dz.new_empty((*lead, n_o, n_r)) if bias else _no_bias(dz)


mmt4d_dgrad.launches = 0
mmt4d_wgrad.launches = 0
mmt4d_dgrad.expert_batched = 0    # launches over expert-batched operands
mmt4d_wgrad.expert_batched = 0


library.register("mmt4d", cpu=_mmt4d_cpu, cuda=_mmt4d_cuda, fake=_mmt4d_fake)
library.register("mmt4d_dgrad", cpu=_dgrad_cpu, cuda=_dgrad_cuda, fake=_dgrad_fake)
library.register("mmt4d_wgrad", cpu=_wgrad_cpu, cuda=_wgrad_cuda, fake=_wgrad_fake)
_OP = library.op("mmt4d")
_DGRAD = library.op("mmt4d_dgrad")
_WGRAD = library.op("mmt4d_wgrad")
