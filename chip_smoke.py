"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from src/repro_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the full-width SmolLM2-135M
shapes of the serving path (float32 and bfloat16) and times both, then
serves full-width SmolLM2-135M (random weights from a seed) through each of
the engine's three step families (flat, dense chunked, monolithic), every
step a replay of a CUDA graph captured at warmup:

  1. the card (nvidia-smi name and power limit); TF32 off;
  2. the kernel build and its seconds;
  3. per kernel: max abs error against the plain version, with its
     tolerance (exceeding it raises); mmt4d also at every width of the bf16
     flat ladder (the gate linear), and twice, bit-identical; mmt4d's
     unpacked store at the Q, K/V and tied-head exits, bit-identical to the
     packed store followed by the unpack kernel, timed beside that pair, the
     packed store alone and torch.matmul; unpack beside an empty kernel
     launched the same way (the launch floor).  mmt4d, the
     tied-head pack and ragged_attn are timed L2-cold: each timed call of
     the kernel, the plain version and the library call takes the next of
     enough operand copies to pass 64 MB (the card's L2 holds 50 MB; the
     drain streams 30 layers of weights and KV pools through it every
     step).  ragged_attn (decode rows, one long decode row, mixed prefill)
     runs from a host-built plan (its split in the kernels line), also
     L2-warm, with padding zero, repeats bit-identical, no synchronising
     copy, a refused call without a plan, and beside the SDPA yardstick
     (one scaled_dot_product_attention on K/V gathered per row);
  4. float32 end to end, each family: a greedy drain of 4 requests on the
     card (after warmup; no graph captured during the drain) and on the CPU
     (plain versions), same weights and prompts: identical tokens, in every
     family alike (the top-2 margins at a first difference are printed);
  5. bfloat16 end to end, each family: Engine(max_slots=4, page_tokens=16,
     flat and dense chunk_tokens=128), seq_len 1024; warmup (its graphs, its
     seconds and the device memory it keeps), then 8 requests (prompts
     64-512 tokens, 32 new each) with the kernel launch counts set to 0
     just before the drain and read just after, checked per model call
     (and mmt4d's unpacked stores: the 91 linear exits of each call);
     no graph captured during the drain;
     in phases 4 and 5 the replay of two step shapes of each drain is held
     bit for bit to the model's eager step on the same inputs and state;
  6. the kernels JSON line (launches from the flat drain, the main path;
     each other family's beside them), then the result line.

Usage:  python3 chip_smoke.py [--out results.json]
Exits non-zero, printing no result, without a CUDA card or without the
repository's src/ beside it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TF = torch.float32
BF = torch.bfloat16
EXPECTED_PER_STEP = {"mmt4d": 30 * 7 + 1, "pack": 1 + 30 + 1 + 1,
                     "unpack": 1, "ragged_attn": 30}
# the paged step (dense chunked and monolithic families) attends through
# PyTorch (core_attention), as the JAX package does outside Pallas
EXPECTED_PER_PAGED_CALL = {**EXPECTED_PER_STEP, "ragged_attn": 0}
# mmt4d launches per model call that write their result unpacked: the Q/K/V
# exits of 30 layers and the tied head (the final stream's unpack stays a
# kernel); the same in every family
EXPECTED_UNPACKED_PER_STEP = 30 * 3 + 1
SOURCES = {
    "mmt4d": ("src/repro_torch/csrc/mmt4d.cu", "src/repro/kernels/mmt4d/kernel.py:113"),
    "pack": ("src/repro_torch/csrc/pack.cu", "src/repro/kernels/pack/kernel.py:46"),
    "unpack": ("src/repro_torch/csrc/unpack.cu", "src/repro/kernels/unpack/kernel.py:31"),
    "ragged_attn": ("src/repro_torch/csrc/ragged_attn.cu",
                    "src/repro/kernels/ragged_attn/kernel.py:109"),
}
# the case each kernel's headline numbers come from (bfloat16, the default
# RunConfig): the shape that carries most of its time in the drain
REPRESENTATIVE = {"mmt4d": "gate decode", "pack": "tied head embed",
                  "unpack": "final stream decode", "ragged_attn": "decode rows"}
# max |kernel - plain| <= TOL * max(1, max |plain|): float32 sums in another
# order; bfloat16 may round the float32 result to a neighbouring value
TOL = {TF: 1e-4, BF: 2e-2}
L2_FLUSH_BYTES = 64 * 2**20     # operand copies per cold-timed case pass this


def cold_sets(*tensors):
    """``tensors`` and enough copies of them to pass L2_FLUSH_BYTES."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = 1 + -(-L2_FLUSH_BYTES // nbytes)
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(copies - 1)]


def cycle(fn, sets):
    """A call of ``fn`` on the next set of operands, round robin."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SPIN_CYCLES_PER_MS: list = []


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    measured once."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    warm-up (CUDA events).  A spin kernel holds the stream while the host
    queues every call, so a call shorter than its host-side launch cost
    is timed on the device and not at the host's launch rate.  The spin
    lasts four times the host's measured time to queue the calls; should
    it still end first, the timing is refused and retried once with a
    spin twice as long."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    spin_ms = max(20.0, 4 * queue_ms)
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        spin_ms *= 2
    raise AssertionError("the spin kernel ended before the host had queued "
                         "every call, twice: the timing would be the host's")


class KernelChecks:
    """Kernel vs plain version at the serving path's shapes, timed."""

    def __init__(self, hw, gen):
        self.hw, self.gen = hw, gen
        self.cases = {name: [] for name in SOURCES}

    def rand(self, shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=self.gen, device="cuda") * scale).to(dtype)

    def bound(self, nbytes: int, flops: int, dtype) -> tuple[float, str]:
        t_bytes = nbytes / self.hw.hbm_bw
        t_ops = flops / self.hw.peak_flops(dtype)
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def record(self, name, label, dtype, kernel, plain, library, nbytes, flops,
               exact=False, select=lambda t: t, **extra):
        """Compare ``select`` of the two results (the positions the caller
        keeps), then time the bare calls."""
        got, want = select(kernel()), select(plain())
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = 0.0 if exact else TOL[dtype] * scale
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        print(f"  {name:<11} {label:<44} {str(dtype)[6:]:<8} max_abs_err "
              f"{err:.3e} (tolerance {tol:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} {dtype}: error {err} > {tol}")
        bound_ms, bound_by = self.bound(nbytes, flops, dtype)
        self.cases[name].append({
            "shape": label, "dtype": str(dtype)[6:], "max_abs_err": err,
            "kernel_ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": None if library is None else time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by, **extra})

    def mmt4d(self, dtype, w_tokens, k, n, act, label):
        from repro_torch.core import packing
        from repro_torch.core.layout import make_layout
        from repro_torch.kernels.mmt4d.ops import mmt4d, pick_split
        from repro_torch.kernels.mmt4d.ref import mmt4d_ref
        lay = make_layout("scalable", self.hw, dtype)
        x = self.rand((w_tokens, k), dtype)
        w = self.rand((k, n), dtype, k ** -0.5)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        out = mmt4d(ap, bp, activation=act)
        if not torch.equal(out, mmt4d(ap, bp, activation=act)):
            raise AssertionError(f"mmt4d {label} {dtype}: two calls differ")
        split = {} if dtype is TF else {"split": str(pick_split(
            ap.shape[0], bp.shape[0], ap.shape[1], lay.m_r, lay.n_r, lay.k_r,
            self.hw.sm_count))}
        sets = cold_sets(ap, bp, x, w)
        es = dtype.itemsize
        self.record("mmt4d", f"{label} A{tuple(ap.shape)} B{tuple(bp.shape)}", dtype,
                    cycle(lambda a, b, _x, _w: mmt4d(a, b, activation=act), sets),
                    cycle(lambda a, b, _x, _w: mmt4d_ref(a, b, activation=act), sets),
                    cycle(lambda _a, _b, xx, ww: torch.matmul(xx, ww), sets),
                    (ap.numel() + bp.numel() + out.numel()) * es,
                    2 * ap.shape[0] * lay.m_r * bp.shape[0] * lay.n_r
                    * ap.shape[1] * lay.k_r, copies=len(sets), **split)

    def mmt4d_unpacked(self, dtype, w_tokens, k, n, label):
        """A linear's exit: mmt4d writing [1, w_tokens, n] unpacked, held to
        the plain version (unpack_ref of mmt4d_ref) and bit for bit to the
        packed store followed by the unpack kernel; timed L2-cold beside
        that pair, the packed store alone and torch.matmul."""
        from repro_torch.core import packing
        from repro_torch.core.layout import make_layout
        from repro_torch.kernels.mmt4d.ops import mmt4d
        from repro_torch.kernels.mmt4d.ref import mmt4d_ref
        from repro_torch.kernels.unpack.ops import unpack
        from repro_torch.kernels.unpack.ref import unpack_ref
        lay = make_layout("scalable", self.hw, dtype)
        x = self.rand((1, w_tokens, k), dtype)
        w = self.rand((k, n), dtype, k ** -0.5)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        to = (w_tokens, n)

        def pair(a, b, *_):
            return unpack(mmt4d(a, b), *to)

        out = mmt4d(ap, bp, unpack_to=to)
        if not torch.equal(out, pair(ap, bp)):
            raise AssertionError(f"mmt4d {label} {dtype}: the unpacked store "
                                 f"differs from mmt4d then unpack")
        sets = cold_sets(ap, bp, x, w)
        es = dtype.itemsize
        self.record("mmt4d", f"{label} A{tuple(ap.shape)} B{tuple(bp.shape)}"
                    f" -> {tuple(out.shape)}", dtype,
                    cycle(lambda a, b, *_: mmt4d(a, b, unpack_to=to), sets),
                    cycle(lambda a, b, *_: unpack_ref(mmt4d_ref(a[0], b)[None], *to), sets),
                    cycle(lambda _a, _b, xx, ww: torch.matmul(xx, ww), sets),
                    (ap.numel() + bp.numel() + out.numel()) * es,
                    2 * ap.shape[1] * lay.m_r * bp.shape[0] * lay.n_r
                    * ap.shape[2] * lay.k_r, copies=len(sets),
                    pair_ms=time_ms(cycle(pair, sets)),
                    packed_ms=time_ms(cycle(lambda a, b, *_: mmt4d(a, b), sets)))

    def pack(self, dtype, x, t0, t1, label, cold=False):
        import torch.nn.functional as F
        from repro_torch.kernels.pack.ops import pack
        from repro_torch.kernels.pack.ref import pack_ref
        m, k = x.shape[-2:]
        mo, ko = -(-m // t0), -(-k // t1)

        def library(xx):
            xp = F.pad(xx, (0, ko * t1 - k, 0, mo * t0 - m))
            return xp.reshape(*xx.shape[:-2], mo, t0, ko, t1).transpose(-3, -2).contiguous()

        out = pack(x, t0, t1)
        sets = cold_sets(x) if cold else [(x,)]
        self.record("pack", f"{label} {tuple(x.shape)}->{tuple(out.shape)}", dtype,
                    cycle(lambda xx: pack(xx, t0, t1), sets),
                    cycle(lambda xx: pack_ref(xx, t0, t1), sets), cycle(library, sets),
                    (x.numel() + out.numel()) * dtype.itemsize, 0, exact=True,
                    copies=len(sets))

    def unpack(self, dtype, m, k, t0, t1, label):
        from repro_torch.kernels.pack.ops import pack
        from repro_torch.kernels.unpack.ops import unpack, vector_path
        from repro_torch.kernels.unpack.ref import unpack_ref
        ap = pack(self.rand((1, m, k), dtype), t0, t1)
        _, mo, ko, _, _ = ap.shape

        def library():       # the permute/reshape/contiguous chain
            return ap.permute(0, 1, 3, 2, 4).reshape(1, mo * t0, ko * t1)[:, :m, :k].contiguous()

        self.record("unpack", f"{label} {tuple(ap.shape)}->(1, {m}, {k})", dtype,
                    lambda: unpack(ap, m, k), lambda: unpack_ref(ap, m, k), library,
                    (ap.numel() + m * k) * dtype.itemsize, 0, exact=True,
                    vector_path=vector_path(ap, unpack(ap, m, k), k))

    def launch_floor(self):
        """The device time of an empty kernel launched as unpack launches,
        timed as every kernel here is: the launch floor; and of one that
        also waits on its predecessor (griddepcontrol), as unpack must."""
        from repro_torch.kernels.unpack.ops import empty_launch
        like = torch.empty(1, device="cuda")
        self.floor_ms = time_ms(lambda: empty_launch(like))
        self.floor_wait_ms = time_ms(lambda: empty_launch(like, wait=True))
        print(f"  {'unpack':<11} {'empty launch (the launch floor)':<44} "
              f"{self.floor_ms:.6f} ms, waiting on its predecessor "
              f"{self.floor_wait_ms:.6f} ms")

    def ragged(self, dtype, segments, width, label, pages=257, t=16, mp=64,
               hq=9, hkv=3, dh=64):
        """``segments``: [(row, first_pos, n)] laid out back to back in a
        stream of ``width`` positions (the rest padding).  Timed L2-cold
        (each call takes the next of enough copies of q and the pools to
        pass 64 MB) and L2-warm; the library call is the SDPA yardstick."""
        from repro_torch.kernels.ragged_attn.ops import plan_ragged, ragged_attention
        from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref
        rng = np.random.default_rng(len(segments) + width)
        bt = (rng.permutation(pages - 1)[:4 * mp] + 1).astype(np.int32).reshape(4, mp)
        row_ids = np.full(width, -1, np.int32)
        q_pos = np.zeros(width, np.int32)
        pos, need = 0, {}
        for row, first, n in segments:
            row_ids[pos:pos + n] = row
            q_pos[pos:pos + n] = first + np.arange(n)
            need[row] = max(need.get(row, 0), first + n)
            pos += n
        kp = self.rand((pages, t, hkv, dh), dtype)
        vp = self.rand((pages, t, hkv, dh), dtype)
        q = self.rand((width, hq, dh), dtype)
        args = dict(block_tables=torch.from_numpy(bt).cuda(),
                    row_ids=torch.from_numpy(row_ids).cuda(),
                    q_pos=torch.from_numpy(q_pos).cuda())
        plan = plan_ragged(row_ids, q_pos, t, mp, hkv, self.hw.sm_count,
                           group=hq // hkv).to("cuda")
        valid = torch.from_numpy(row_ids >= 0).cuda()
        torch.cuda.set_sync_debug_mode("error")   # no copy back to the host
        try:
            out = ragged_attention(q, kp, vp, plan=plan, **args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if out[~valid].any() or not torch.equal(
                out, ragged_attention(q, kp, vp, plan=plan, **args)):
            raise AssertionError(f"ragged_attn {label} {dtype}: padding not zero "
                                 f"or two calls differ")
        try:
            ragged_attention(q, kp, vp, **args)
        except ValueError:
            pass
        else:
            raise AssertionError("ragged_attn: a CUDA call without a plan ran")
        sdpa, sdpa_args, scatter = self.sdpa_yardstick(q, kp, vp, bt, row_ids, q_pos)
        want = ragged_attention_ref(q, kp, vp, **args)[valid].float()
        err = (scatter(sdpa(*sdpa_args))[valid].float() - want).abs().max().item()
        if err > TOL[dtype] * max(1.0, want.abs().max().item()):
            raise AssertionError(f"SDPA yardstick {label} {dtype}: error {err}")
        es = dtype.itemsize
        page_bytes = t * hkv * dh * es * 2                       # K and V
        kv_pages = sum(-(-n // t) for n in need.values())
        pad_pages = 1 if (row_ids < 0).any() else 0              # row 0's page 0
        flops = sum(4 * hq * dh * (int(p) + 1) for p in q_pos[row_ids >= 0])
        sets = cold_sets(q, kp, vp)
        lib_sets = cold_sets(*sdpa_args)
        warm_ms = time_ms(lambda: ragged_attention(q, kp, vp, plan=plan, **args))
        self.record("ragged_attn", f"{label} W={width} segs={len(segments)}", dtype,
                    cycle(lambda a, b, c: ragged_attention(a, b, c, plan=plan, **args), sets),
                    cycle(lambda a, b, c: ragged_attention_ref(a, b, c, **args), sets),
                    cycle(sdpa, lib_sets),
                    2 * q.numel() * es + (kv_pages + pad_pages) * page_bytes
                    + 3 * width * 4 + bt.nbytes, flops,
                    select=lambda t: t[valid],   # padding rows: the plain version's garbage
                    split=plan.splits, tiles=plan.tiles, kernel_l2_warm_ms=warm_ms,
                    copies=len(sets), library_err=err)

    @staticmethod
    def sdpa_yardstick(q, kp, vp, bt, row_ids, q_pos):
        """One ``F.scaled_dot_product_attention(..., enable_gqa=True)`` call
        with a boolean mask, on K/V already gathered per row and padded to
        the longest row (queries grouped by row, padded likewise).  Returns
        (attend, args, scatter): ``scatter(attend(*args))`` is [W, Hq, dh]
        at the valid positions; only ``attend`` is timed."""
        import torch.nn.functional as F
        t = kp.shape[1]
        rows = sorted(set(row_ids[row_ids >= 0].tolist()))
        lq = max(int((row_ids == r).sum()) for r in rows)
        lk = max(int(q_pos[row_ids == r].max()) + 1 for r in rows)
        w, hq, dh = q.shape
        hkv = kp.shape[2]
        qg = torch.zeros((len(rows), hq, lq, dh), dtype=q.dtype, device=q.device)
        kg = torch.zeros((len(rows), hkv, lk, dh), dtype=q.dtype, device=q.device)
        vg = torch.zeros_like(kg)
        mask = torch.zeros((len(rows), 1, lq, lk), dtype=torch.bool, device=q.device)
        mask[..., 0] = True                    # padded queries: no empty softmax
        where = []
        for i, r in enumerate(rows):
            idx = np.flatnonzero(row_ids == r)
            n_keys = int(q_pos[idx].max()) + 1
            pg = torch.from_numpy(bt[r, :-(-n_keys // t)].astype(np.int64)).cuda()
            kg[i, :, :n_keys] = kp[pg].reshape(-1, hkv, dh)[:n_keys].transpose(0, 1)
            vg[i, :, :n_keys] = vp[pg].reshape(-1, hkv, dh)[:n_keys].transpose(0, 1)
            qg[i, :, :len(idx)] = q[torch.from_numpy(idx).cuda()].transpose(0, 1)
            kv = torch.arange(lk, device=q.device)
            qp = torch.from_numpy(q_pos[idx].astype(np.int64)).cuda()
            mask[i, 0, :len(idx)] = kv[None, :] <= qp[:, None]
            where.append((i, torch.from_numpy(idx).cuda()))

        def attend(qq, kk, vv, mm):
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm,
                                                  enable_gqa=True)

        def scatter(o):
            full = torch.zeros((w, hq, dh), dtype=o.dtype, device=o.device)
            for i, idx in where:
                full[idx] = o[i, :, :len(idx)].transpose(0, 1)
            return full

        return attend, (qg, kg, vg, mask), scatter

    def run(self, ladder):
        """``ladder``: the bf16 engine's flat widths; the gate linear runs at
        each (at 8 and 512 in float32)."""
        from repro_torch.core.layout import make_layout
        e = self.rand((49152, 576), BF, 0.02)
        self.launch_floor()
        for dtype in (BF, TF):
            lay = make_layout("scalable", self.hw, dtype)
            m_r = lay.m_r
            dec, pre = 16 if dtype is BF else 8, 512
            for w in sorted(set(ladder) | {dec} if dtype is BF else {dec, pre}):
                self.mmt4d(dtype, w, 576, 1536, "silu",
                           "gate decode" if w == dec else f"gate W={w}")
            self.mmt4d(dtype, dec, 576, 576, None, "q/o decode")
            self.mmt4d(dtype, dec, 576, 192, None, "k/v decode")
            self.mmt4d(dtype, dec, 1536, 576, None, "down decode")
            self.mmt4d(dtype, 4, 576, 49152, None, "tied head")
            self.mmt4d_unpacked(dtype, dec, 576, 576, "q exit unpacked")
            self.mmt4d_unpacked(dtype, dec, 576, 192, "k/v exit unpacked")
            self.mmt4d_unpacked(dtype, 4, 576, 49152, "tied head unpacked")
            self.pack(dtype, self.rand((1, dec, 576), dtype), m_r, 128, "stream entry")
            self.pack(dtype, self.rand((1, pre, 576), dtype), m_r, 128, "O-linear input")
            self.pack(dtype, e.to(dtype), 128, 128, "tied head embed", cold=True)
            self.pack(dtype, self.rand((576, 1536), dtype).T, 128, 128, "prepack w^T")
            self.unpack(dtype, dec, 576, m_r, 128, "final stream decode")
            self.unpack(dtype, pre, 576, m_r, 128, "Q exit prefill")
            self.unpack(dtype, 4, 49152, m_r, 128, "logits")
            self.ragged(dtype, [(0, 300, 1), (1, 511, 1), (2, 95, 1), (3, 1000, 1)],
                        16, "decode rows")
            self.ragged(dtype, [(0, 1000, 1)], 16, "long decode row")
            self.ragged(dtype, [(0, 600, 1), (1, 64, 1), (2, 0, 300), (3, 128, 206)],
                        pre, "mixed prefill")


# the three serving step families: engine arguments at the f32 parity
# drain (seq_len 64) and at the full-width bf16 drain (seq_len 1024)
FAMILIES_F32 = {"flat": dict(chunk_tokens=32),
                "dense": dict(chunk_tokens=32, flat=False),
                "monolithic": {}}
FAMILIES_BF16 = {"flat": dict(chunk_tokens=128),
                 "dense": dict(chunk_tokens=128, flat=False),
                 "monolithic": {}}


class ReplayCheck:
    """Stands in for an engine's compiled step: passes every call through,
    and for the first ``shapes`` distinct input signatures of the drain
    (all replays of graphs captured at warmup) also runs the model's eager
    step method on the same inputs and state, and requires the replay's
    logits bit for bit on the valid rows (an inert row of the paged step
    attends over nothing: its logits are garbage in both).  Both calls
    write the same K/V to the same places, so the state they see is the
    same.  The eager call's launches are taken back out of the counts."""

    def __init__(self, step, shapes: int = 2):
        self.step, self.shapes, self.checked = step, shapes, []

    def __call__(self, params, caches, *args, plan=None):
        out, caches = self.step(params, caches, *args, plan=plan)
        sig = self.step.signature(args, plan)
        if len(self.checked) < self.shapes and sig not in self.checked:
            from repro_torch import kernels
            dev = self.step.model.device
            before = kernels.counters()
            extra = {} if plan is None else {"plan": plan.to(dev)}
            want, _ = self.step.fn(params, caches,
                                   *(None if a is None else a.to(dev)
                                     for a in args), **extra)
            after = kernels.counters()
            kernels.add_counts({k: after[k] - before[k] for k in after}, -1)
            valid = (args[3] > 0).to(dev) if self.step.kind == "paged" else \
                torch.ones(out.shape[0], dtype=torch.bool, device=dev)
            if not torch.equal(out[valid], want[valid]):
                err = (out[valid].float() - want[valid].float()).abs().max().item()
                raise AssertionError(f"{self.step.kind} step {sig}: the graph's "
                                     f"replay differs from the eager call "
                                     f"(max |diff| {err:.3e})")
            self.checked.append(sig)
        return out, caches


def attach_replay_check(eng) -> ReplayCheck:
    if eng.flat:
        eng._flat_step = check = ReplayCheck(eng._flat_step)
    else:
        eng._paged_step = check = ReplayCheck(eng._paged_step)
    return check


def count_model_calls(eng) -> list:
    """Wrap the engine's model call; returns the list each call's float32
    logits are appended to."""
    calls = []
    name = "_run_flat" if eng.flat else "_run_paged"
    run = getattr(eng, name)
    setattr(eng, name, lambda *a, **k: calls.append(run(*a, **k)) or calls[-1])
    return calls


def serve_f32(device, cfg, prompts, family):
    """Greedy drain at full width in float32 through one step family;
    returns tokens, the first model call's logits, each pick's top-2
    margin in pick order, and on the card the graphs captured at warmup
    and the shapes checked replay against eager."""
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, run, ShapeSpec("serve", 64, 4, "decode"), device=device)
    params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, device=device, max_slots=4, page_tokens=16,
                 **FAMILIES_F32[family])
    info = {}
    if device == "cuda":
        eng.warmup()
        info["captures"] = eng.stats()["compiles"]
        check = attach_replay_check(eng)
    calls, picks = count_model_calls(eng), []
    pick = eng._pick

    def recording_pick(row, greedy):
        top2 = np.sort(row)[-2:]
        picks.append((int(np.argmax(row)), float(top2[1] - top2[0])))
        return pick(row, greedy)

    eng._pick = recording_pick
    rids = [eng.add_request(p, 8) for p in prompts]
    fin = {r.rid: r.out_tokens for r in eng.drain()}
    if device == "cuda":
        if eng.stats()["compiles"] != info["captures"]:
            raise AssertionError(f"f32 {family} drain captured after warmup: "
                                 f"{info['captures']} -> {eng.stats()['compiles']}")
        info["replay_checked"] = len(check.checked)
    return [fin[r] for r in rids], calls[0], picks, info


def compare_f32(cfg, prompts, family) -> dict:
    """The f32 drain of one family on the card and on the CPU: identical
    greedy tokens, or the first differing pick with both top-2 margins."""
    t0 = time.perf_counter()
    cuda_toks, cuda_first, cuda_picks, info = serve_f32("cuda", cfg, prompts, family)
    cpu_toks, cpu_first, cpu_picks, _ = serve_f32("cpu", cfg, prompts, family)
    diff = float(np.abs(cuda_first - cpu_first).max())
    print(f"  {family}: first call max |logit diff| {diff:.3e}, graphs "
          f"{info['captures']}, replay = eager bit for bit at "
          f"{info['replay_checked']} shapes ({time.perf_counter() - t0:.1f} s)")
    for j, (a, b) in enumerate(zip(cuda_picks, cpu_picks)):
        if a[0] != b[0]:
            print(f"  {family} pick {j}: card {a[0]} (top-2 margin {a[1]:.3e}) "
                  f"vs cpu {b[0]} (top-2 margin {b[1]:.3e})")
            break
    if cuda_toks != cpu_toks:
        raise AssertionError(f"{family}: greedy tokens differ: card {cuda_toks} "
                             f"cpu {cpu_toks}")
    if info["replay_checked"] < 2:
        raise AssertionError(f"{family}: replay checked at "
                             f"{info['replay_checked']} shapes, not 2")
    return {"tokens": cuda_toks, "first_logit_diff": diff, **info}


def drain_bf16(cfg, family, prompts, eng=None) -> dict:
    """The bf16 drain of one family at full width: warmup (its graphs,
    seconds and the device memory it reserved), then the requests with
    every wrapper count set to 0 just before and read just after; every
    request finishes, no graph is captured during the drain, replay equals
    eager at two shapes, and each model call launches the expected
    kernels."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    if eng is None:
        model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                            device="cuda")
        eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                     device="cuda", max_slots=4, page_tokens=16,
                     **FAMILIES_BF16[family])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    graphs = eng.stats()["compiles"]
    # what warmup keeps: the graphs' memory pool (which empty_cache cannot
    # release while the graphs live) and their static inputs and outputs
    torch.cuda.empty_cache()
    warm_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    check = attach_replay_check(eng)
    calls = count_model_calls(eng)
    rids = [eng.add_request(p, 32) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    finished = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    unpacked = kernels.wrappers()["mmt4d"].unpacked_stores
    st = eng.stats()
    n = len(calls)
    ntok = sum(len(r.out_tokens) for r in finished)
    print(f"  {family}: warmup {warm_s:.3f} s, {sum(graphs.values())} graphs "
          f"{graphs}, {warm_mib:.1f} MiB kept by warmup (graph pool and buffers); {st['steps']} steps, "
          f"{n} model calls, {wall:.3f} s wall, {1e3 * wall / st['steps']:.3f} ms "
          f"per step, {ntok} tokens, {ntok / wall:.1f} generated tokens/s")
    print(f"  {family}: launches {launches}, per model call "
          f"{ {k: v / n for k, v in launches.items()} }, mmt4d unpacked stores "
          f"{unpacked} ({unpacked / n} per call); replay = eager bit for bit "
          f"at {len(check.checked)} shapes")
    if sorted(r.rid for r in finished) != sorted(rids) \
            or any(r.finish_reason != "length" or len(r.out_tokens) != 32
                   for r in finished):
        raise AssertionError(f"{family}: not every request finished: "
                             f"{[(r.rid, r.finish_reason) for r in finished]}")
    if eng.pool.num_used != 0 or not all(np.isfinite(c).all() for c in calls):
        raise AssertionError(f"{family}: pool used {eng.pool.num_used}, or "
                             f"non-finite logits")
    if st["compiles"] != graphs:
        raise AssertionError(f"{family}: captured during the drain: {graphs} -> "
                             f"{st['compiles']}")
    if len(check.checked) < 2:
        raise AssertionError(f"{family}: replay checked at {len(check.checked)} "
                             f"shapes, not 2")
    expected = EXPECTED_PER_STEP if eng.flat else EXPECTED_PER_PAGED_CALL
    for k, per in expected.items():
        if launches[k] != per * n:
            raise AssertionError(f"{family} {k}: {launches[k]} launches over {n} "
                                 f"model calls, expected {per} per call")
    if unpacked != EXPECTED_UNPACKED_PER_STEP * n:
        raise AssertionError(f"{family} mmt4d: {unpacked} unpacked stores over "
                             f"{n} calls, expected {EXPECTED_UNPACKED_PER_STEP} "
                             f"per call")
    return {"family": family, "steps": st["steps"], "model_calls": n,
            "wall_s": wall, "ms_per_step": 1e3 * wall / st["steps"],
            "tokens": ntok, "tokens_per_s": ntok / wall, "warmup_s": warm_s,
            "graphs": graphs, "warmup_kept_mib": warm_mib,
            "launches": launches, "unpacked_stores": unpacked,
            "replay_checked": len(check.checked), "stats": st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.configs import RunConfig, ShapeSpec, get_config
    from repro_torch.core.hardware import query
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s, "
          f"sm_90a, one nvcc per source)")

    hw = query("cuda")
    print(f"hardware: {hw.device_name}, {hw.sm_count} SMs, HBM {hw.hbm_bw / 1e12:.2f} TB/s, "
          f"bf16 {hw.flops_bf16 / 1e12:.0f} TFLOP/s, f32 {hw.flops_f32 / 1e12:.0f} TFLOP/s")
    cfg = get_config("smollm2-135m")
    model = build_model(cfg, RunConfig(), ShapeSpec("serve", 1024, 4, "decode"),
                        device="cuda")
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)), device="cuda",
                 max_slots=4, chunk_tokens=128, page_tokens=16)
    print("kernels vs plain versions on the card (mmt4d and the tied-head pack "
          "L2-cold):")
    checks = KernelChecks(hw, torch.Generator(device="cuda").manual_seed(0))
    checks.run(eng._flat_shapes())

    print("end to end, float32: 4 requests x 8 new tokens, card vs CPU plain "
          "path, each step family (card: graphs captured at warmup)")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in rng.integers(5, 25, 4)]
    f32 = {fam: compare_f32(cfg, prompts, fam) for fam in FAMILIES_F32}
    if len({str(r["tokens"]) for r in f32.values()}) != 1:
        raise AssertionError(f"the families' f32 tokens differ: "
                             f"{ {k: r['tokens'] for k, r in f32.items()} }")
    print(f"  greedy tokens identical, card = CPU, flat = dense = monolithic: "
          f"{f32['flat']['tokens']}")

    print("end to end, bfloat16: Engine(max_slots=4, page_tokens=16), seq_len "
          "1024, 8 requests x 32 new tokens, each family (flat and dense: "
          f"chunk_tokens=128) ({card})")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    print(f"  prompts {lens.tolist()}")
    e2e = {fam: drain_bf16(cfg, fam, prompts, eng if fam == "flat" else None)
           for fam in FAMILIES_BF16}
    launches, steps = e2e["flat"]["launches"], e2e["flat"]["steps"]
    unpacked = e2e["flat"]["unpacked_stores"]

    kernel_rows = []
    for k, cases in checks.cases.items():
        rep = next(c for c in cases if c["dtype"] == "bfloat16"
                   and c["shape"].startswith(REPRESENTATIVE[k]))
        src, replaces = SOURCES[k]
        kernel_rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "launches_per_step": launches[k] / steps,
            "launches_by_path": {f: r["launches"][k] for f, r in e2e.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["kernel_ms"], "kernel_ms": rep["kernel_ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "split": rep.get("split"), "shape": rep["shape"],
            "dtype": rep["dtype"], "card": card, "cases": cases,
            **({"unpacked_stores": unpacked} if k == "mmt4d" else {}),
            **({"floor_ms": checks.floor_ms, "floor_wait_ms": checks.floor_wait_ms}
               if k == "unpack" else {})})
    result = {"kernels": kernel_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**result, "card": card, "e2e_bf16": e2e, "e2e_f32": f32,
                       "total_s": time.perf_counter() - t_start}, f, indent=1,
                      default=str)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
