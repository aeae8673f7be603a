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
  6. sampled picks: phase 4's drains sampled (seed 11, per-request
     temperatures), card vs CPU in each family, equal apart from picks
     whose perturbed top-2 margin is below F32_MARGIN (counted); then a
     sampled bf16 drain of phase 5's requests on its warmed engines, the
     families held to each other under BF16_MARGIN;
  7. two warmed engines of one family over one model (each family): the
     second warmup leaves the model's trace_counts where they were, each
     engine counts its own captures, and the device memory of the second
     comes back once it is dropped;
  8. prefix cache and speculative decode at full width, f32 then bf16,
     each family: baseline, prefix_cache=True, and spec_tokens=2 with the
     n-gram drafter and with a draft model (SmolLM2-135M cut to 2 layers),
     each over the spec trace and (baseline and cache) the shared-prefix
     trace, greedy and sampled; picks held to the baseline's under the
     dtype's margin; prefill tokens with the cache at most half those
     without, the refcount ledger balanced after clear(), acceptance and
     rollback pages printed, no capture after warmup (the draft model's
     included), every kernel of the path launched in every drain, and
     tokens/s and ms per step of each drain;
  9. resilience under chaos at full width, f32 then bf16, for the flat,
     flat with n-gram speculation (k = 2) and the prefix cache, and dense
     chunked families, each on one warmed engine (queue_limit=6; in f32
     the runtime sanitizer checks every model call): five requests on a
     step clock drained clean, then under each fault plan of
     scripts/chaos_smoke.py (OOM spikes, a drafter burst, a NaN row, page
     copier failures), then a lifecycle drain (a cancel of a queued, a
     prefilling and a decoding request, a queue_limit shed, a deadline and
     a max_queue_s expiry) and a watchdog trip caught as StallError; every
     pick held to the clean drain's (f32 exactly, bf16 below BF16_MARGIN,
     parted picks counted), the allocator audit clean with every used page
     a cached one, no trace or capture after warmup, the pools never
     moved, every kernel of the path launched, and each drain's ms per
     step;
 10. the kernels JSON line (launches from the flat drain, the main path;
     each other path's beside them), then the result line.

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
# two runs of one drain may pick differently only where a pick's (perturbed,
# for a sampled pick) top-2 logit margin is below this: float32 logits of
# the card and the CPU, or of two batch layouts, differ by about 1e-6; the
# bfloat16 logits of two layouts by about a bfloat16 ulp of the logits
F32_MARGIN = 1e-5
BF16_MARGIN = 0.0625
# the sampled drains' per-request temperatures, in turn (0 picks greedily)
TEMPERATURES = (1.0, 0.7, 1.3, 0.0)


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

    def __call__(self, params, caches, *args, plan=None, graphs=None):
        out, caches = self.step(params, caches, *args, plan=plan, graphs=graphs)
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


class PickRecorder:
    """Wraps an engine's pick: records every pick as (rid, position) ->
    (token, top-2 margin of the row it was picked from: the logits, or for
    a sampled pick the logits over the temperature plus the Gumbel noise),
    and the host seconds the recording itself took."""

    def __init__(self, eng):
        from repro_torch.serving import sampling
        self.sampling, self.pick, self.picks, self.seconds = sampling, eng._pick, {}, 0.0
        eng._pick = self

    def __call__(self, row, req, greedy, seed):
        tok = self.pick(row, req, greedy, seed)
        t0 = time.perf_counter()
        z = row
        if not greedy and req.temperature > 0.0:
            s = seed if req.seed is None else req.seed
            key = self.sampling.pick_key(s, req.rid, len(req.out_tokens))
            z = (row / np.float32(req.temperature) if req.temperature != 1.0 else row) \
                + self.sampling.gumbel(key, row.shape[0])
        top2 = np.partition(z, -2)[-2:]
        self.picks[(req.rid, len(req.out_tokens))] = (tok, float(top2[1] - top2[0]))
        self.seconds += time.perf_counter() - t0
        return tok


def compare_picks(a: dict, b: dict, tol: float, label: str) -> dict:
    """Two runs' picks, request by request in position order: equal, or the
    first difference of a request at a pick whose top-2 margin (in either
    run) is below ``tol``, after which that request is compared no
    further (its streams have parted).  Any other difference raises.
    Returns the counts: picks compared, picks below ``tol`` in either run,
    requests that parted and the largest margin at a parting."""
    out = {"picks": 0, "low_margin_picks": 0, "parted": 0, "parted_margin": 0.0}
    for rid in sorted({r for r, _ in a} | {r for r, _ in b}):
        pos = sorted({p for r, p in a if r == rid} | {p for r, p in b if r == rid})
        for p in pos:
            ta, ma = a.get((rid, p), (None, 0.0))
            tb, mb = b.get((rid, p), (None, 0.0))
            out["picks"] += 1
            out["low_margin_picks"] += int(min(ma, mb) < tol)
            if ta != tb:
                if not min(ma, mb) < tol:
                    raise AssertionError(
                        f"{label}: rid {rid} position {p}: {ta} vs {tb} at "
                        f"top-2 margins {ma:.3e} / {mb:.3e} (tolerance {tol:g})")
                out["parted"] += 1
                out["parted_margin"] = max(out["parted_margin"], min(ma, mb))
                print(f"  {label}: rid {rid} parts at position {p} ({ta} vs {tb}, "
                      f"top-2 margins {ma:.3e} / {mb:.3e})")
                break
    print(f"  {label}: {out['picks']} picks compared, "
          f"{out['low_margin_picks']} with a top-2 margin below {tol:g}, "
          f"{out['parted']} requests parted")
    return out


def serve_f32(device, cfg, prompts, family, greedy=True):
    """A drain at full width in float32 through one step family, greedy or
    sampled (seed 11; the requests' temperatures 1.0, 0.7, 1.3 and 0 in
    turn); returns tokens, the first model call's logits, each pick's
    (rid, position) -> (token, perturbed top-2 margin), and on the card the
    graphs captured at warmup and the shapes checked replay against
    eager."""
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
        info["captures"] = eng.stats()["captures"]
        check = attach_replay_check(eng)
    calls, picks = count_model_calls(eng), PickRecorder(eng)
    rids = [eng.add_request(p, 8, temperature=TEMPERATURES[i % 4])
            for i, p in enumerate(prompts)]
    fin = {r.rid: r.out_tokens for r in eng.drain(greedy=greedy, seed=11)}
    if device == "cuda":
        if eng.stats()["captures"] != info["captures"]:
            raise AssertionError(f"f32 {family} drain captured after warmup: "
                                 f"{info['captures']} -> {eng.stats()['captures']}")
        info["replay_checked"] = len(check.checked)
    return [fin[r] for r in rids], calls[0], picks.picks, info


def compare_f32(cfg, prompts, family, greedy=True) -> dict:
    """The f32 drain of one family on the card and on the CPU.  Greedy:
    identical tokens (the first differing pick, with both top-2 margins,
    is printed before failing).  Sampled: identical tokens apart from a
    pick whose perturbed top-2 margin is below F32_MARGIN, whose request is
    compared no further; the count of such picks is printed."""
    t0 = time.perf_counter()
    cuda_toks, cuda_first, cuda_picks, info = serve_f32("cuda", cfg, prompts,
                                                        family, greedy)
    cpu_toks, cpu_first, cpu_picks, _ = serve_f32("cpu", cfg, prompts, family,
                                                  greedy)
    diff = float(np.abs(cuda_first - cpu_first).max())
    mode = "greedy" if greedy else "sampled"
    print(f"  {family} {mode}: first call max |logit diff| {diff:.3e}, graphs "
          f"{info['captures']}, replay = eager bit for bit at "
          f"{info['replay_checked']} shapes ({time.perf_counter() - t0:.1f} s)")
    cmp = compare_picks(cuda_picks, cpu_picks, 0.0 if greedy else F32_MARGIN,
                        f"f32 {mode} {family} card vs cpu")
    if greedy and cuda_toks != cpu_toks:
        raise AssertionError(f"{family}: greedy tokens differ: card {cuda_toks} "
                             f"cpu {cpu_toks}")
    if info["replay_checked"] < 2:
        raise AssertionError(f"{family}: replay checked at "
                             f"{info['replay_checked']} shapes, not 2")
    return {"tokens": cuda_toks, "first_logit_diff": diff, **cmp, **info}


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
    delattr(eng, "_run_flat" if eng.flat else "_run_paged")   # the counter
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
    if st["compiles"] != graphs or st["captures"] != graphs:
        raise AssertionError(f"{family}: captured during the drain: {graphs} -> "
                             f"{st['compiles']}, {st['captures']}")
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
            "replay_checked": len(check.checked), "stats": st, "engine": eng}


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def check_path_launches(label, launches, flat) -> None:
    """Every kernel of the path ran in the drain just read: all four in
    the flat family, all but ragged_attn in the paged ones (which attend
    through PyTorch and must not launch it)."""
    for k, n in launches.items():
        if (n == 0) != (k == "ragged_attn" and not flat):
            raise AssertionError(f"{label}: {k} launched {n} times")


def timed_drain(eng, reqs, greedy, seed, label, staggered=False) -> dict:
    """Queue ``reqs`` ((prompt, max_new, temperature) each) and drain them,
    recording every pick, with the wrapper counts set to 0 just before and
    read just after; checks that the drain captured no graph (the engine's
    and its draft model's) and that every kernel of the path ran.
    ``staggered``: request i arrives at 2i on a clock that advances one
    per step, so admissions see earlier requests' cached pages."""
    from repro_torch import kernels
    rec = eng._pick if isinstance(eng._pick, PickRecorder) else PickRecorder(eng)
    rec.picks, rec.seconds = {}, 0.0
    st0 = eng.stats()
    rids = [eng.add_request(p, n, temperature=t,
                            arrival=float(2 * i) if staggered else 0.0)
            for i, (p, n, t) in enumerate(reqs)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin, clock = [], 0.0
    while eng.scheduler.has_work:
        fin.extend(eng.step(now=clock if staggered else None, greedy=greedy,
                            seed=seed))
        clock += 1.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    if sorted(r.rid for r in fin) != sorted(rids) or any(
            r.finish_reason != "length" for r in fin):
        raise AssertionError(f"{label}: not every request finished")
    if st["captures"] != st0["captures"] or (
            "speculative" in st and st["speculative"]["drafter"].get("captures")
            != st0["speculative"]["drafter"].get("captures")):
        raise AssertionError(f"{label}: captured during the drain")
    check_path_launches(label, launches, eng.flat)
    steps = st["steps"] - st0["steps"]
    ntok = sum(len(r.out_tokens) for r in fin)
    host = wall - rec.seconds
    out = {"wall_s": wall, "recording_s": rec.seconds, "steps": steps,
           "tokens": ntok, "tokens_per_s": ntok / host,
           "ms_per_step": 1e3 * host / max(1, steps),
           "prefill_tokens": st["prefill_tokens"] - st0["prefill_tokens"],
           "launches": launches, "picks": dict(rec.picks)}
    extra = ""
    if "speculative" in st:
        sp, sp0 = st["speculative"], st0["speculative"]
        drafted = sp["drafted"] - sp0["drafted"]
        out.update(drafted=drafted, accepted=sp["accepted"] - sp0["accepted"],
                   rollback_pages=sp["rollback_pages"] - sp0["rollback_pages"])
        out["acceptance_rate"] = out["accepted"] / max(1, drafted)
        extra = (f", acceptance {out['acceptance_rate']:.3f} ({out['accepted']}/"
                 f"{drafted}), rollback pages {out['rollback_pages']}")
    print(f"  {label}: {steps} steps, {ntok} tokens, {wall:.3f} s wall "
          f"({rec.seconds:.3f} s of it recording picks), "
          f"{out['ms_per_step']:.3f} ms per step, {out['tokens_per_s']:.1f} "
          f"generated tokens/s, prefill tokens {out['prefill_tokens']}{extra}")
    return out


def prefix_trace(vocab, n=12, sys_tokens=256, seed=0):
    """The shared-system-prompt trace of the JAX package's serving
    benchmark (``make_prefix_trace``), drawn with numpy: one system prompt
    of ``sys_tokens`` plus a 2-6-token suffix per request, 3-16 new
    tokens; the temperatures cycle through TEMPERATURES.  The last request
    is the bare system prompt, whole pages all cached by then: its prefill
    restarts inside the last shared page, which is copied first."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, vocab, sys_tokens)
    reqs = [(np.concatenate([sysp, rng.integers(0, vocab, int(rng.integers(2, 7)))]),
             int(rng.integers(3, 17)), TEMPERATURES[i % 4]) for i in range(n - 1)]
    return reqs + [(sysp, 8, TEMPERATURES[(n - 1) % 4])]


def spec_trace(vocab, n=8, seed=0):
    """The speculative trace of the JAX package's serving benchmark
    (``make_spec_trace``), drawn with numpy: a 4-token motif tiled to at
    most 16 tokens per prompt, 16-32 new tokens."""
    rng = np.random.default_rng(seed)
    return [(np.tile(rng.integers(0, vocab, 4), int(rng.integers(2, 5)))[:16],
             int(rng.integers(16, 33)), TEMPERATURES[i % 4]) for i in range(n)]


def serve_variants(cfg, dtype, families) -> dict:
    """Prefix cache and speculation at full width in one dtype, each
    family: engines over one model (signatures per model, graphs per
    engine), each warmed, then the spec trace greedy and sampled and (the
    baseline and the cache) the prefix trace greedy and sampled, in that
    order on every engine, so the request ids, and the sampled keys, match.
    Variants: "off" (the baseline), "cache" (prefix_cache=True), "ngram"
    and "draft" (spec_tokens=2 with NgramDrafter and with
    DraftModelDrafter over SmolLM2-135M cut to 2 layers).  Each variant's
    picks are held to the baseline's under the dtype's margin rule."""
    import dataclasses
    import gc
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.speculative import DraftModelDrafter
    name = str(dtype)[6:]
    run = RunConfig(param_dtype=name, compute_dtype=name)
    shape = ShapeSpec("serve", 1024, 4, "decode")
    model = build_model(cfg, run, shape, device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    dmodel = build_model(dataclasses.replace(cfg, n_layers=2), run, shape,
                         device="cuda")
    dparams = dmodel.init(torch.Generator().manual_seed(7))
    tol = F32_MARGIN if dtype is TF else BF16_MARGIN
    traces = {"spec": spec_trace(cfg.vocab), "prefix": prefix_trace(cfg.vocab)}
    out = {}
    for family in families:
        base = {}
        for variant in ("off", "cache", "ngram", "draft"):
            kw = dict(FAMILIES_BF16[family])
            if variant == "cache":
                kw["prefix_cache"] = True
            elif variant != "off":
                kw["spec_tokens"] = 2
                if variant == "draft":
                    kw["drafter"] = DraftModelDrafter(dmodel, dparams)
            eng = Engine(model, params, device="cuda", max_slots=4,
                         page_tokens=16, **kw)
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pools = {id(t): t.data_ptr() for t in leaves(eng.caches)}
            if variant == "cache":
                # the page copy: in place, and nothing read back to the host
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.pool.page_copier(0, 0)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            st = eng.stats()
            dcap = st.get("speculative", {}).get("drafter", {}).get("captures")
            print(f"  {name} {family} {variant}: warmup {warm_s:.3f} s, captures "
                  f"{st['captures']}" + (f", draft model {dcap}" if dcap else ""))
            runs = {}
            for trace in ("spec", "prefix") if variant in ("off", "cache") else ("spec",):
                for greedy in (True, False):
                    mode = "greedy" if greedy else "sampled"
                    label = f"{name} {family} {variant} {trace} {mode}"
                    r = timed_drain(eng, traces[trace], greedy, 5, label,
                                    staggered=trace == "prefix")
                    if variant == "off":
                        base[f"{trace} {mode}"] = r
                    else:
                        r["vs_off"] = compare_picks(base[f"{trace} {mode}"]["picks"],
                                                    r["picks"], tol,
                                                    f"{label} vs off")
                    runs[f"{trace} {mode}"] = r
            if {id(t): t.data_ptr() for t in leaves(eng.caches)} != pools:
                raise AssertionError(f"{name} {family} {variant}: a KV pool "
                                     f"was reallocated or rebound")
            if variant == "cache":
                off_pf = base["prefix greedy"]["prefill_tokens"]
                on_pf = runs["prefix greedy"]["prefill_tokens"]
                pc = eng.stats()["prefix_cache"]
                eng.prefix_cache.clear()
                ledger, pool = eng.pool.ledger(), eng.pool
                balance = pool.total_allocs + pool.total_shares - pool.total_frees
                print(f"  {name} {family} cache: prefill tokens {on_pf} with the "
                      f"cache, {off_pf} without ({on_pf / off_pf:.3f}x); hits "
                      f"{pc['hits']} of {pc['lookups']} lookups, {pc['hit_tokens']} "
                      f"hit tokens, {pc['cow_copies']} copy-on-write copies; after "
                      f"clear(): {len(ledger['refs'])} live pages, "
                      f"{len(ledger['free'])} free of {pool.usable_pages}, "
                      f"allocs + shares - frees = {balance}")
                if on_pf > 0.5 * off_pf or ledger["refs"] or balance \
                        or len(ledger["free"]) != pool.usable_pages \
                        or pc["cow_copies"] < 2:
                    raise AssertionError(f"{name} {family} cache: prefill "
                                         f"{on_pf} vs {off_pf}, or the pool "
                                         f"does not balance")
            out[(family, variant)] = {"warmup_s": warm_s, "captures": st["captures"],
                                      "draft_captures": dcap, "runs": runs,
                                      **({"prefix_cache": pc} if variant == "cache"
                                         else {})}
            del eng
            gc.collect()
    for r in out.values():
        for run_ in r["runs"].values():
            run_.pop("picks", None)
    return out


def c1_two_engines(bf16_engines) -> dict:
    """Two warmed engines of one family over one model: the second warmup
    leaves the model's trace_counts where they were, each engine counts
    its own captures, and once the second is dropped the device memory it
    took (its graphs, their static buffers and pool, its prepacked
    weights and KV pools) comes back."""
    import gc
    from repro_torch.serving.engine import Engine
    out = {}
    for family, first in bf16_engines.items():
        model = first.model
        counts = dict(model.trace_counts)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        second = Engine(model, model.init(torch.Generator().manual_seed(1)),
                        device="cuda", max_slots=4, page_tokens=16,
                        **FAMILIES_BF16[family])
        second.warmup()
        torch.cuda.synchronize()
        alloc1 = torch.cuda.memory_allocated()
        caps = (first.stats()["captures"], second.stats()["captures"])
        after = dict(model.trace_counts)
        del second
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc2, res2 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        print(f"  {family}: trace_counts {counts} -> {after} at the second "
              f"warmup; captures {caps[0]} and {caps[1]}; allocated "
              f"{alloc0 / 2**20:.1f} -> {alloc1 / 2**20:.1f} -> "
              f"{alloc2 / 2**20:.1f} MiB, reserved {res0 / 2**20:.1f} -> "
              f"{res2 / 2**20:.1f} MiB after the second is dropped")
        if after != counts or caps[0] != caps[1] or caps[0] != counts \
                or alloc2 != alloc0 or res2 > res0:
            raise AssertionError(f"C1 {family}: counts {counts} -> {after}, "
                                 f"captures {caps}, allocated {alloc0} -> "
                                 f"{alloc2}, reserved {res0} -> {res2}")
        out[family] = {"trace_counts": counts, "captures": caps[1],
                       "second_engine_mib": (alloc1 - alloc0) / 2**20,
                       "allocated_back": alloc2 == alloc0}
    return out


# the chaos phase: scripts/chaos_smoke.py's fault plans, and the families
# the resilience layer runs through (flat, flat with n-gram speculation
# and the prefix cache, dense chunked)
CHAOS_PLANS = {
    "oom-spike": [(0, "oom"), (1, "oom"), (2, "oom")],
    "drafter-burst": [(s, "drafter") for s in (1, 2, 3, 5, 7)],
    "nan-logits": [(3, "nan")],
    "copier-failure": [(1, "copier"), (3, "copier")],
}
CHAOS_FAMILIES = {"flat": dict(chunk_tokens=128),
                  "flat-spec-cache": dict(chunk_tokens=128, spec_tokens=2,
                                          prefix_cache=True),
                  "dense": dict(chunk_tokens=128, flat=False)}


def chaos_trace(vocab, seed=5):
    """Five requests ((prompt, max_new, arrival) each) on a clock that
    advances one per step: a 48-token prompt A, a 23-token one, A again at
    1 and at 3 (with the prefix cache, A's three pages are cached by then:
    the prefill restarts inside the last one, which is copied first), and
    a 57-token one at 4."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, vocab, n) for n in (48, 23, 57))
    return [(a, 12, 0.0), (b, 16, 0.0), (a, 8, 1.0), (a, 10, 3.0), (c, 10, 4.0)]


def chaos_drain(eng, adds, plan=None, hook=None) -> dict:
    """Queue ``adds`` ((index, prompt, max_new, add_request keywords) each)
    and step on a synthetic clock (step i at now = i) under ``plan`` until
    every request, shed and cancelled ones included, is delivered;
    ``hook(i, rid_of_index)`` runs after step i.  The wrapper counts are
    set to 0 just before and read just after.  Returns each index's
    (tokens, reason), its picks keyed (index, position), steps, wall and
    launches."""
    import contextlib
    from repro_torch import kernels
    rec = eng._pick if isinstance(eng._pick, PickRecorder) else PickRecorder(eng)
    rec.picks = {}
    steps0 = eng.stats()["steps"]
    index = {eng.add_request(p, n, **kw): i for i, p, n, kw in adds}
    rid_of = {i: r for r, i in index.items()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fin, clock = [], 0
    with plan.on(eng) if plan is not None else contextlib.nullcontext():
        while eng.scheduler.has_work or eng._finished_oob:
            fin.extend(eng.step(now=float(clock)))
            if hook is not None:
                hook(clock, rid_of)
            clock += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    fin.extend(eng.drain())      # no step left: ends the drain's auto-disable
    if sorted(r.rid for r in fin) != sorted(index):
        raise AssertionError(f"requests lost: {sorted(index)} added, "
                             f"{sorted(r.rid for r in fin)} delivered")
    steps = eng.stats()["steps"] - steps0
    return {"out": {index[r.rid]: (list(r.out_tokens), r.finish_reason) for r in fin},
            "picks": {(index[rid], pos): v for (rid, pos), v in rec.picks.items()},
            "steps": steps, "wall_s": wall, "ms_per_step": 1e3 * wall / max(1, steps),
            "launches": launches}


def chaos_check(eng, label, run, clean, tol, baseline) -> dict:
    """A drain held to the contract: each request the clean drain also
    served gives its picks (float32: exactly; bfloat16: parting only below
    a top-2 margin of ``tol``), a survivor all of its tokens; the
    allocator audits clean with every used page a prefix-cache page; the
    model traced and the engine captured nothing since warmup; every
    kernel of the path ran.  Prints the drain's line."""
    import collections
    from repro_torch.analysis.aliasing import check_pool_consistency
    served = {i for i in run["out"] if i in clean["out"]}
    picks = {k: v for k, v in run["picks"].items() if k[0] in served}
    want = {k: v for k, v in clean["picks"].items()
            if k in picks or (k[0] in served and run["out"][k[0]][1] == "length")}
    cmp = compare_picks(want, picks, tol, label)
    for i in served:
        toks, reason = run["out"][i]
        if reason in ("length", "eos") and tol == 0.0 and \
                (toks, reason) != clean["out"][i]:
            raise AssertionError(f"{label}: survivor {i} {toks} != clean "
                                 f"{clean['out'][i]}")
    findings = check_pool_consistency(eng, label)
    cached = (len(set(eng.prefix_cache.pages()))
              if eng.prefix_cache is not None else 0)
    live = sum(len(s.pages) for s in eng.pool.sequences())
    st = eng.stats()
    if findings or eng.pool.num_used != cached or live:
        raise AssertionError(f"{label}: allocator {[f.format() for f in findings]}, "
                             f"used {eng.pool.num_used}, cached {cached}, live {live}")
    if dict(eng.model.trace_counts) != baseline["traces"] \
            or st["captures"] != baseline["captures"]:
        raise AssertionError(f"{label}: traced or captured after warmup: "
                             f"{baseline} -> {dict(eng.model.trace_counts)}, "
                             f"{st['captures']}")
    check_path_launches(label, run["launches"], eng.flat)
    reasons = dict(collections.Counter(r for _, r in run["out"].values()))
    print(f"  {label}: {run['steps']} steps, {run['ms_per_step']:.3f} ms per step, "
          f"finish reasons {reasons}, audit clean, used pages {eng.pool.num_used} "
          f"= cached {cached}, traces and captures as at warmup")
    return {"reasons": reasons, **cmp, "steps": run["steps"],
            "ms_per_step": run["ms_per_step"], "wall_s": run["wall_s"],
            "launches": run["launches"]}


def chaos_phase(cfg, dtype) -> dict:
    """Resilience under chaos at full width in one dtype, each of
    CHAOS_FAMILIES on one warmed engine (queue_limit=6; in float32 the
    runtime sanitizer on every call): the clean drain of chaos_trace, the
    same under each of CHAOS_PLANS, then a lifecycle drain (a 300-token
    request cancelled mid-prefill, A cancelled decoding, one cancelled
    while queued, one shed at the queue limit, a deadline and a
    max_queue_s expiry), then a watchdog trip (every page held elsewhere:
    nothing can be admitted) caught as StallError and the drain resumed.
    The prefix cache is cleared between drains, so each starts cold.  The
    pools never move."""
    import gc
    from repro_torch.analysis.sanitize import install
    from repro_torch.configs import RunConfig, ShapeSpec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, StallError
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    from repro_torch.serving.kv_cache import SequencePages
    name = str(dtype)[6:]
    model = build_model(cfg, RunConfig(param_dtype=name, compute_dtype=name),
                        ShapeSpec("serve", 1024, 4, "decode"), device="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    tol = 0.0 if dtype is TF else BF16_MARGIN
    trace = chaos_trace(cfg.vocab)
    adds = [(i, p, n, {"arrival": a}) for i, (p, n, a) in enumerate(trace)]
    out = {}
    for family, kw in CHAOS_FAMILIES.items():
        eng = Engine(model, params, device="cuda", max_slots=4, page_tokens=16,
                     queue_limit=6, **kw)
        san = install(eng) if dtype is TF else None
        eng.warmup()
        torch.cuda.synchronize()
        baseline = {"traces": dict(model.trace_counts),
                    "captures": eng.stats()["captures"]}
        pools = {id(t): t.data_ptr() for t in leaves(eng.caches)}
        res = {}

        def cold():
            if eng.prefix_cache is not None:
                eng.prefix_cache.clear()

        clean = chaos_drain(eng, adds)
        if any(r != "length" for _, r in clean["out"].values()):
            raise AssertionError(f"{name} {family}: clean drain {clean['out']}")
        res["clean"] = chaos_check(eng, f"{name} {family} clean", clean, clean, tol,
                                   baseline)
        cold()
        for plan_name, events in CHAOS_PLANS.items():
            plan = FaultPlan([FaultEvent(s, k) for s, k in events])
            run = chaos_drain(eng, adds, plan)
            label = f"{name} {family} {plan_name}"
            res[plan_name] = chaos_check(eng, label, run, clean, tol, baseline)
            res[plan_name]["fired"] = dict(plan.fired)
            res[plan_name]["resilience"] = eng.stats()["resilience"]
            print(f"    fired {plan.fired}")
            cold()
        # the lifecycle drain: indices 0, 1, 4 are the trace's requests
        a, b, c = trace[0][0], trace[1][0], trace[4][0]
        long = np.random.default_rng(9).integers(0, cfg.vocab, 300)
        life = [(5, long, 8, {}), (0, a, 12, {}), (1, b, 16, {"deadline_s": 4.0}),
                (4, c, 10, {}), (6, a, 8, {"max_queue_s": 1.0}), (7, a, 8, {}),
                (8, b, 8, {})]
        states = {}

        def hook(i, rid_of):
            running = {r.rid: r.status for r in eng.scheduler.running.values()}
            if i == 0:
                states["cancelled queued"] = eng.cancel(rid_of[7])
                states["prefilling"] = running.get(rid_of[5])
                states["cancelled prefilling"] = eng.cancel(rid_of[5])
            elif i == 1:
                states["decoding"] = running.get(rid_of[0])
                states["cancelled decoding"] = eng.cancel(rid_of[0])

        before = eng.stats()["resilience"]
        run = chaos_drain(eng, life, hook=hook)
        after = eng.stats()["resilience"]
        delta = {k: after[k] - before[k] for k in ("sheds", "cancels", "timeouts",
                                                   "quarantines")}
        label = f"{name} {family} lifecycle"
        res["lifecycle"] = chaos_check(eng, label, run, clean, tol, baseline)
        res["lifecycle"]["counters"] = delta
        want = {5: "cancelled", 0: "cancelled", 1: "timeout", 4: "length",
                6: "timeout", 7: "cancelled", 8: "rejected"}
        got = {i: r for i, (_, r) in run["out"].items()}
        print(f"    states at cancel {states}, counters {delta}")
        if got != want or delta != {"sheds": 1, "cancels": 3, "timeouts": 2,
                                    "quarantines": 0} \
                or states != {"cancelled queued": True, "prefilling": "prefilling",
                              "cancelled prefilling": True, "decoding": "running",
                              "cancelled decoding": True}:
            raise AssertionError(f"{label}: reasons {got}, counters {delta}, "
                                 f"states {states}")
        cold()
        # the watchdog: a holder outside the engine takes every free page,
        # so nothing can be admitted; once it lets go the drain resumes
        hog = SequencePages(eng.pool)
        hog.ensure(eng.pool.num_free * eng.pool.page_tokens)
        trips = eng.stats()["resilience"]["watchdog_trips"]

        def wedge(i, rid_of):
            if i == 0:
                try:
                    eng.drain()
                except StallError as e:
                    states["stall"] = str(e)
                hog.release()

        run = chaos_drain(eng, [(1, b, 16, {})], hook=wedge)
        res["watchdog"] = chaos_check(eng, f"{name} {family} watchdog", run, clean,
                                      tol, baseline)
        trips = eng.stats()["resilience"]["watchdog_trips"] - trips
        print(f"    StallError after {eng.watchdog_steps} idle steps: "
              f"{states.get('stall', '')[:72]}...; trips {trips}")
        if trips != 1 or "no request advanced" not in states.get("stall", "") \
                or run["out"][1][1] != "length":
            raise AssertionError(f"{name} {family} watchdog: trips {trips}, "
                                 f"{states.get('stall')}, {run['out']}")
        if {id(t): t.data_ptr() for t in leaves(eng.caches)} != pools:
            raise AssertionError(f"{name} {family}: a KV pool was reallocated or "
                                 f"rebound")
        if san is not None:
            print(f"  {name} {family} sanitizer: {san.checks} model calls, "
                  f"{san.pages_checked} write pages, {san.cancels_checked} "
                  f"quarantines checked, no SanitizerError")
            res["sanitizer"] = {"checks": san.checks, "pages": san.pages_checked,
                                "quarantines": san.cancels_checked}
        out[family] = res
        del eng
        gc.collect()
    return out


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
    print(f"end to end, float32, sampled (seed 11, temperatures "
          f"{TEMPERATURES}): the same drains, card vs CPU plain path, each "
          f"family; a pick may differ only below a perturbed top-2 margin of "
          f"{F32_MARGIN:g}")
    f32_sampled = {fam: compare_f32(cfg, prompts, fam, greedy=False)
                   for fam in FAMILIES_F32}
    print(f"  picks below the margin: "
          f"{ {k: r['low_margin_picks'] for k, r in f32_sampled.items()} }, "
          f"requests parted: { {k: r['parted'] for k, r in f32_sampled.items()} }")

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
    engines = {fam: r.pop("engine") for fam, r in e2e.items()}
    by_path = {f: r["launches"] for f, r in e2e.items()}

    print(f"end to end, bfloat16, sampled (seed 3, temperatures "
          f"{TEMPERATURES}): the same 8 requests on the warmed engines, each "
          f"family; the families' picks may differ only below a perturbed "
          f"top-2 margin of {BF16_MARGIN:g} ({card})")
    reqs = [(p, 32, TEMPERATURES[i % 4]) for i, p in enumerate(prompts)]
    bf16_sampled = {fam: timed_drain(e, reqs, False, 3, f"bf16 {fam} sampled")
                    for fam, e in engines.items()}
    flat_picks = bf16_sampled["flat"].pop("picks")
    for fam in ("dense", "monolithic"):
        bf16_sampled[fam]["vs_flat"] = compare_picks(
            flat_picks, bf16_sampled[fam].pop("picks"), BF16_MARGIN,
            f"bf16 sampled {fam} vs flat")
        by_path[f"{fam} sampled"] = bf16_sampled[fam]["launches"]
    by_path["flat sampled"] = bf16_sampled["flat"]["launches"]

    print(f"two engines of one family over one model, both warmed (bf16, "
          f"the engines above; {card})")
    c1 = c1_two_engines(engines)
    del engines, eng
    print(f"prefix cache and speculation (spec_tokens=2), float32, full width, "
          f"each family: the spec trace (8 requests, 4-token motifs tiled to "
          f"16, 16-32 new) and the shared-prefix trace (12 requests, one "
          f"256-token system prompt, 2-6-token suffixes, 3-16 new, "
          f"staggered), greedy and sampled (seed 5); picks held to the "
          f"baseline's below a top-2 margin of {F32_MARGIN:g} ({card})")
    variants_f32 = serve_variants(cfg, TF, FAMILIES_BF16)
    print(f"the same in bfloat16, picks held to the baseline's below a top-2 "
          f"margin of {BF16_MARGIN:g} ({card})")
    variants_bf16 = serve_variants(cfg, BF, FAMILIES_BF16)
    for (fam, variant), r in variants_bf16.items():
        for key, run_ in r["runs"].items():
            by_path[f"{fam} {variant} {key}"] = run_["launches"]

    chaos = {}
    for dtype, what in ((TF, f"float32, survivors held to the clean drain's "
                             f"tokens exactly, the runtime sanitizer on"),
                        (BF, f"bfloat16, picks held to the clean drain's below "
                             f"a top-2 margin of {BF16_MARGIN:g}")):
        print(f"resilience under chaos, {what}: full width, max_slots=4, "
              f"page_tokens=16, queue_limit=6, each of {list(CHAOS_FAMILIES)}, "
              f"the plans of scripts/chaos_smoke.py, a lifecycle drain and a "
              f"watchdog trip ({card})")
        chaos[str(dtype)[6:]] = chaos_phase(cfg, dtype)
    for dt, fams in chaos.items():
        for fam, runs in fams.items():
            for key, r in runs.items():
                if "launches" in r:
                    by_path[f"chaos {dt} {fam} {key}"] = r["launches"]

    kernel_rows = []
    for k, cases in checks.cases.items():
        rep = next(c for c in cases if c["dtype"] == "bfloat16"
                   and c["shape"].startswith(REPRESENTATIVE[k]))
        src, replaces = SOURCES[k]
        kernel_rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "launches_per_step": launches[k] / steps,
            "launches_by_path": {f: n[k] for f, n in by_path.items()},
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
                       "f32_sampled": f32_sampled, "bf16_sampled": bf16_sampled,
                       "c1": c1,
                       "variants_f32": {str(k): v for k, v in variants_f32.items()},
                       "variants_bf16": {str(k): v for k, v in variants_bf16.items()},
                       "chaos": chaos,
                       "total_s": time.perf_counter() - t_start}, f, indent=1,
                      default=str)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
