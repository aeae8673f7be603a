"""Time the bfloat16 mmt4d kernel over decompositions (on the card).

For each SmolLM2-135M linear of the serving path (decode widths, the tied
head, the gate linear at every flat width) this launches the kernel with
``pick_split``'s pick and with every other valid (rows, tm, splits), L2-cold
(each call takes the next of enough operand copies to pass 64 MB), beside
``torch.matmul`` on the unpacked operands, and prints the pick, the fastest
few and the largest error against the float32 product.  It is how the picks
were chosen; the serving path never runs it.

With ``--grads`` it ranks ``pick_grad_split``'s split of the bfloat16
gradient kernel (``mmt4d_dgrad``, ``mmt4d_wgrad``) among every split count
instead, at the training linears of SmolLM2-135M (4,096 tokens; the gate
with its silu), L2-cold, beside ``torch.matmul`` of the same product.

    PYTHONPATH=src python -m repro_torch.kernels.mmt4d.sweep [--grads] [--out sweep.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import time

import torch

from repro_torch.core import packing
from repro_torch.core.hardware import query
from repro_torch.core.layout import make_layout
from repro_torch.kernels import build
from repro_torch.kernels.mmt4d.ops import (GRAD_TILE, MAX_CLUSTER, MAX_COLS, ROWS,
                                           _launch_gemm, gemm_operands, pick_grad_split,
                                           pick_split)

SHAPES = ([("gate decode", 16, 576, 1536), ("q/o decode", 16, 576, 576),
           ("k/v decode", 16, 576, 192), ("down decode", 16, 1536, 576),
           ("tied head", 4, 576, 49152)]
          + [(f"gate W={w}", w, 576, 1536) for w in (32, 64, 128, 256, 512)])
# (name, tokens, K, N, activation) of the training linears
GRAD_SHAPES = [("gate", 4096, 576, 1536, "silu"), ("up", 4096, 576, 1536, None),
               ("down", 4096, 1536, 576, None), ("q/o", 4096, 576, 576, None),
               ("k/v", 4096, 576, 192, None), ("tied head", 4096, 576, 49152, None)]


def time_ms(fn, iters: int = 30) -> float:
    """Device time per call of ``fn`` over ``iters`` calls queued behind a
    spin kernel (so the host's launch rate does not set the time)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(20.0, 4 * queue_ms) * 2e6))   # >= 1 ms at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters if held else float("nan")


def cold_cycle(fn, tensors):
    """A call of ``fn`` on the next of enough copies of ``tensors`` to pass
    64 MB, round robin."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    sets = [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(-(-64 * 2**20 // nbytes))]
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def launch(ap, bp, picks):
    m_o, k_o, m_r, k_r = ap.shape
    n_o, _, n_r, _ = bp.shape
    out = torch.empty((m_o, n_o, m_r, n_r), dtype=ap.dtype, device=ap.device)
    build.check(build.load_library().repro_mmt4d(
        ap.data_ptr(), bp.data_ptr(), None, out.data_ptr(),
        build.DTYPE_CODES[ap.dtype], 1, m_o, n_o, k_o, m_r, n_r, k_r, 0, *picks,
        build.stream_of(ap)), "mmt4d")
    return out


def sweep_grads(hw, card) -> list:
    """Every split count of each gradient product, L2-cold; prints the
    pick's rank and returns one row per (shape, product, split)."""
    lay = make_layout("scalable", hw, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    rows_all = []
    for name, m, k, n, act in GRAD_SHAPES:
        x, w, dy = rnd(m, k), rnd(k, n), rnd(m, n)
        ap, bp, dz = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay), packing.pack_out(dy, lay)
        z = packing.pack_out(rnd(m, n), lay) if act else dz
        dims = (ap.shape[0], bp.shape[0], ap.shape[1], lay.m_r, lay.n_r, lay.k_r)
        for kind in ("dgrad", "wgrad"):
            p, q, r = gemm_operands(kind, *dims)[:3]
            pick = pick_grad_split(p, q, r, hw.sm_count)

            def run(a, b, d, zz, _x, _w, _dy, s, kind=kind):
                return _launch_gemm(f"mmt4d_{kind}", kind, d, b if kind == "dgrad" else a,
                                    zz if act else None, dims, False, act, splits=s)[0]

            def library(_a, _b, _d, _z, xx, ww, dd, kind=kind):
                return torch.matmul(dd, ww.T) if kind == "dgrad" else torch.matmul(dd.T, xx)

            ops = (ap, bp, dz, z, x, w, dy)
            lib_ms = time_ms(cold_cycle(library, ops))
            res = []
            for s in range(1, min(MAX_CLUSTER, -(-r // GRAD_TILE[2])) + 1):
                ms = time_ms(cold_cycle(lambda *t, s=s: run(*t, s), ops))
                res.append({"shape": name, "kind": kind, "pqr": (p, q, r), "splits": s,
                            "ms": ms, "torch_matmul_ms": lib_ms, "is_pick": s == pick,
                            "card": card})
            ranked = sorted(res, key=lambda row: row["ms"])
            mine = next(row for row in res if row["is_pick"])
            print(f"{name} {kind} (P, Q, R) {(p, q, r)}: torch.matmul {lib_ms:.5f} ms; "
                  f"pick {pick} splits {mine['ms']:.5f} ms (rank {ranked.index(mine) + 1} "
                  f"of {len(res)}); by splits "
                  f"{[(row['splits'], round(row['ms'], 5)) for row in res]}")
            rows_all += res
    return rows_all


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser()
    ap_.add_argument("--out", default=None)
    ap_.add_argument("--grads", action="store_true",
                     help="rank the gradient kernel's split instead")
    args = ap_.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    hw = query("cuda")
    if args.grads:
        rows_all = sweep_grads(hw, card)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows_all, f, indent=1)
        return 0
    lay = make_layout("scalable", hw, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_all = []
    for name, m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        ap, bp = packing.pack_lhs(x, lay), packing.pack_rhs(w, lay)
        m_o, k_o = ap.shape[:2]
        n_o = bp.shape[0]
        want = torch.einsum("mkab,nkcb->mnac", ap.float(), bp.float())
        lib_ms = time_ms(cold_cycle(lambda _a, _b, xx, ww: torch.matmul(xx, ww),
                                    (ap, bp, x, w)))
        s = pick_split(m_o, n_o, k_o, lay.m_r, lay.n_r, lay.k_r, hw.sm_count)
        pick = (s.rows, s.tm, s.splits)
        cands = {pick} | {(r, tm, sp) for r in ROWS
                          for tm in range(1, min(m_o, MAX_COLS // lay.m_r) + 1)
                          for sp in range(1, min(MAX_CLUSTER, k_o) + 1)}
        res = []
        for c in sorted(cands):
            err = (launch(ap, bp, c).float() - want).abs().max().item()
            ms = time_ms(cold_cycle(lambda a, b, _x, _w, c=c: launch(a, b, c),
                                    (ap, bp, x, w)))
            res.append({"shape": name, "picks": c, "ms": ms, "err": err,
                        "torch_matmul_ms": lib_ms, "is_pick": c == pick, "card": card})
        res.sort(key=lambda r: r["ms"])
        mine = next(r for r in res if r["is_pick"])
        print(f"{name}: torch.matmul {lib_ms:.5f} ms; pick (rows, tm, splits) "
              f"{pick} {mine['ms']:.5f} ms (rank {res.index(mine) + 1} of {len(res)}); "
              f"max error {max(r['err'] for r in res):.3e}")
        for r in res[:4]:
            print(f"    {r['picks']} {r['ms']:.5f} ms")
        rows_all += res
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_all, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
