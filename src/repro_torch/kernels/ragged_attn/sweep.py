"""Time the ragged-attention kernel over split counts (on the card).

For the flat-step layouts of a serving path (``--heads``: SmolLM2-135M's
9 over 3 of 64 by default; Qwen3-8B's 32 over 8 of 128, ChatGLM3-6B's 32
over 2 of 128; pages of 16, MP = 64) this launches the kernel with
``pick_splits``'s split count and with every other count from 1 to
``MAX_CLUSTER``, L2-cold (each call takes the next of enough copies of q
and the pools to pass 64 MB), and prints the pick, its rank and the
fastest few, with the largest error against the plain version.  It is how
the rule was chosen; the serving path never runs it.  Beside them it
times the fixed-size plan a served step replays (``slots=4``: the width's
most tiles, the split count picked for them and MP), against the
per-step pick.

    PYTHONPATH=src python -m repro_torch.kernels.ragged_attn.sweep [--heads qwen3-8b] [--out sweep.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core.hardware import query
from repro_torch.kernels.mmt4d.sweep import cold_cycle, time_ms
from repro_torch.kernels.ragged_attn.ops import (MAX_CLUSTER, plan_ragged,
                                                 ragged_attention)
from repro_torch.kernels.ragged_attn.ref import ragged_attention_ref

# (name, width, [(row, first q_pos, length)]): decode steps and the mixed
# steps of chip_smoke.py's drain, plus full prefill chunks deep in a row
LAYOUTS = [
    ("decode rows", 16, [(0, 300, 1), (1, 511, 1), (2, 95, 1), (3, 1000, 1)]),
    ("long decode row", 16, [(0, 1000, 1)]),
    ("short decode rows", 16, [(0, 70, 1), (1, 90, 1), (2, 40, 1), (3, 120, 1)]),
    ("mid decode rows", 16, [(0, 300, 1), (1, 250, 1), (2, 330, 1), (3, 200, 1)]),
    ("decode and a short chunk", 32, [(0, 900, 1), (1, 700, 1), (2, 800, 1),
                                       (3, 40, 20)]),
    ("mixed prefill", 512, [(0, 600, 1), (1, 64, 1), (2, 0, 300), (3, 128, 206)]),
    ("prefill chunks", 512, [(r, 384 + 128 * r, 128) for r in range(4)]),
]


# (query heads, KV heads, d_head) of the served configs
HEADS = {"smollm2-135m": (9, 3, 64), "qwen3-8b": (32, 8, 128),
         "chatglm3-6b": (32, 2, 128)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", default="smollm2-135m", choices=sorted(HEADS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    hw = query("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hq, hkv, dh = HEADS[args.heads]
    t, mp, pages = 16, 64, 257
    print(f"heads {hq} over {hkv} of {dh} ({args.heads})")
    rows_all = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, width, segments in LAYOUTS:
            rng = np.random.default_rng(width)
            bt = (rng.permutation(pages - 1)[:4 * mp] + 1).astype(np.int32).reshape(4, mp)
            row_ids = np.full(width, -1, np.int32)
            q_pos = np.zeros(width, np.int32)
            pos = 0
            for row, first, n in segments:
                row_ids[pos:pos + n] = row
                q_pos[pos:pos + n] = first + np.arange(n)
                pos += n
            idx = dict(block_tables=torch.from_numpy(bt).cuda(),
                       row_ids=torch.from_numpy(row_ids).cuda(),
                       q_pos=torch.from_numpy(q_pos).cuda())
            q, kp, vp = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                         for s in ((width, hq, dh), (pages, t, hkv, dh),
                                   (pages, t, hkv, dh)))
            valid = torch.from_numpy(row_ids >= 0).cuda()
            want = ragged_attention_ref(q, kp, vp, **idx)[valid].float()
            pick = plan_ragged(row_ids, q_pos, t, mp, hkv, hw.sm_count,
                               group=hq // hkv).splits
            res = []
            for s in range(1, MAX_CLUSTER + 1):
                plan = plan_ragged(row_ids, q_pos, t, mp, hkv, hw.sm_count,
                                   group=hq // hkv, splits=s).to("cuda")
                got = ragged_attention(q, kp, vp, plan=plan, **idx)[valid].float()
                ms = time_ms(cold_cycle(
                    lambda a, b, c, plan=plan: ragged_attention(a, b, c, plan=plan, **idx),
                    (q, kp, vp)))
                res.append({"heads": args.heads, "layout": name,
                            "dtype": str(dtype)[6:], "splits": s,
                            "tiles": plan.tiles, "ms": ms,
                            "err": (got - want).abs().max().item(),
                            "is_pick": s == pick, "card": card})
            fixed = plan_ragged(row_ids, q_pos, t, mp, hkv, hw.sm_count,
                                group=hq // hkv, slots=4).to("cuda")
            got = ragged_attention(q, kp, vp, plan=fixed, **idx)[valid].float()
            fixed_ms = time_ms(cold_cycle(
                lambda a, b, c: ragged_attention(a, b, c, plan=fixed, **idx),
                (q, kp, vp)))
            res.sort(key=lambda r: r["ms"])
            mine = next(r for r in res if r["is_pick"])
            for r in res:
                r.update(fixed_ms=fixed_ms, fixed_splits=fixed.splits,
                         fixed_tiles=fixed.tiles,
                         fixed_err=(got - want).abs().max().item())
            print(f"{name} {str(dtype)[6:]} W={width}: pick {pick} split(s) "
                  f"{mine['ms']:.5f} ms (rank {res.index(mine) + 1} of {len(res)}); "
                  f"max error {max(r['err'] for r in res):.3e}; "
                  + ", ".join(f"{r['splits']}: {r['ms']:.5f}" for r in res))
            print(f"  fixed-size plan: {fixed.tiles} tiles x {fixed.splits} "
                  f"split(s) {fixed_ms:.5f} ms ({fixed_ms / mine['ms']:.3f}x the "
                  f"per-step pick), error {res[0]['fixed_err']:.3e}")
            rows_all += res
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows_all, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
